"""Fused bias + activation + gain + clamp, in plain torch.

Counterpart of ``brushstroke_engine_tpu/ops/biasact.py`` (the JAX package
has no Pallas kernel for it, so neither does the port).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class _ActSpec(NamedTuple):
    fn: callable
    def_alpha: float
    def_gain: float


ACTIVATIONS = {
    "linear": _ActSpec(lambda x, a: x, 0.0, 1.0),
    "relu": _ActSpec(lambda x, a: F.relu(x), 0.0, math.sqrt(2.0)),
    "lrelu": _ActSpec(lambda x, a: torch.where(x >= 0, x, x * a), 0.2,
                      math.sqrt(2.0)),
    "tanh": _ActSpec(lambda x, a: torch.tanh(x), 0.0, 1.0),
    "sigmoid": _ActSpec(lambda x, a: torch.sigmoid(x), 0.0, 1.0),
    "elu": _ActSpec(lambda x, a: F.elu(x), 0.0, 1.0),
    "selu": _ActSpec(lambda x, a: F.selu(x), 0.0, 1.0),
    "softplus": _ActSpec(lambda x, a: F.softplus(x), 0.0, 1.0),
    "swish": _ActSpec(lambda x, a: torch.sigmoid(x) * x, 0.0, math.sqrt(2.0)),
}


def activation_gain(act: str) -> float:
    """Default output gain for an activation (sqrt(2) for relu family)."""
    return ACTIVATIONS[act].def_gain


def bias_act(x, b=None, dim: int = -1, act: str = "linear",
             alpha: Optional[float] = None, gain: Optional[float] = None,
             clamp: Optional[float] = None):
    """Add bias along ``dim``, apply ``act``, scale by ``gain``, clamp.

    Args:
      x: input of any shape (NHWC activations use dim=-1).
      b: 1D bias of length ``x.shape[dim]`` or None.
      dim: axis of ``x`` the bias lives on.
      act: one of :data:`ACTIVATIONS`.
      alpha: activation shape parameter (lrelu slope); None = default.
      gain: output scale; None = activation default (sqrt(2) for relu family).
      clamp: clamp output to [-clamp, clamp]; None = no clamping.
    """
    spec = ACTIVATIONS[act]
    alpha = float(spec.def_alpha if alpha is None else alpha)
    gain = float(spec.def_gain if gain is None else gain)

    if b is not None:
        assert b.ndim == 1
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape).to(x.dtype)
    x = spec.fn(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp is not None:
        assert clamp >= 0
        x = torch.clamp(x, -clamp, clamp)
    return x
