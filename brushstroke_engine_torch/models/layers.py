"""Equalized-learning-rate layers (StyleGAN2 style).

Counterpart of ``brushstroke_engine_tpu/models/layers.py``.  Params are plain
dicts of tensors keyed as in the JAX package; an FC weight is torch's
``[out, in]``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from brushstroke_engine_torch.ops import bias_act


def normalize_2nd_moment(x, dim=-1, eps=1e-8):
    """x * rsqrt(mean(x^2) + eps)  (reference networks.py:24-26)."""
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


def fc_apply(params, x, activation: str = "linear", lr_multiplier: float = 1.0):
    """Equalized-LR linear layer: the stored weight is rescaled by
    ``lr_multiplier / sqrt(in)`` and the bias by ``lr_multiplier``."""
    in_features = params["weight"].shape[1]
    weight_gain = lr_multiplier / math.sqrt(in_features)
    w = params["weight"].to(x.dtype) * weight_gain
    b = params.get("bias")
    if b is not None and lr_multiplier != 1.0:
        b = b * lr_multiplier
    x = F.linear(x, w)
    return bias_act(x, None if b is None else b.to(x.dtype), dim=-1,
                    act=activation)
