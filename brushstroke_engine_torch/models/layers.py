"""Equalized-learning-rate layers (StyleGAN2 style).

Counterpart of ``brushstroke_engine_tpu/models/layers.py``.  Params are plain
dicts of tensors keyed as in the JAX package; an FC weight is torch's
``[out, in]``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from brushstroke_engine_torch.ops import (
    activation_gain, bias_act, conv2d_resample,
)


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


def conv_layer_apply(params, x, *, activation: str = "linear", up: int = 1,
                     down: int = 1, resample_filter=None,
                     conv_clamp: float | None = None, gain: float = 1.0):
    """Equalized-LR conv layer (reference Conv2dLayer, networks.py:127):
    NHWC ``x``, OIHW weight."""
    _, in_ch, kh, kw = params["weight"].shape
    weight_gain = 1.0 / math.sqrt(in_ch * kh * kw)
    w = params["weight"] * weight_gain
    b = params.get("bias")
    x = conv2d_resample(x, w.to(x.dtype), f=resample_filter, up=up,
                        down=down, padding=kh // 2, flip_weight=(up == 1))
    act_gain = activation_gain(activation) * gain
    act_clamp = conv_clamp * gain if conv_clamp is not None else None
    return bias_act(x, None if b is None else b.to(x.dtype), dim=-1,
                    act=activation, gain=act_gain, clamp=act_clamp)
