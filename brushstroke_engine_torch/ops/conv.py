"""Convolution with fused resampling, and style-modulated convolution.

Counterpart of ``brushstroke_engine_tpu/ops/conv.py``.  Activations are NHWC
at the public functions; weights are torch's OIHW.  The convs themselves are
cuDNN (``F.conv2d`` / ``F.conv_transpose2d``) on ``channels_last`` views.

``modulated_conv2d`` uses the activation-scaling form of the JAX package:
scale input channels by the style, run one shared conv, scale output channels
by the demodulation coefficient.  It also takes the layer's bias-act epilogue
(``bias``, ``activation``, ``act_gain``, ``clamp``), so that an up=2 layer
hands its pre-FIR tensor straight to the fused FIR-epilogue kernel
(:mod:`brushstroke_engine_torch.ops.fir_epilogue`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from brushstroke_engine_torch.ops.biasact import bias_act
from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
from brushstroke_engine_torch.ops.upfirdn import (
    _filter_2d, _parse_padding, nchw, nhwc, upfirdn2d,
)


def _dense_conv(x, w, stride: int = 1):
    """VALID conv of NHWC ``x`` with OIHW ``w``."""
    return nhwc(F.conv2d(nchw(x), w.to(x.dtype), stride=stride))


def _upsample_conv(x, w, up: int, pads):
    """Correlation of the zero-dilated ``x`` (``up-1`` zeros between pixels)
    padded by ``pads = (px0, px1, py0, py1)`` with OIHW ``w``.

    ``F.conv_transpose2d`` at stride ``up`` is the true convolution of the
    dilated input over a ``k-1`` border; flipping ``w`` turns it into the
    correlation, and the remaining border difference is zero-padded (or
    cropped) on the output.
    """
    kh, kw = int(w.shape[2]), int(w.shape[3])
    px0, px1, py0, py1 = pads
    wt = w.flip([2, 3]).transpose(0, 1).to(x.dtype)    # [I, O, kh, kw]
    y = F.conv_transpose2d(nchw(x), wt, stride=up)
    y = F.pad(y, [px0 - (kw - 1), px1 - (kw - 1), py0 - (kh - 1),
                  py1 - (kh - 1)])
    return nhwc(y)


def _resample_pads(f, up, down, padding):
    """Padding w.r.t. the upsampled image, widened for the FIR (reference
    conv2d_resample.py:97-107)."""
    fh, fw = _filter_2d(f).shape
    px0, px1, py0, py1 = _parse_padding(padding)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
    return px0, px1, py0, py1


def _prefir_up(x, w, f, up, padding, flip_weight):
    """The dense conv of the up path: returns the tensor the FIR filters."""
    px0, px1, py0, py1 = _resample_pads(f, up, 1, padding)
    if not flip_weight:
        w = w.flip([2, 3])
    # The dilated input keeps `up-1` trailing zeros per axis (reference
    # convention), folded into the high-side padding.
    return _upsample_conv(x, w, up, (px0, px1 + up - 1, py0, py1 + up - 1))


def conv2d_resample(x, w, f=None, up: int = 1, down: int = 1, padding=0,
                    flip_weight: bool = True, flip_filter: bool = False):
    """2D convolution with optional FIR-filtered up/downsampling.

    Padding is with respect to the (conceptually) upsampled image.

    Args:
      x: ``[N, H, W, I]``.
      w: ``[O, I, kh, kw]`` (OIHW).
      f: FIR filter from :func:`setup_filter` (used only when up>1 or down>1).
      flip_weight: True = correlation (torch conv2d convention), False = conv.
      flip_filter: False = convolution, True = correlation.
    """
    if up > 1:
        x = _prefir_up(x, w, f, up, padding, flip_weight)
        x = upfirdn2d(x, f, gain=up ** 2, flip_filter=flip_filter)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    px0, px1, py0, py1 = _resample_pads(f, up, down, padding)
    if not flip_weight:
        w = w.flip([2, 3])
    if down > 1:
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1],
                      flip_filter=flip_filter)
        return _dense_conv(x, w, stride=down)
    x = nhwc(F.pad(nchw(x), [px0, px1, py0, py1]))
    return _dense_conv(x, w)


# Negative-side slope of each activation the kernel's epilogue computes.
_FIR_ALPHA = {"linear": 1.0, "lrelu": 0.2, "relu": 0.0}


def modulated_conv2d(
    x,                       # [B, H, W, I] input.
    weight,                  # [O, I, kh, kw] conv weight.
    styles,                  # [B, I] per-sample modulation.
    noise=None,              # Optional [B or 1, H', W', 1] noise.
    up: int = 1,
    down: int = 1,
    padding=0,
    resample_filter=None,
    demodulate: bool = True,
    flip_weight: bool = True,
    bias=None,
    activation: str = "linear",
    act_gain: float = 1.0,
    clamp: Optional[float] = None,
):
    """Style-modulated conv2d, then ``bias_act(bias, activation, act_gain,
    clamp)``; with the epilogue arguments at their defaults it is exactly the
    JAX package's ``modulated_conv2d``.

    Every up-sampling conv runs its FIR, demodulation, noise, bias,
    activation and clamp as one :func:`fir4_epilogue` call; it must be up=2,
    down=1 with a 4x4 filter and a linear/relu/lrelu epilogue, and anything
    else raises.
    """
    b = x.shape[0]
    out_ch, in_ch, kh, kw = weight.shape
    assert styles.shape == (b, in_ch)

    w32 = weight.float()
    s32 = styles.float()

    # Low-precision guard (reference networks.py:51-53), bf16/fp16 only.
    if x.dtype in (torch.float16, torch.bfloat16) and demodulate:
        w_norm = w32.abs().amax(dim=(1, 2, 3), keepdim=True)     # [O,1,1,1]
        w32 = w32 / ((in_ch * kh * kw) ** 0.5 * w_norm)
        s32 = s32 / s32.abs().amax(dim=1, keepdim=True)

    dcoefs = None
    if demodulate:
        wsq = w32.square().sum(dim=(2, 3))                       # [O, I]
        dcoefs = torch.rsqrt(s32.square() @ wsq.t() + 1e-8)      # [B, O]

    x = x * s32[:, None, None, :].to(x.dtype)

    f = resample_filter
    if up > 1:
        if up != 2 or down != 1 or activation not in _FIR_ALPHA:
            raise NotImplementedError(
                f"modulated_conv2d: up-sampling runs through fir4_epilogue, "
                f"which takes up=2, down=1 and an activation in "
                f"{sorted(_FIR_ALPHA)}; got up={up}, down={down}, "
                f"activation={activation!r}")
        pre = _prefir_up(x, w32, f, up, padding, flip_weight)
        if dcoefs is None:
            dcoefs = torch.ones((b, out_ch), device=x.device)
        if bias is None:
            bias = torch.zeros((out_ch,), device=x.device)
        # .float() and .contiguous() return their tensor where it already
        # is f32 and contiguous; fir4_epilogue validates, and caches the
        # taps of `f` by content.
        return fir4_epilogue(
            pre.contiguous(), f, dcoefs.contiguous(),
            None if noise is None else noise.float().contiguous(),
            bias.float().contiguous(), act_gain, clamp,
            alpha=_FIR_ALPHA[activation], fir_gain=up ** 2,
            out_dtype=x.dtype)

    x = conv2d_resample(x, w32, f=f, up=up, down=down, padding=padding,
                        flip_weight=flip_weight)
    if dcoefs is not None:
        x = x * dcoefs[:, None, None, :].to(x.dtype)
    if noise is not None:
        x = x + noise.to(x.dtype)
    if bias is not None or activation != "linear" or act_gain != 1.0 \
            or clamp is not None:
        x = bias_act(x, None if bias is None else bias.to(x.dtype), dim=-1,
                     act=activation, gain=act_gain, clamp=clamp)
    return x
