"""Pad -> zero-upsample -> FIR filter -> downsample for NHWC images.

Counterpart of ``brushstroke_engine_tpu/ops/upfirdn.py`` in plain torch: the
FIR is a depthwise ``F.conv2d`` (``groups=C``) on an NCHW view of the NHWC
tensor, which is a ``channels_last`` tensor and needs no copy.

Layout: activations are NHWC at the public functions, filters ``[fh, fw]``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (``channels_last`` strides when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC."""
    return x.permute(0, 2, 3, 1).contiguous()


def _parse_scaling(scaling):
    if isinstance(scaling, int):
        return scaling, scaling
    sx, sy = scaling
    return int(sx), int(sy)


def _parse_padding(padding):
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = [int(p) for p in padding]
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    px0, px1, py0, py1 = padding
    return px0, px1, py0, py1


def _filter_2d(f) -> np.ndarray:
    """Normalize a filter argument to a 2D float32 array (no DC normalization)."""
    if f is None:
        return np.ones((1, 1), dtype=np.float32)
    if isinstance(f, torch.Tensor):
        f = f.detach().cpu().numpy()
    f = np.asarray(f, dtype=np.float32)
    if f.ndim == 1:
        f = np.outer(f, f)
    assert f.ndim == 2
    return f


def upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter: bool = False,
              gain: float = 1.0):
    """Pad, upsample, FIR-filter, and downsample a batch of NHWC images.

    Per channel: (1) insert ``up-1`` zeros after each pixel, (2) pad by
    ``padding`` zeros per side w.r.t. the upsampled image (negative = crop),
    (3) convolve with ``f`` keeping only fully-covered outputs, (4) keep every
    ``down``-th pixel.

    Args:
      x: ``[N, H, W, C]`` float tensor.
      f: FIR filter ``[fh, fw]``, separable taps ``[taps]``, or None.
      up / down: int or (x, y) int pair.
      padding: int, ``[x, y]``, or ``[x0, x1, y0, y1]`` w.r.t. upsampled image.
      flip_filter: False = convolution, True = correlation.
      gain: overall magnitude scaling.

    Returns:
      ``[N, H', W', C]`` tensor, same dtype as ``x``.
    """
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    f = _filter_2d(f)
    # F.conv2d correlates; flip for convolution.
    if not flip_filter:
        f = f[::-1, ::-1]
    f = np.ascontiguousarray(f * gain, np.float32)

    n, h, w, c = x.shape
    y = nchw(x)
    if upx > 1 or upy > 1:
        y = y.reshape(n, c, h, 1, w, 1)
        y = F.pad(y, [0, upx - 1, 0, 0, 0, upy - 1])
        y = y.reshape(n, c, h * upy, w * upx)
    y = F.pad(y, [px0, px1, py0, py1])
    weight = torch.as_tensor(f, dtype=x.dtype, device=x.device)
    weight = weight[None, None].expand(c, 1, *f.shape)
    y = F.conv2d(y, weight, groups=c)
    y = y[:, :, ::downy, ::downx]
    return nhwc(y)


def filter2d(x, f, padding=0, flip_filter=False, gain=1.0):
    """FIR-filter NHWC images; output shape matches input by default."""
    px0, px1, py0, py1 = _parse_padding(padding)
    fh, fw = _filter_2d(f).shape
    p = [px0 + fw // 2, px1 + (fw - 1) // 2, py0 + fh // 2, py1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1.0):
    """Upsample NHWC images with FIR smoothing; output = input * up."""
    upx, upy = _parse_scaling(up)
    px0, px1, py0, py1 = _parse_padding(padding)
    fh, fw = _filter_2d(f).shape
    p = [px0 + (fw + upx - 1) // 2, px1 + (fw - upx) // 2,
         py0 + (fh + upy - 1) // 2, py1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1.0):
    """Downsample NHWC images with FIR anti-aliasing; output = input / down."""
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    fh, fw = _filter_2d(f).shape
    p = [px0 + (fw - downx + 1) // 2, px1 + (fw - downx) // 2,
         py0 + (fh - downy + 1) // 2, py1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter,
                     gain=gain)
