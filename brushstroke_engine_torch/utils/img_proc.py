"""Numpy image helpers of the training data pipeline (the port's copy of
what it needs from ``brushstroke_engine_tpu/utils/img_proc.py``)."""

from __future__ import annotations

import numpy as np


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel bilinear resize for numpy images ([H,W] or [H,W,C])."""
    h, w = img.shape[:2]
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]

    def axis_weights(n_in, n_out):
        pos = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
        lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 1)
        hi = np.clip(lo + 1, 0, n_in - 1)
        frac = np.clip(pos - lo, 0, 1)
        return lo, hi, frac.astype(np.float32)

    ylo, yhi, yf = axis_weights(h, out_h)
    xlo, xhi, xf = axis_weights(w, out_w)
    top = img[ylo][:, xlo] * (1 - xf)[None, :, None] \
        + img[ylo][:, xhi] * xf[None, :, None]
    bot = img[yhi][:, xlo] * (1 - xf)[None, :, None] \
        + img[yhi][:, xhi] * xf[None, :, None]
    out = top * (1 - yf)[:, None, None] + bot * yf[:, None, None]
    return out[..., 0] if squeeze else out
