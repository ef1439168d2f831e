"""Numpy image helpers of the training data pipeline and the stylize tool
(the port's copy of what it needs from
``brushstroke_engine_tpu/utils/img_proc.py``)."""

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


def threshold_otsu(gray: np.ndarray, nbins: int = 256) -> float:
    """Otsu's threshold for a [0,1] or [0,255] gray image."""
    g = np.asarray(gray, np.float64).ravel()
    lo, hi = float(g.min()), float(g.max())
    if hi <= lo:
        return lo
    hist, edges = np.histogram(g, bins=nbins, range=(lo, hi))
    hist = hist.astype(np.float64)
    centers = (edges[:-1] + edges[1:]) / 2
    w0 = np.cumsum(hist)
    w1 = w0[-1] - w0
    m0 = np.cumsum(hist * centers)
    mt = m0[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        mu0 = m0 / w0
        mu1 = (mt - m0) / w1
        between = w0 * w1 * (mu0 - mu1) ** 2
    between[~np.isfinite(between)] = -1
    return float(centers[int(np.argmax(between))])
