"""Numpy image helpers of the training data pipeline, the stylize tool and
the visualizer (the port's copy of what it needs from
``brushstroke_engine_tpu/utils/img_proc.py``, and a PNG writer and reader
that need no Pillow)."""

from __future__ import annotations

import os
import struct
import zlib

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


_PNG_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}   # channels -> PNG color type


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 ``[H, W]`` or ``[H, W, C]`` (C = 1..4: gray, gray +
    alpha, RGB, RGBA) image as an 8-bit PNG with ``zlib`` alone (filter 0
    on every row).  Creates the parent directory."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _PNG_COLOR_TYPE:
        raise ValueError(f"write_png takes [H, W] or [H, W, 1..4], got "
                         f"{a.shape}")
    h, w, c = a.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(a).reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


_PNG_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}      # PNG color type -> channels


def read_png(data: bytes) -> np.ndarray:
    """Decode an 8-bit, non-interlaced gray, gray + alpha, RGB or RGBA PNG
    (every row filter) with ``zlib`` alone -> uint8 ``[H, W, C]``.  Raises
    ``ValueError`` on any other PNG."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _PNG_CHANNELS:
        raise ValueError(f"unsupported PNG: depth {depth}, color type "
                         f"{ctype}, interlace {interlace}")
    c = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.int32)
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            row = line
        elif f == 2:
            row = (line + prev) & 0xFF
        else:
            # Sub, Average and Paeth read the reconstructed pixel to the
            # left, so they run pixel by pixel.
            row = np.zeros_like(line)
            for x in range(w * c):
                a = row[x - c] if x >= c else 0
                b = prev[x]
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) >> 1
                elif f == 4:
                    cc = prev[x - c] if x >= c else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else cc)
                else:
                    raise ValueError(f"PNG row filter {f}")
                row[x] = (line[x] + pred) & 0xFF
        out[y] = row
        prev = row
    return out.astype(np.uint8).reshape(h, w, c)
