"""Seeded training data, written as the zips the training CLI reads.

Style images: ``size``-px RGB fields, each channel a sum of a few random
plane waves (integer frequencies up to ``max_frequency`` cycles across the
image) through a tanh, made on the device in batches.  Geometry items:
triband images in the layout ``train/dataset.py:geom_batch_to_float``
reads (R the input gray and G the conditioning binary, here both the
binary drawing; B the loss target, a Gaussian blur of it; white is
background), whose strokes are ``drawings.py:make_drawing``'s contour
lines, each drawing made on the device, blurred in batches.

Both are written as zips of PNGs (8-bit RGB, each row filtered with PNG's
'Sub' filter and deflated at level 1), with a PNG writer of the
benchmark's own, so that the program decodes what users' zips hold.  The
uint8 arrays stay with the benchmark: the check matches the rows the
program's data chain delivered against them.
"""

from __future__ import annotations

import math
import struct
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from neube_bench.traffic.drawings import make_drawing


def style_images(count: int, size: int, seed: int, params, device,
                 chunk: int = 256) -> np.ndarray:
    """``[count, size, size, 3]`` uint8 style images from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 7 + 3)
    k = int(params["waves"])
    fmax = int(params["max_frequency"])
    t = torch.arange(size, device=device, dtype=torch.float32) \
        * (2 * math.pi / size)
    out = np.empty((count, size, size, 3), np.uint8)
    for at in range(0, count, chunk):
        n = min(chunk, count - at)
        uv = torch.randint(-fmax, fmax + 1, (n, 3, k, 2), generator=gen,
                           device=device).float()
        amp = torch.rand((n, 3, k), generator=gen, device=device) + 0.5
        phase = torch.rand((n, 3, k), generator=gen, device=device) \
            * (2 * math.pi)
        arg = (uv[..., 0, None, None] * t[None, None, None, None, :]
               + uv[..., 1, None, None] * t[None, None, None, :, None]
               + phase[..., None, None])
        f = (amp[..., None, None] * torch.sin(arg)).sum(2) / math.sqrt(k)
        img = (127.5 + 127.5 * torch.tanh(f)).round().clamp(0, 255)
        out[at:at + n] = img.to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
    return out


def _blur(x, sigma: float):
    """Separable Gaussian blur of ``[N, 1, H, W]`` with edge padding."""
    rad = max(1, int(3 * sigma))
    xs = torch.arange(-rad, rad + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    k = k / k.sum()
    x = torch.nn.functional.pad(x, [rad, rad, rad, rad], mode="replicate")
    x = torch.nn.functional.conv2d(x, k[None, None, None, :])
    return torch.nn.functional.conv2d(x, k[None, None, :, None])


def geometry_items(count: int, size: int, seed: int, params, device,
                   chunk: int = 128) -> np.ndarray:
    """``[count, size, size, 3]`` uint8 triband items from ``seed``: the
    drawing in R and G, its Gaussian blur in B."""
    out = np.empty((count, size, size, 3), np.uint8)
    for at in range(0, count, chunk):
        n = min(chunk, count - at)
        binary = torch.from_numpy(np.stack([
            make_drawing(size, seed, i, params, device)
            for i in range(at, at + n)])).to(device)[:, None]
        tri = torch.cat([binary, binary,
                         _blur(binary, float(params["blur_sigma"]))], 1)
        u8 = (tri * 255).round().clamp(0, 255).to(torch.uint8)
        out[at:at + n] = u8.permute(0, 2, 3, 1).cpu().numpy()
    return out


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``img [H, W, 3]`` uint8: every row 'Sub'-
    filtered, deflated at level 1."""
    h, w, _ = img.shape
    rows = img.reshape(h, w * 3)
    sub = rows.copy()
    sub[:, 3:] = rows[:, 3:] - rows[:, :-3]          # wraps mod 256
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_zip(path: str, images: np.ndarray, workers: int = 8):
    """The images as ``img{index:08d}.png`` in a stored zip (the PNGs are
    deflated already); item ``i`` of the dataset is ``images[i]``."""
    with ThreadPoolExecutor(workers) as pool:
        blobs = list(pool.map(png_bytes, images))
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        for i, b in enumerate(blobs):
            z.writestr(f"img{i:08d}.png", b)
