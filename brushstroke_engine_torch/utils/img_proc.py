"""Numpy image helpers of the training data pipeline, the data-preparation
CLIs, the stylize tool, the visualizer and the projection CLI (the port's
copy of ``brushstroke_engine_tpu/utils/img_proc.py``: Otsu thresholding,
blur, entropy, the random patch sampler), and image files as Pillow reads and
writes them: :func:`read_image` / :func:`write_image` use Pillow where it is
installed and otherwise a PNG codec of their own (``zlib`` alone), which
converts as Pillow converts."""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import Optional, Tuple, Union

import numpy as np

from brushstroke_engine_torch.data.curves import _gaussian_blur2d


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


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable gaussian blur over the last two (or only) spatial dims."""
    if img.ndim == 2:
        return _gaussian_blur2d(img, sigma)
    return np.stack([_gaussian_blur2d(img[..., c], sigma)
                     for c in range(img.shape[-1])], axis=-1)


def patch_entropy(gray: np.ndarray, nbins: int = 64) -> float:
    """Shannon entropy of the intensity histogram (patch-filtering metric)."""
    hist, _ = np.histogram(np.asarray(gray).ravel(), bins=nbins, range=(0, 1))
    p = hist.astype(np.float64)
    p = p / max(p.sum(), 1)
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def alpha_to_gray(img: np.ndarray) -> np.ndarray:
    """RGBA uint8 -> float gray where alpha encodes the stroke (1 = BG)."""
    if img.ndim == 3 and img.shape[-1] == 4:
        return 1.0 - img[..., 3].astype(np.float32) / 255.0
    if img.ndim == 3:
        return img.astype(np.float32).mean(-1) / 255.0
    return img.astype(np.float32) / (255.0 if img.max() > 1.5 else 1.0)


class RandomPatchGenerator:
    """Random square patches at random scales from a large image."""

    def __init__(self, rng: np.random.Generator, patch_width: int,
                 scale_range: Tuple[float, float] = (1.0, 1.0)):
        self.rng = rng
        self.patch_width = patch_width
        self.scale_range = scale_range

    def sample(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        scale = self.rng.uniform(*self.scale_range)
        size = int(round(self.patch_width * scale))
        size = min(size, h, w)
        y = self.rng.integers(0, max(h - size, 0) + 1)
        x = self.rng.integers(0, max(w - size, 0) + 1)
        patch = img[y:y + size, x:x + size]
        if size != self.patch_width:
            patch = _resize_nearest(patch, self.patch_width)
        return patch

    def sample_fg_centered(self, img: np.ndarray, fg_mask: np.ndarray,
                           max_tries: int = 20) -> np.ndarray:
        """Prefer patches whose center region contains stroke pixels."""
        for _ in range(max_tries):
            patch = self.sample(img)
            c = self.patch_width // 2
            q = self.patch_width // 4
            center = patch[c - q:c + q, c - q:c + q]
            if np.asarray(center).min() < 0.5:
                return patch
        return patch


def _resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = (np.arange(size) * h / size).astype(np.int64).clip(0, h - 1)
    xs = (np.arange(size) * w / size).astype(np.int64).clip(0, w - 1)
    return img[ys][:, xs]


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}   # channels -> PNG color type


def png_bytes(img: np.ndarray) -> bytes:
    """A uint8 ``[H, W]`` or ``[H, W, C]`` (C = 1..4: gray, gray + alpha,
    RGB, RGBA) image as an 8-bit PNG, encoded with ``zlib`` alone (filter 0
    on every row)."""
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
    return (_PNG_SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write :func:`png_bytes` of ``img`` to ``path``, creating the parent
    directory."""
    data = png_bytes(img)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


# PNG color type -> samples per pixel; the bit depths the format allows.
_PNG_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
_NEEDS_PILLOW = "and Pillow is not installed"


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of ``h`` rows of ``stride`` bytes (``bpp``
    bytes per pixel, at least 1) -> uint8 ``[h, stride]``."""
    if raw.size != h * (1 + stride):
        raise ValueError(f"PNG data holds {raw.size} bytes, its header "
                         f"says {h * (1 + stride)}")
    raw = raw.reshape(h, 1 + stride)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            row = line
        elif f == 1:
            # Sub adds the reconstructed byte bpp to the left: a running
            # sum in each of the bpp byte lanes.
            row = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif f == 2:
            row = (line + prev) & 0xFF
        elif f in (3, 4):
            # Average and Paeth read the reconstructed pixel to the left,
            # so they run pixel by pixel (all bpp lanes at once).
            row = line.copy()
            lines, ups, rows = (v.reshape(-1, bpp) for v in (line, prev, row))
            a = np.zeros(bpp, np.int32)
            c = np.zeros(bpp, np.int32)
            for x in range(lines.shape[0]):
                b = ups[x]
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                a = (lines[x] + pred) & 0xFF
                rows[x] = a
                c = b
        else:
            raise ValueError(f"PNG row filter {f}")
        out[y] = row
        prev = row
    return out


def _png_decode(data: bytes):
    """A PNG's samples -> (``[H, W, C]`` uint8, or uint16 at depth 16, with
    depths 1-4 unpacked to their integer values; color type; depth;
    palette ``[256, 3]`` uint8 or None; the tRNS chunk or None)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header, plte, trns = 8, [], None, None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _PNG_SAMPLES or depth not in _PNG_DEPTHS[ctype]:
        raise ValueError(f"invalid PNG: depth {depth}, color type {ctype}")
    if interlace != 0:
        raise ValueError(f"an interlaced PNG is read only by Pillow, "
                         f"{_NEEDS_PILLOW}")
    if ctype == 3 and plte is None:
        raise ValueError("palette PNG without PLTE")
    c = _PNG_SAMPLES[ctype]
    stride = (w * c * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from e
    rows = _unfilter(np.frombuffer(raw, np.uint8), h, stride,
                     max(1, c * depth // 8))
    if depth == 16:
        samples = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        samples = rows
    else:
        bits = np.unpackbits(rows, axis=1)[:, :w * depth]
        weights = 1 << np.arange(depth - 1, -1, -1, dtype=np.uint8)
        samples = (bits.reshape(h, w, depth) * weights).sum(
            -1, dtype=np.uint8)
    samples = samples.reshape(h, w, c)
    palette = None
    if plte is not None and ctype == 3:
        palette = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte[:768], np.uint8)
        palette[:entries.size // 3] = entries[:entries.size // 3 * 3] \
            .reshape(-1, 3)
    return samples, ctype, depth, palette, trns


def _high_byte(a: np.ndarray) -> np.ndarray:
    return (a >> 8).astype(np.uint8) if a.dtype == np.uint16 else a


def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's 'RGB' -> 'L': ITU-R 601-2 luma in 16-bit fixed point."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _png_image(decoded, mode: Optional[str]) -> np.ndarray:
    """A decoded PNG (:func:`_png_decode`) as
    ``np.asarray(PIL.Image.open(...).convert(mode))`` gives it (``mode``
    None: as Pillow stores it)."""
    samples, ctype, depth, palette, trns = decoded
    # Pillow's stored image: its mode and array.
    gray = color = alpha = None
    if ctype == 0:
        g = samples[..., 0]
        if depth == 1:
            stored, gray = g.astype(bool), g * np.uint8(255)
        elif depth == 16:
            # Pillow's 'I;16' -> 'L' clips at 255; it keeps no high byte.
            stored, gray = g, np.minimum(g, 255).astype(np.uint8)
        else:
            stored = gray = g * np.uint8(255 // (2 ** depth - 1))
    elif ctype == 3:
        stored, color = samples[..., 0], palette[samples[..., 0]]
        if trns is not None:
            table = np.full(256, 255, np.uint8)
            table[:min(len(trns), 256)] = np.frombuffer(trns[:256], np.uint8)
            alpha = table[samples[..., 0]]
    elif ctype == 4:
        la = _high_byte(samples)
        gray, alpha = la[..., 0], la[..., 1]
        # Pillow opens 16-bit gray + alpha as 'RGBA'.
        stored = la if depth == 8 else np.stack([gray] * 3 + [alpha], -1)
    else:
        stored = _high_byte(samples)
        color = stored[..., :3]
        if ctype == 6:
            alpha = stored[..., 3]
    if trns is not None and ctype in (0, 2) and mode == "RGBA":
        if depth != 8:
            raise ValueError(f"a transparency key at depth {depth} is "
                             f"read only by Pillow, {_NEEDS_PILLOW}")
        key = np.frombuffer(trns[:2 * _PNG_SAMPLES[ctype]], ">u2")
        alpha = np.where((samples == key).all(-1), 0, 255).astype(np.uint8)
    if mode is None:
        return stored
    if mode == "L":
        return gray if gray is not None else _luma(color)
    if color is None:
        color = np.repeat(gray[..., None], 3, axis=-1)
    if mode == "RGB":
        return np.ascontiguousarray(color)
    if alpha is None:
        alpha = np.full(color.shape[:2], 255, np.uint8)
    return np.concatenate([color, alpha[..., None]], axis=-1)


def read_png(data: bytes) -> np.ndarray:
    """Decode a PNG with ``zlib`` alone -> uint8 ``[H, W, C]`` in the
    file's own layout, as Pillow converts it to 8 bits: gray (1-16 bits;
    Pillow clips 16-bit gray at 255), gray + alpha, RGB, RGBA (16-bit
    samples to their high byte), a palette image to RGB, or RGBA with its
    tRNS alphas.  Raises ``ValueError`` on an interlaced PNG and on
    anything that is no PNG."""
    decoded = _png_decode(data)
    ctype, trns = decoded[1], decoded[4]
    if ctype == 4:
        return _png_image(decoded, "RGBA")[..., [0, 3]]
    mode = "L" if ctype == 0 else "RGBA" if ctype == 6 or (
        ctype == 3 and trns is not None) else "RGB"
    img = _png_image(decoded, mode)
    return img[..., None] if img.ndim == 2 else img


def read_image(src: Union[str, bytes], mode: Optional[str] = "RGB"
               ) -> np.ndarray:
    """An image file as Pillow reads it:
    ``np.asarray(PIL.Image.open(src).convert(mode))``, or the image as
    Pillow stores it where ``mode`` is None.  ``src`` is a path or the
    file's bytes; ``mode`` is "RGB", "L", "RGBA" or None.

    Where Pillow is installed it reads.  Without it PNGs are decoded here
    and converted as Pillow converts: "RGB" repeats gray and drops alpha
    without compositing, "L" is Pillow's integer luma (R * 19595 +
    G * 38470 + B * 7471 + 0x8000) >> 16, palette PNGs go through their
    palette (and tRNS for "RGBA"), 16-bit samples as Pillow reduces them.
    Any other format, and an interlaced PNG, raises ``ValueError`` naming
    Pillow: nothing is read wrong in silence."""
    if mode not in (None, "RGB", "L", "RGBA"):
        raise ValueError(f"read_image mode {mode!r}: one of 'RGB', 'L', "
                         f"'RGBA' or None")
    try:
        import PIL.Image
    except ImportError:
        if isinstance(src, (bytes, bytearray)):
            data, name = bytes(src), "image bytes"
        else:
            with open(src, "rb") as f:
                data = f.read()
            name = src
        if data[:8] != _PNG_SIGNATURE:
            raise ValueError(f"{name}: not a PNG; other formats are read "
                             f"only by Pillow, {_NEEDS_PILLOW}") from None
        return _png_image(_png_decode(data), mode)
    with PIL.Image.open(io.BytesIO(src) if isinstance(src, (bytes, bytearray))
                        else src) as img:
        return np.asarray(img if mode is None else img.convert(mode))


def write_image(dest, img: np.ndarray) -> None:
    """Write a uint8 image as Pillow's ``Image.fromarray(img).save(dest)``
    writes it, where Pillow is installed; else :func:`write_png`.
    ``dest`` is a path (its extension names the format) or a binary file
    (written as PNG).  Without Pillow only PNG is written: another
    extension raises ``ValueError``."""
    img = np.ascontiguousarray(img)
    try:
        import PIL.Image
    except ImportError:
        if not isinstance(dest, str):
            dest.write(png_bytes(img))
            return
        if not dest.lower().endswith(".png"):
            raise ValueError(f"{dest}: only PNG is written without Pillow, "
                             f"and Pillow is not installed") from None
        write_png(dest, img)
        return
    if isinstance(dest, str):
        PIL.Image.fromarray(img).save(dest)
    else:
        PIL.Image.fromarray(img).save(dest, format="PNG")
