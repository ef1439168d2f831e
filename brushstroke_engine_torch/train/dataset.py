"""Training datasets: style images + triband geometry, zip or directory.

The port's copy of ``brushstroke_engine_tpu/train/dataset.py`` (which imports
no JAX): ImageFolderDataset with zip support, resize_mode 'crop'/'resize'
and a filename regexp filter, and the rank-sharded infinite index stream.

A plain numpy pipeline with a background prefetch thread feeding fixed-shape
NHWC uint8 batches.  Synthetic spline-stroke geometry can be generated on
the fly when no geometry dataset is provided (using data/curves.py), which
also powers the smoke run.
"""

from __future__ import annotations

import os
import queue
import re
import threading
import zipfile
from typing import Iterator, Optional, Tuple

import numpy as np

from brushstroke_engine_torch.data.curves import (
    random_spline_stroke, triband_from_stroke,
)
from brushstroke_engine_torch.utils.img_proc import read_image, \
    resize_bilinear

_IMG_EXT = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


class ImageFolderDataset:
    """Images from a directory tree or a zip archive.

    Args:
      path: directory or .zip of images.
      resolution: output square size.
      resize_mode: 'crop' (random crop after shortest-side check) or 'resize'.
      regexp: optional filename filter (reference dataset.py:208,254-257).
      xflip: double the dataset with mirrored copies.
      max_size: cap the dataset length.
      channels: 1, 3, or 4 output channels.
    """

    def __init__(self, path: str, resolution: int, resize_mode: str = "crop",
                 regexp: Optional[str] = None, xflip: bool = False,
                 max_size: Optional[int] = None, channels: int = 3,
                 seed: int = 0):
        self.path = path
        self.resolution = resolution
        self.resize_mode = resize_mode
        self.channels = channels
        self._zip = None
        self.rng = np.random.default_rng(seed)

        if path.endswith(".zip"):
            self._zip = zipfile.ZipFile(path)
            names = [n for n in self._zip.namelist()
                     if os.path.splitext(n)[1].lower() in _IMG_EXT]
        else:
            names = []
            for root, _dirs, files in os.walk(path):
                for f in files:
                    if os.path.splitext(f)[1].lower() in _IMG_EXT:
                        names.append(os.path.relpath(os.path.join(root, f),
                                                     path))
        names.sort()
        if regexp is not None:
            pat = re.compile(regexp)
            names = [n for n in names if pat.search(n)]
        if max_size is not None:
            names = names[:max_size]
        if len(names) == 0:
            raise ValueError(f"no images found in {path}")
        self.names = names
        self.xflip = xflip

    def __len__(self):
        return len(self.names) * (2 if self.xflip else 1)

    def _read(self, name: str) -> np.ndarray:
        """One image converted to the dataset's channels as Pillow's
        ``convert`` does (``utils.img_proc.read_image``: Pillow where it is
        installed, else its own PNG reader) -> uint8 ``[H, W, C]``."""
        src = self._zip.read(name) if self._zip is not None else \
            os.path.join(self.path, name)
        arr = read_image(src, {1: "L", 4: "RGBA"}.get(self.channels, "RGB"))
        return arr[..., None] if arr.ndim == 2 else arr

    def __getitem__(self, idx: int) -> np.ndarray:
        flip = self.xflip and idx >= len(self.names)
        name = self.names[idx % len(self.names)]
        arr = self._read(name)
        arr = self._to_resolution(arr)
        if flip:
            arr = arr[:, ::-1]
        return np.ascontiguousarray(arr)

    def _to_resolution(self, arr: np.ndarray) -> np.ndarray:
        h, w = arr.shape[:2]
        r = self.resolution
        if self.resize_mode == "resize" or min(h, w) < r:
            scale = r / min(h, w)
            arr = resize_bilinear(arr.astype(np.float32),
                                  max(r, int(round(h * scale))),
                                  max(r, int(round(w * scale))))
            arr = np.clip(arr, 0, 255).astype(np.uint8)
            h, w = arr.shape[:2]
        if h > r or w > r:
            y = self.rng.integers(0, h - r + 1)
            x = self.rng.integers(0, w - r + 1)
            arr = arr[y:y + r, x:x + r]
        return arr


class SyntheticGeometryDataset:
    """On-the-fly triband spline geometry (stands in for prepped zips)."""

    def __init__(self, resolution: int, size: int = 10000, seed: int = 0):
        self.resolution = resolution
        self.size = size
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1000003 + idx)
        stroke = random_spline_stroke(rng, self.resolution)
        tri = triband_from_stroke(stroke)
        return np.clip(tri * 255, 0, 255).astype(np.uint8)


class NoiseStyleDataset:
    """Uniform-noise style images from a seed: the stand-in the training
    script uses when no style data is given (smoke runs)."""

    def __init__(self, resolution: int, size: int = 1024, seed: int = 0):
        self.resolution = resolution
        self.size = size
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1000003 + idx)
        r = self.resolution
        return (rng.random((r, r, 3)) * 255).astype(np.uint8)


class CachedDataset:
    """Keeps every item of a small deterministic dataset after its first
    read (the numpy stroke rasterizer is slow; a smoke run cycles over a
    few dozen geometries)."""

    def __init__(self, dataset):
        self.dataset = dataset
        self._items = {}

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx: int) -> np.ndarray:
        if idx not in self._items:
            self._items[idx] = self.dataset[idx]
        return self._items[idx]


def infinite_indices(size: int, shuffle: bool = True, seed: int = 0,
                     rank: int = 0, num_ranks: int = 1,
                     window_ratio: float = 0.5) -> Iterator[int]:
    """Rank-sharded infinite shuffled index stream
    (reference misc.InfiniteSampler, torch_utils/misc.py:109-150)."""
    order = np.arange(size)
    rnd = np.random.RandomState(seed)
    window = 0
    if shuffle:
        rnd.shuffle(order)
        window = int(np.rint(order.size * window_ratio))
    idx = 0
    while True:
        i = idx % order.size
        if idx % num_ranks == rank:
            yield int(order[i])
        if window >= 2:
            j = (i - rnd.randint(window)) % order.size
            order[i], order[j] = order[j], order[i]
        idx += 1


class BatchIterator:
    """Infinite batched iterator with a background prefetch thread."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 rank: int = 0, num_ranks: int = 1, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self._indices = infinite_indices(len(dataset), seed=seed, rank=rank,
                                         num_ranks=num_ranks)
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            batch = np.stack([self.dataset[next(self._indices)]
                              for _ in range(self.batch_size)])
            self._queue.put(batch)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return self._queue.get()


def style_batch_to_float(batch_u8: np.ndarray) -> np.ndarray:
    """uint8 [B,H,W,3] -> float32 [-1, 1] (reference loop :379-380)."""
    return batch_u8.astype(np.float32) / 127.5 - 1.0


def geom_batch_to_float(batch_u8: np.ndarray) -> np.ndarray:
    """uint8 triband [B,H,W,3] -> float32 [0, 1]."""
    return batch_u8.astype(np.float32) / 255.0


def crop_geometry(tri: np.ndarray, resolution: int,
                  rng: np.random.Generator) -> Tuple[np.ndarray, Tuple]:
    """Random crop of the triband image to training resolution, returning the
    crop params so a second overlapping crop can be taken (Gstitch)."""
    h, w = tri.shape[1:3]
    y = int(rng.integers(0, h - resolution + 1))
    x = int(rng.integers(0, w - resolution + 1))
    return tri[:, y:y + resolution, x:x + resolution], \
        (y, x, resolution, resolution)
