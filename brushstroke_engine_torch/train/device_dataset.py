"""Device-resident training data: decode once, sample on the card.

Counterpart of ``brushstroke_engine_tpu/train/device_dataset.py``.  The
style and triband geometry zips of a NeuBE run are small (a few thousand
pre-sized patches), so the whole dataset fits in device memory as uint8:
every image is decoded once at start-up into two banks, and the fused train
step (``train/fused.py``) samples each batch on the device -- an index draw
with ``torch.randint``, an ``index_select`` gather, the float conversion and
the training-resolution crop -- so the host decodes and copies nothing per
batch.

Semantics (as in the JAX package): the banks freeze one decode per image, so
the per-epoch re-crop of oversized source images is traded away unless the
zips hold pre-sized patches (the data-preparation CLIs' output); sampling is
i.i.d. with replacement instead of the host iterator's shuffled epochs.

Crop offsets are host ints.  On the TPU they are traced device values drawn
inside the step; here the stitcher and ``g_stitch_step`` take host-int crops
(``train/stitching.py``), and a device offset would need ``.item()`` -- a
host sync on every batch.  So :func:`gen_crops` draws both crops on the host
from the loop's seeded numpy stream, with the distribution of the JAX
``gen_crops``: two ints per batch, and the step stays free of syncs.

Under a mesh the banks are replicated on every rank's card (each rank
decodes the whole dataset), and the index draw is made at the global batch
from the seeded generator that every rank shares, each rank keeping its
rows: the ranks together sample the batch one process samples.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from brushstroke_engine_torch.parallel.distributed import draw_rows
from brushstroke_engine_torch.utils.util import resolve_device

# Refuse banks that would crowd out the model, the optimizer and the
# activations.
DEFAULT_MAX_BANK_BYTES = 6 << 30


@dataclass
class DeviceBanks:
    """Two uint8 image banks on the device."""
    style: torch.Tensor           # [Ns, r, r, 3] uint8
    tri: torch.Tensor             # [Ng, H, W, 3] uint8 triband
    tri_hw: Tuple[int, int]       # host-known (H, W) for the crop draws


def build_device_banks(style_ds, geom_ds, max_bytes: int =
                       DEFAULT_MAX_BANK_BYTES, log_fn=None, mesh=None,
                       device="cuda") -> DeviceBanks:
    """Decode every image of both datasets once and put uint8 banks on
    ``device`` (a group mesh's: the rank's card, each rank holding the whole
    banks; a local mesh's first device).

    ``style_ds`` / ``geom_ds``: len()-able datasets of uniform uint8 HWC
    images (``ImageFolderDataset`` or the synthetic ones).  Banks larger
    than ``max_bytes`` are refused.
    """
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    style = np.stack([style_ds[i] for i in range(len(style_ds))])
    tri = np.stack([geom_ds[i] for i in range(len(geom_ds))])
    if style.dtype != np.uint8 or tri.dtype != np.uint8:
        raise ValueError("device banks expect uint8 image datasets")
    nbytes = style.nbytes + tri.nbytes
    if nbytes > max_bytes:
        raise ValueError(
            f"dataset too large for device residency: {nbytes / 2**30:.2f} "
            f"GiB > {max_bytes / 2**30:.2f} GiB budget; train without "
            f"--device_dataset")
    if log_fn is not None:
        log_fn(f"device banks: {len(style)} style + {len(tri)} geometry "
               f"images, {nbytes / 2**20:.1f} MiB uint8 on {dev}")
    return DeviceBanks(style=torch.from_numpy(style).to(dev),
                       tri=torch.from_numpy(tri).to(dev),
                       tri_hw=(int(tri.shape[1]), int(tri.shape[2])))


def sample_banks(style_bank: torch.Tensor, tri_bank: torch.Tensor,
                 batch_size: int, generator: Optional[torch.Generator] = None,
                 draws=None):
    """One batch drawn on the banks' device: (style ``[B, r, r, 3]`` f32 in
    [-1, 1], tri ``[B, H, W, 3]`` f32 in [0, 1]), the conversions of
    ``train/dataset.py``.  Indices are i.i.d. uniform with replacement from
    ``generator``; ``draws = (style_idx, tri_idx)`` replaces them.  Under a
    data-parallel group ``batch_size`` is this rank's row count and the
    indices are drawn for the global batch (``draw_rows``)."""
    dev = style_bank.device
    if draws is None:
        idx_s = draw_rows(
            lambda s, **kw: torch.randint(0, style_bank.shape[0], s, **kw),
            (batch_size,), generator=generator, device=dev)
        idx_g = draw_rows(
            lambda s, **kw: torch.randint(0, tri_bank.shape[0], s, **kw),
            (batch_size,), generator=generator, device=dev)
    else:
        idx_s, idx_g = (
            d.to(dev, torch.long) if isinstance(d, torch.Tensor)
            else torch.from_numpy(np.array(d, np.int64)).to(dev)
            for d in draws)
    style = style_bank.index_select(0, idx_s).to(torch.float32) / 127.5 - 1.0
    tri = tri_bank.index_select(0, idx_g).to(torch.float32) / 255.0
    return style, tri


def gen_crops(rng: np.random.Generator, tri_hw: Tuple[int, int],
              resolution: int, stitching: bool, crop_margin: int = 10,
              min_overlap: int = 50):
    """The crop rectangles of one batch, as host ``(y, x, h, w)`` ints.

    crop1 is uniform over the training-resolution positions (the loop's
    ``rng.integers(0, H - res + 1)``).  When ``stitching``, crop2 is uniform
    within ``radius`` of crop1 and clamped to the image, guaranteeing
    ``min_overlap`` pixels of overlap after the ``crop_margin`` shrink --
    the algebra of the JAX ``gen_crops`` (and of
    ``engine.areas.gen_overlapping_square_crop``), inclusive ``rmax``.
    Returns (crop1, crop2); crop2 is None without stitching.
    """
    h, w = int(tri_hw[0]), int(tri_hw[1])
    res = int(resolution)
    y1 = int(rng.integers(0, max(h - res, 0) + 1))
    x1 = int(rng.integers(0, max(w - res, 0) + 1))
    crop1 = (y1, x1, res, res)
    if not stitching:
        return crop1, None
    lo, hi = crop2_range((y1, x1), (h, w), res, crop_margin, min_overlap)
    crop2 = (int(rng.integers(lo[0], hi[0] + 1)),
             int(rng.integers(lo[1], hi[1] + 1)), res, res)
    return crop1, crop2


def crop2_range(c, hw, res: int, crop_margin: int = 10,
                min_overlap: int = 50):
    """Per axis, the inclusive ``(rmin, rmax)`` that crop2's offset is
    drawn from, for crop1 at ``c = (y1, x1)`` in an image of ``hw``."""
    mo = min(min_overlap, res - crop_margin - 1)
    radius = max(res - crop_margin - mo - 1, 0)
    rmin = tuple(max(0, ci - radius) for ci in c)
    rmax = tuple(max(lo, min(ci + radius, lim - res - 1))
                 for ci, lo, lim in zip(c, rmin, hw))
    return rmin, rmax


def crop_tri(tri: torch.Tensor, crop, resolution: int):
    """The batch-uniform training-resolution crop of the triband batch at
    ``crop = (y, x, ...)``; returns (geom_input, geom_truth): channel 1
    (G, the conditioning input) and channel 2 (B, the loss target)."""
    y, x = int(crop[0]), int(crop[1])
    tile = tri[:, y:y + resolution, x:x + resolution]
    return tile[..., 1:2], tile[..., 2:3]
