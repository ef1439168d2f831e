"""Host-side rectangle/crop algebra for the patch-tiled canvas.

The port's copy of ``brushstroke_engine_tpu/engine/areas.py`` (numpy only).
Areas are immutable named tuples of row/col start (inclusive) and end
(exclusive).  Crops are ``(row_start, col_start, rows, cols)`` tuples.  The
area bookkeeping decides which windows of the canvas a render reads and
writes; the device only sees patch-sized tensors and (y, x) offsets.
"""

from __future__ import annotations

import random
from typing import NamedTuple, Optional, Tuple

import numpy as np


class Area(NamedTuple):
    rstart: int
    cstart: int
    rend: int
    cend: int

    @property
    def rows(self) -> int:
        return self.rend - self.rstart

    @property
    def cols(self) -> int:
        return self.cend - self.cstart

    @property
    def min_width(self) -> int:
        """Smaller of the two extents; negative if degenerate (no overlap)."""
        return min(self.rows, self.cols)


def make_area(rstart: int, cstart: int, rows: int, cols: int) -> Area:
    return Area(rstart, cstart, rstart + rows, cstart + cols)


def make_area_direct(rstart, cstart, rend, cend) -> Area:
    return Area(rstart, cstart, rend, cend)


def position_delta(crop1, crop2) -> Tuple[int, int]:
    """(dy, dx) from crop1 to crop2."""
    return (crop2[0] - crop1[0], crop2[1] - crop1[1])


def compute_absolute_overlap(crop_a, crop_b) -> Area:
    return Area(
        max(crop_a[0], crop_b[0]),
        max(crop_a[1], crop_b[1]),
        min(crop_a[0] + crop_a[2], crop_b[0] + crop_b[2]),
        min(crop_a[1] + crop_a[3], crop_b[1] + crop_b[3]),
    )


def compute_overlaps(crop_a, crop_b):
    """Returns (absolute_overlap, overlap_rel_a, overlap_rel_b) or
    (absolute, None, None) when the crops do not overlap."""
    abs_ov = compute_absolute_overlap(crop_a, crop_b)
    if abs_ov.min_width <= 0:
        return abs_ov, None, None

    def rel(area: Area, crop) -> Area:
        return Area(area.rstart - crop[0], area.cstart - crop[1],
                    area.rend - crop[0], area.cend - crop[1])

    return abs_ov, rel(abs_ov, crop_a), rel(abs_ov, crop_b)


def offset_crop(crop, margin: int):
    return (crop[0] + margin, crop[1] + margin,
            crop[2] - 2 * margin, crop[3] - 2 * margin)


def offset_area(area: Area, margin: int) -> Area:
    return make_area(area.rstart + margin, area.cstart + margin,
                     area.rows - 2 * margin, area.cols - 2 * margin)


def pad_area_bounded(area: Area, margin: int, max_dim: int) -> Area:
    rmargin = min(margin, (max_dim - area.rows) // 2)
    cmargin = min(margin, (max_dim - area.cols) // 2)
    return Area(area.rstart - rmargin, area.cstart - cmargin,
                area.rend + rmargin, area.cend + cmargin)


def clip_area(area: Area, source_rows: int, source_cols: int) -> Area:
    return Area(
        max(0, min(area.rstart, source_rows - 1)),
        max(0, min(area.cstart, source_cols - 1)),
        max(0, min(area.rend, source_rows)),
        max(0, min(area.cend, source_cols)),
    )


def make_area_relative(area: Area, parent: Area) -> Area:
    rstart = max(area.rstart - parent.rstart, 0)
    cstart = max(area.cstart - parent.cstart, 0)
    rend = min(area.rend, parent.rend) - parent.rstart
    cend = min(area.cend, parent.cend) - parent.cstart
    return Area(rstart, cstart, rend, cend)


def expand_area(area: Area, to_width: int, source_rows: int,
                source_cols: int) -> Area:
    """Expand to exactly ``to_width`` square, centered, clamped to the canvas."""
    if area.rows == to_width and area.cols == to_width:
        return area

    def find_start(extra, start, max_val):
        if extra <= 0:
            return start
        new_start = max(0, start - extra // 2)
        if new_start + to_width > max_val:
            new_start = max_val - to_width
        return new_start

    return make_area(
        find_start(to_width - area.rows, area.rstart, source_rows),
        find_start(to_width - area.cols, area.cstart, source_cols),
        to_width, to_width)


def composite(im1, im2, area1: Area, area2: Area, alpha1=None):
    """Paste im2[area2] into im1[area1], optionally alpha-blending im1.

    Args:
      im1/im2: ``[B, H, W, C]`` numpy arrays.
      alpha1: ``[h, w]`` blend weight for im1 inside area1, or None.

    Returns a new array (numpy; host-side compositing for eval/stitch losses).
    """
    im1 = np.asarray(im1)
    im2 = np.asarray(im2)
    res = im1.copy()
    patch2 = im2[..., area2.rstart:area2.rend, area2.cstart:area2.cend, :]
    if alpha1 is None:
        res[..., area1.rstart:area1.rend, area1.cstart:area1.cend, :] = patch2
    else:
        a = np.asarray(alpha1)[..., None]
        old = res[..., area1.rstart:area1.rend, area1.cstart:area1.cend, :]
        res[..., area1.rstart:area1.rend, area1.cstart:area1.cend, :] = \
            a * old + (1 - a) * patch2
    return res


def gen_overlapping_square_crop(input_width: int, crop1, margin: int,
                                min_overlap: int,
                                rng: Optional[random.Random] = None):
    """Random square crop overlapping crop1 by at least min_overlap
    (reference CropHelper.gen_overlapping_square_crop)."""
    rng = rng or random
    width = crop1[2]
    # At widths below min_overlap + margin the guarantee degenerates to
    # "as much overlap as fits" (small-resolution / smoke-test configs).
    min_overlap = min(min_overlap, width - margin - 1)
    radius = max(width - margin - min_overlap - 1, 0)
    ij = [0, 0]
    for x in range(2):
        rmin = max(0, crop1[x] - radius)
        rmax = max(rmin, min(crop1[x] + radius, input_width - width - 1))
        ij[x] = rng.randint(rmin, rmax)
    return ij[0], ij[1], width, width
