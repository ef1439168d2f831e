"""Procedural curated geometry patches for evaluation and UVS mapping.

The port's copy of ``brushstroke_engine_tpu/data/curated_geometry.py``.

The reference bundles 30 curated spline patches
(forger/images/spline_patches_curated/{cross,curve,curve2,end,line,point}_
rad{001,003,009,016,025}.png) used by the StyleUVSMapper (5 medium + 5 thick
patches, forger/ui/mapper.py:29-44), brush icons, and visual diagnostics.
Rather than copying image assets, we generate the same canonical shapes
procedurally -- deterministic, resolution-independent, asset-free.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from brushstroke_engine_torch.data.curves import catmull_rom_spline, draw_stroke

CURATED_SHAPES = ("cross", "curve", "end", "line", "curve2", "point")
CURATED_RADII = (1, 3, 9, 16, 25)

# The 5 shapes used by the UVS mapper (reference mapper.py:33).
MAPPER_SHAPES = ("cross", "curve", "end", "line", "curve2")
MAPPER_MED_RADIUS = 16
MAPPER_THICK_RADIUS = 25


def _shape_points(shape: str, w: float):
    """Control polylines in a [0, 1] x [0, 1] unit square, scaled by w."""
    def curve_through(rel_pts):
        pts = np.asarray(rel_pts, np.float64) * w
        pad = np.concatenate([pts[:1] * 2 - pts[1:2], pts,
                              pts[-1:] * 2 - pts[-2:-1]], axis=0)
        return catmull_rom_spline(pad, samples_per_segment=32)

    if shape == "line":
        return [curve_through([(0.15, 0.2), (0.45, 0.45), (0.85, 0.75)])]
    if shape == "end":
        # Stroke that terminates mid-patch.
        return [curve_through([(0.1, 0.15), (0.35, 0.4), (0.55, 0.55)])]
    if shape == "curve":
        return [curve_through([(0.2, 0.15), (0.65, 0.3), (0.7, 0.7),
                               (0.35, 0.85)])]
    if shape == "curve2":
        # S-shaped curve.
        return [curve_through([(0.15, 0.2), (0.5, 0.35), (0.45, 0.65),
                               (0.8, 0.8)])]
    if shape == "cross":
        return [curve_through([(0.2, 0.2), (0.5, 0.5), (0.8, 0.8)]),
                curve_through([(0.2, 0.8), (0.5, 0.5), (0.8, 0.2)])]
    if shape == "point":
        return [np.asarray([(0.5, 0.5), (0.501, 0.501)]) * w]
    raise ValueError(f"unknown curated shape {shape!r}")


@lru_cache(maxsize=256)
def curated_geometry_patch(shape: str, radius: int, width: int = 128
                           ) -> np.ndarray:
    """Render one curated patch.

    Returns ``[width, width]`` float32, 1.0 = background, 0.0 = stroke --
    matching the reference's black-on-white geometry convention.  The radius
    argument uses the reference's pixel units at width=128 and scales with
    resolution.
    """
    scaled_radius = radius * width / 128.0
    img = np.ones((width, width), np.float32)
    for pts in _shape_points(shape, float(width)):
        img = np.minimum(img, draw_stroke(width, pts, scaled_radius))
    return img


def curated_geometry_batch(shapes=MAPPER_SHAPES, radius: int = 16,
                           width: int = 128) -> np.ndarray:
    """Stack of curated patches -> ``[N, width, width]`` float32."""
    return np.stack([curated_geometry_patch(s, radius, width)
                     for s in shapes])
