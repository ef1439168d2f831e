"""Spline-based stroke geometry (numpy).

The port's copy of the numpy path of ``brushstroke_engine_tpu/data/curves.py``
(centripetal Catmull-Rom splines and an exact distance-field stroke
rasterizer), as far as the curated geometry needs it.  The JAX package's
ctypes rasterizer is not carried over.
"""

from __future__ import annotations

import numpy as np


def catmull_rom_spline(control_pts: np.ndarray, samples_per_segment: int = 20,
                       alpha: float = 0.5) -> np.ndarray:
    """Centripetal (alpha=0.5) Catmull-Rom interpolation through control points.

    Args:
      control_pts: ``[N, 2]`` float array, N >= 4 (endpoints act as tangent
        handles; the curve spans control_pts[1] .. control_pts[-2]).
      samples_per_segment: samples per inner segment.

    Returns:
      ``[M, 2]`` float array of points along the curve.
    """
    pts = np.asarray(control_pts, np.float64)
    assert pts.ndim == 2 and pts.shape[0] >= 4 and pts.shape[1] == 2

    def tj(ti, pi, pj):
        return ti + max(np.linalg.norm(pj - pi), 1e-8) ** alpha

    out = []
    for i in range(pts.shape[0] - 3):
        p0, p1, p2, p3 = pts[i], pts[i + 1], pts[i + 2], pts[i + 3]
        t0 = 0.0
        t1 = tj(t0, p0, p1)
        t2 = tj(t1, p1, p2)
        t3 = tj(t2, p2, p3)
        t = np.linspace(t1, t2, samples_per_segment, endpoint=False)[:, None]

        def lerp(pa, pb, ta, tb):
            denom = max(tb - ta, 1e-8)
            return (tb - t) / denom * pa + (t - ta) / denom * pb

        a1 = lerp(p0, p1, t0, t1)
        a2 = lerp(p1, p2, t1, t2)
        a3 = lerp(p2, p3, t2, t3)
        b1 = (t2 - t) / max(t2 - t0, 1e-8) * a1 + (t - t0) / max(t2 - t0, 1e-8) * a2
        b2 = (t3 - t) / max(t3 - t1, 1e-8) * a2 + (t - t1) / max(t3 - t1, 1e-8) * a3
        c = (t2 - t) / max(t2 - t1, 1e-8) * b1 + (t - t1) / max(t2 - t1, 1e-8) * b2
        out.append(c)
    out.append(pts[-2:-1])
    return np.concatenate(out, axis=0)


def _dist_to_segments(grid_yx: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Min distance from each grid point to the polyline through pts."""
    p = pts[:-1]                       # [S, 2]
    q = pts[1:]                        # [S, 2]
    d = q - p                          # [S, 2]
    len_sq = np.maximum(np.sum(d * d, axis=1), 1e-12)  # [S]
    # grid: [H*W, 1, 2]; segments broadcast on axis 1.
    g = grid_yx[:, None, :]
    t = np.clip(np.sum((g - p[None]) * d[None], axis=2) / len_sq[None], 0, 1)
    proj = p[None] + t[..., None] * d[None]
    dist = np.sqrt(np.sum((g - proj) ** 2, axis=2))
    return dist.min(axis=1)


def draw_stroke(width: int, pts: np.ndarray, radius: float,
                soft_edge: float = 1.0) -> np.ndarray:
    """Render a polyline as a black-on-white stroke image.

    Args:
      width: output image size (width x width).
      pts: ``[M, 2]`` (y, x) points in pixel coordinates.
      radius: stroke half-thickness in pixels.
      soft_edge: anti-aliasing falloff in pixels.

    Returns:
      ``[width, width]`` float32, 1.0 = background, 0.0 = stroke.
    """
    ys, xs = np.meshgrid(np.arange(width), np.arange(width), indexing="ij")
    grid = np.stack([ys.ravel(), xs.ravel()], axis=1).astype(np.float64)
    pts = np.asarray(pts, np.float64)
    if pts.shape[0] == 1:
        pts = np.concatenate([pts, pts + 1e-3], axis=0)
    # Chunk the segment set to bound memory for long curves.
    dist = np.full(grid.shape[0], np.inf)
    chunk = 256
    for s in range(0, pts.shape[0] - 1, chunk):
        seg = pts[s:s + chunk + 1]
        dist = np.minimum(dist, _dist_to_segments(grid, seg))
    img = np.clip((dist - radius) / max(soft_edge, 1e-6), 0.0, 1.0)
    return img.reshape(width, width).astype(np.float32)
