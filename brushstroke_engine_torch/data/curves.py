"""Spline-based stroke geometry.

The port's copy of ``brushstroke_engine_tpu/data/curves.py``: centripetal
Catmull-Rom splines, the stroke rasterizer (the C++ library of
``native.py`` for two or more points, as the JAX package routes it, else an
exact numpy distance field), random spline strokes and the triband geometry
image of the training data.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from brushstroke_engine_torch import native


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
    if np.shape(pts)[0] >= 2:
        out = native.draw_stroke_native(width, np.asarray(pts, np.float32),
                                        float(radius), float(soft_edge))
        if out is not None:
            return out
    return draw_stroke_numpy(width, pts, radius, soft_edge)


def draw_stroke_numpy(width: int, pts: np.ndarray, radius: float,
                      soft_edge: float = 1.0) -> np.ndarray:
    """:func:`draw_stroke`'s numpy form (f64 distances, rounded once to
    f32): the fallback without the native library, and what draws
    one-point strokes."""
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


def sample_radius(rng: np.random.Generator, min_radius: float = 1.0,
                  max_radius: float = 26.0) -> float:
    """Stroke thickness distribution: log-uniform over the radius range
    (reference samples radii from empirical media distributions,
    forger/util/spline_dist.py; log-uniform covers the same 1..25 px span)."""
    return float(np.exp(rng.uniform(np.log(min_radius), np.log(max_radius))))


def random_spline_points(rng: np.random.Generator, width: int = 128,
                         n_control: int = 5,
                         margin: float = 0.1) -> np.ndarray:
    """Dense ``[M, 2]`` (y, x) points of a random centripetal Catmull-Rom
    curve across a ``width`` box."""
    lo, hi = margin * width, (1 - margin) * width
    ctrl = rng.uniform(lo, hi, size=(n_control, 2))
    # Sort control points roughly along a random direction so strokes sweep
    # across the patch instead of scribbling.
    direction = rng.normal(size=2)
    direction /= np.linalg.norm(direction) + 1e-8
    order = np.argsort(ctrl @ direction)
    ctrl = ctrl[order]
    # Pad endpoints for CR tangents.
    ctrl = np.concatenate([ctrl[:1] * 2 - ctrl[1:2], ctrl,
                           ctrl[-1:] * 2 - ctrl[-2:-1]], axis=0)
    return catmull_rom_spline(ctrl, samples_per_segment=24)


def random_spline_stroke(rng: np.random.Generator, width: int = 128,
                         n_control: int = 5,
                         radius: Optional[float] = None,
                         margin: float = 0.1) -> np.ndarray:
    """Random centripetal Catmull-Rom stroke patch (create_splines.py analog).

    Returns ``[width, width]`` float32, 1.0 = BG, 0.0 = stroke.
    """
    if radius is None:
        radius = sample_radius(rng)
    return draw_stroke(width, random_spline_points(rng, width, n_control,
                                                   margin), radius)


def draw_stroke_into(canvas: np.ndarray, pts: np.ndarray, radius: float,
                     soft_edge: float = 1.0) -> None:
    """Darken ``canvas`` (float32, 1.0 = background) in place with the
    stroke :func:`draw_stroke_numpy` draws along ``pts``.  Each segment is
    evaluated only within ``radius + soft_edge`` of itself: farther pixels
    are background for it, so the result equals ``draw_stroke_numpy``'s at
    a cost that grows with the stroke's length, not with the canvas."""
    h, w = canvas.shape
    reach = radius + soft_edge
    pts = np.asarray(pts, np.float64)
    if pts.shape[0] == 1:
        # One point is a dot, as in draw_stroke_numpy.
        pts = np.concatenate([pts, pts + 1e-3], axis=0)
    for p, q in zip(pts[:-1], pts[1:]):
        y0 = max(int(np.floor(min(p[0], q[0]) - reach)), 0)
        y1 = min(int(np.ceil(max(p[0], q[0]) + reach)) + 1, h)
        x0 = max(int(np.floor(min(p[1], q[1]) - reach)), 0)
        x1 = min(int(np.ceil(max(p[1], q[1]) + reach)) + 1, w)
        if y0 >= y1 or x0 >= x1:
            continue
        ys, xs = np.meshgrid(np.arange(y0, y1), np.arange(x0, x1),
                             indexing="ij")
        grid = np.stack([ys.ravel(), xs.ravel()], axis=1).astype(np.float64)
        dist = _dist_to_segments(grid, np.stack([p, q]))
        img = np.clip((dist - radius) / max(soft_edge, 1e-6), 0.0, 1.0)
        box = canvas[y0:y1, x0:x1]
        np.minimum(box, img.reshape(box.shape).astype(np.float32), out=box)


def line_drawing(size: int, n_strokes: int, seed: int = 0,
                 span: int = 256) -> np.ndarray:
    """A synthetic line drawing for the stylize tool: ``n_strokes`` random
    spline strokes of 2-8 px radius, each across a ``span``-wide box at a
    random place.  Returns ``[size, size]`` float32, 1.0 = background."""
    rng = np.random.default_rng(seed)
    canvas = np.ones((size, size), np.float32)
    span = min(span, size)
    for _ in range(n_strokes):
        offset = rng.integers(0, size - span + 1, size=2)
        radius = rng.uniform(2.0, 8.0)
        draw_stroke_into(canvas, random_spline_points(rng, span) + offset,
                         radius)
    return canvas


def triband_from_stroke(stroke: np.ndarray, blur_sigma: float = 2.0,
                        threshold: float = 0.5) -> np.ndarray:
    """Build a triband geometry image from a gray stroke.

    Channel semantics (reference scripts/prep_geom_data.py:43-60 and
    train.py:625-626): R = input gray, G = conditioning binary,
    B = loss-target (blurred binary); white = BG, black = FG.

    Returns ``[H, W, 3]`` float32 in [0, 1].
    """
    binary = (stroke > threshold).astype(np.float32)
    blurred = _gaussian_blur2d(binary, blur_sigma)
    return np.stack([stroke, binary, blurred], axis=-1)


def _gaussian_blur2d(img: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return img.astype(np.float32)
    rad = max(1, int(3 * sigma))
    xs = np.arange(-rad, rad + 1)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    pad = np.pad(img, ((rad, rad), (rad, rad)), mode="edge")
    tmp = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 1, pad)
    out = np.apply_along_axis(lambda c: np.convolve(c, k, "valid"), 0, tmp)
    return out.astype(np.float32)
