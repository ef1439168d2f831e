"""Procedural drawing-media style images.

The port's counterpart of ``scripts/make_synthetic_media.py``, with its
flags: synthesizes a stand-in for scanned drawing media -- strokes on paper
in five media families (marker, charcoal, ink, watercolor, crayon), each
with its palette and texture statistics -- deterministically from numpy's
``default_rng(seed * 1000003 + index)``, so its images equal the JAX
script's.  Written as PNG without Pillow (``utils/img_proc.py:write_png``),
which is what ``tools/project_main.py`` reads.

    python3 -m brushstroke_engine_torch.tools.make_synthetic_media \
        --output_dir media --num_images 8 --resolution 512 --seed 777
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from brushstroke_engine_torch.data.curves import (
    _gaussian_blur2d, catmull_rom_spline, draw_stroke, sample_radius,
)

FAMILIES = ("marker", "charcoal", "ink", "watercolor", "crayon")


def _rand_pigment(rng):
    """Medium-dark saturated pigment color, [3] float in [0,1]."""
    h = rng.uniform(0.0, 1.0)
    s = rng.uniform(0.55, 1.0)
    v = rng.uniform(0.25, 0.75)
    i = int(h * 6) % 6
    f = h * 6 - int(h * 6)
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    rgb = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
           (v, p, q)][i]
    return np.asarray(rgb, np.float32)


def _spline_pts(rng, width, n_control=5, margin=0.08):
    lo, hi = margin * width, (1 - margin) * width
    ctrl = rng.uniform(lo, hi, size=(n_control, 2))
    d = rng.normal(size=2)
    d /= np.linalg.norm(d) + 1e-8
    ctrl = ctrl[np.argsort(ctrl @ d)]
    ctrl = np.concatenate([ctrl[:1] * 2 - ctrl[1:2], ctrl,
                           ctrl[-1:] * 2 - ctrl[-2:-1]], axis=0)
    return catmull_rom_spline(ctrl, samples_per_segment=24)


def _noise(rng, width, sigma):
    n = rng.normal(size=(width, width)).astype(np.float32)
    if sigma > 0:
        n = _gaussian_blur2d(n, sigma)
        n /= n.std() + 1e-8
    return n


def _paper(rng, width):
    base = np.asarray([rng.uniform(0.90, 0.98), rng.uniform(0.89, 0.97),
                       rng.uniform(0.86, 0.96)], np.float32)
    img = np.ones((width, width, 3), np.float32) * base
    img += 0.015 * _noise(rng, width, 0)[..., None]
    img += 0.02 * _noise(rng, width, 6)[..., None]
    return np.clip(img, 0, 1)


def _stroke_alpha(rng, width, family):
    """Render one stroke's pigment coverage map [W,W] in [0,1] plus its
    pigment-color modulation field (None = flat)."""
    radius = sample_radius(rng, 2.0, 18.0)
    pts = _spline_pts(rng, width)
    # cov: 1 inside stroke. draw_stroke returns 1=BG.
    cov = 1.0 - draw_stroke(width, pts, radius, soft_edge=1.2)
    # Edge band: pixels near the boundary (pigment pooling).
    core = 1.0 - draw_stroke(width, pts, max(radius - 2.5, 0.5),
                             soft_edge=1.2)
    edge = np.clip(cov - core, 0, 1)

    mod = None
    if family == "marker":
        alpha = 0.72 * cov + 0.25 * edge
    elif family == "charcoal":
        grain = _noise(rng, width, 0.6)
        alpha = cov * np.clip(0.45 + 0.55 * (grain > -0.2), 0, 1)
        alpha = alpha * np.clip(0.55 + 0.45 * _noise(rng, width, 0), 0, 1)
        alpha += 0.18 * np.clip(_gaussian_blur2d(cov, 2.5) - cov, 0, 1)
    elif family == "ink":
        hard = 1.0 - draw_stroke(width, pts, radius, soft_edge=0.6)
        alpha = 0.95 * hard
        # Splatter: jittered dots near the curve.
        n_dots = rng.integers(0, 14)
        for _ in range(n_dots):
            c = pts[rng.integers(0, pts.shape[0])]
            c = c + rng.normal(0, radius * 2.2, 2)
            r = rng.uniform(0.6, 2.4)
            dot = 1.0 - draw_stroke(width, c[None], r, soft_edge=0.7)
            alpha = np.maximum(alpha, 0.9 * dot)
    elif family == "watercolor":
        wash = _gaussian_blur2d(cov, 2.5)
        ring = np.clip(wash - _gaussian_blur2d(cov, 5.0), 0, 1)
        mottle = np.clip(0.65 + 0.5 * _noise(rng, width, 4.0), 0, 1)
        alpha = (0.42 * wash + 0.55 * ring) * mottle
        mod = np.clip(0.5 + 0.5 * _noise(rng, width, 5.0), 0, 1)
    else:  # crayon
        bump = _noise(rng, width, 0.8)
        deposit = np.clip(0.35 + 0.9 * (bump > rng.uniform(-0.3, 0.2)),
                          0, 1)
        alpha = cov * deposit * np.clip(
            0.6 + 0.4 * _noise(rng, width, 0), 0, 1)
    return np.clip(alpha, 0, 1).astype(np.float32), mod


def render_media_patch(seed: int, width: int = 128) -> np.ndarray:
    """One style patch: paper + 1..3 strokes of a single media family."""
    rng = np.random.default_rng(seed)
    family = FAMILIES[int(rng.integers(0, len(FAMILIES)))]
    img = _paper(rng, width)
    c1, c2 = _rand_pigment(rng), _rand_pigment(rng)
    n_strokes = int(rng.integers(1, 4))
    for _ in range(n_strokes):
        alpha, mod = _stroke_alpha(rng, width, family)
        pigment = c1 if rng.uniform() < 0.7 else c2
        if mod is not None:  # watercolor: blend two pigments spatially
            pigment = (pigment[None, None] * mod[..., None]
                       + c2[None, None] * (1 - mod[..., None]))
        else:
            pigment = pigment[None, None]
        if family == "charcoal":
            pigment = pigment * 0.25  # near-black
        img = img * (1 - alpha[..., None]) + pigment * alpha[..., None]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--num_images", type=int, default=4000)
    ap.add_argument("--resolution", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from brushstroke_engine_torch.utils.img_proc import write_png

    os.makedirs(args.output_dir, exist_ok=True)
    paths = []
    for i in range(args.num_images):
        img = render_media_patch(args.seed * 1000003 + i, args.resolution)
        paths.append(os.path.join(args.output_dir, f"{i:05d}.png"))
        write_png(paths[-1], img)
        if (i + 1) % 500 == 0:
            print(f"{i + 1}/{args.num_images}")
    print(f"Wrote {args.num_images} media patches to {args.output_dir}")
    return paths


if __name__ == "__main__":
    main()
