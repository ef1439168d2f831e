"""Seeded line drawings: the contour lines of a smooth random field.

``f(y, x) = sum_k a_k sin(2 pi (u_k x + v_k y) / N + phi_k)`` with integer
frequencies up to ``max_frequency`` cycles across the drawing; a pixel is
stroke where it lies within ``half_width`` px of one of the field's levels
``j * level_step`` (distance ~ |f - level| / |grad f|).  The result has
strokes of even width winding over the whole drawing, with open areas
between them, made on the device in a few vectorised calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def make_drawing(size: int, seed: int, index: int, params, device):
    """``[size, size]`` float32 numpy drawing, 1 = background, 0 = stroke."""
    rng = np.random.default_rng([int(seed), 23, int(index)])
    k = int(params["waves"])
    fmax = int(params["max_frequency"])
    uv = rng.integers(-fmax, fmax + 1, size=(k, 2)).astype(np.float64)
    uv[np.all(uv == 0, axis=1)] = 1.0
    amp = rng.uniform(0.5, 1.0, size=k)
    phase = rng.uniform(0.0, 2 * math.pi, size=k)
    t = torch.arange(size, device=device, dtype=torch.float32)
    out = torch.empty(size, size, dtype=torch.uint8, device=device)
    rows = 512
    for y0 in range(0, size, rows):
        yy = t[y0:y0 + rows, None]
        f = torch.zeros(yy.shape[0], size, device=device)
        gy = torch.zeros_like(f)
        gx = torch.zeros_like(f)
        for (u, v), a, ph in zip(uv, amp, phase):
            w = 2 * math.pi / size
            arg = w * (u * t[None, :] + v * yy) + ph
            f += a * torch.sin(arg)
            c = a * torch.cos(arg) * w
            gx += c * u
            gy += c * v
        step = float(params["level_step"])
        off = f / step
        dist = (off - torch.round(off)).abs() * step \
            / torch.sqrt(gx * gx + gy * gy).clamp_min(1e-6)
        out[y0:y0 + rows] = (dist > float(params["half_width"])).to(
            torch.uint8)
    return out.cpu().numpy().astype(np.float32)
