"""Plain reference of the ADA 'bgc' augmentation (pixel blitting, general
geometric transforms, color transforms) for NHWC image batches.

Written from the JAX package's ``train/augment.py`` (read, not imported),
which follows StyleGAN2-ADA's ``augment.py`` (Karras et al. 2020) with two
departures noted where they fall: the blit and geometric transforms are
composed into one affine applied by a separable two-pass warp, with no
padding, up-sampling or FIR of StyleGAN2-ADA's geometric pipeline; and
the warp reflects at the border (reflect-101).

Every random number is an input: ``draws`` maps each name of
:func:`draw_spec` to a tensor, uniform in [0, 1) or unit normal, which the
benchmark makes and hands to the program and to this reference alike.
``skip_warp`` leaves the blit and geometric transforms out (a control).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

# (name, kind, shape per row) of the 'bgc' pipe's draws.
_BLIT_GEOM_COLOR = [
    ("xflip", "uniform", ()), ("rotate90", "uniform", ()),
    ("xint", "uniform", (2,)), ("scale", "normal", ()),
    ("rotate_pre", "uniform", ()), ("aniso", "normal", ()),
    ("rotate_post", "uniform", ()), ("xfrac", "normal", (2,)),
    ("brightness", "normal", ()), ("contrast", "normal", ()),
    ("lumaflip", "uniform", ()), ("hue", "uniform", ()),
    ("saturation", "normal", ()),
]
_APPLY_SHAPE = {"xint": (1,), "xfrac": (1,)}

# The strength multipliers and spreads of StyleGAN2-ADA's 'bgc' preset.
XINT_MAX, SCALE_STD, ROTATE_MAX, ANISO_STD, XFRAC_STD = \
    0.125, 0.2, 1.0, 0.2, 0.125
BRIGHTNESS_STD, CONTRAST_STD, HUE_MAX, SATURATION_STD = 0.2, 0.5, 1.0, 1.0


def draw_spec(batch: int):
    """[(name, kind, shape)] of one pipe call's draws."""
    spec = []
    for name, kind, shp in _BLIT_GEOM_COLOR:
        spec.append((name, kind, (batch,) + shp))
        spec.append((name + "_apply", "uniform",
                     (batch,) + _APPLY_SHAPE.get(name, ())))
    return spec


def make_draws(gen: torch.Generator, batch: int, device) -> Dict:
    """One pipe call's draws from ``gen``."""
    fns = {"uniform": torch.rand, "normal": torch.randn}
    return {name: fns[kind](shp, generator=gen, device=device)
            for name, kind, shp in draw_spec(batch)}


def _mat(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rot(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return _mat([[c, -s, z], [s, c, z], [z, z, o]])


def _scale(sx, sy):
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return _mat([[sx, z, z], [z, sy, z], [z, z, o]])


def _translate(tx, ty):
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return _mat([[o, z, tx], [z, o, ty], [z, z, o]])


def geometric_matrix(d: Dict, b: int, h: int, w: int, p):
    """The blit and geometric transforms composed into one affine
    ``[B, 3, 3]`` from output to input pixel coordinates (centred), as
    StyleGAN2-ADA builds its ``G_inv``: each transform applies to a row
    where its ``_apply`` draw lies under ``p`` (the rotations under the
    probability that makes pre OR post rotation ``p``)."""
    dev = p.device

    def on(name, prob):
        return (d[name + "_apply"] < prob).float()

    g = torch.eye(3, device=dev).repeat(b, 1, 1)
    ones = torch.ones(b, device=dev)
    i = torch.round(d["xflip"]) * on("xflip", p)
    g = _scale(1 - 2 * i, ones) @ g
    i = torch.floor(d["rotate90"] * 4) * on("rotate90", p)
    g = _rot(-math.pi / 2 * i) @ g
    t = (d["xint"] * 2 - 1) * XINT_MAX * on("xint", p)
    g = _translate(torch.round(t[:, 0] * w), torch.round(t[:, 1] * h)) @ g
    s = torch.where(on("scale", p) > 0, torch.exp2(d["scale"] * SCALE_STD),
                    ones)
    g = _scale(s, s) @ g
    p_rot = 1 - torch.sqrt(torch.clamp(1 - p, 0, 1))
    theta = (d["rotate_pre"] * 2 - 1) * math.pi * ROTATE_MAX \
        * on("rotate_pre", p_rot)
    g = _rot(-theta) @ g
    s = torch.where(on("aniso", p) > 0, torch.exp2(d["aniso"] * ANISO_STD),
                    ones)
    g = _scale(s, 1 / s) @ g
    theta = (d["rotate_post"] * 2 - 1) * math.pi * ROTATE_MAX \
        * on("rotate_post", p_rot)
    g = _rot(-theta) @ g
    t = d["xfrac"] * XFRAC_STD * on("xfrac", p)
    g = _translate(t[:, 0] * w, t[:, 1] * h) @ g
    return g


def _reflect(v, n: int):
    period = 2.0 * (n - 1)
    v = torch.remainder(v, period)
    return torch.where(v > (n - 1), period - v, v)


def _triangle(n: int, pos, half_width):
    """Rows of a 1-D resampling matrix ``[..., n]``: a triangle of
    ``half_width`` centred at ``pos``, normalised to unit mass."""
    taps = torch.arange(n, dtype=torch.float32, device=pos.device)
    w = torch.clamp_min(1.0 - (taps - pos[..., None]).abs()
                        / half_width[..., None], 0.0)
    return w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-8)


def warp(images, inv):
    """Bilinear-with-antialias resampling of square ``images [B, N, N, C]``
    by the inverse affines ``inv [B, 3, 3]`` as two 1-D passes
    (Catmull-Smith).  A transform closer to a quarter turn than to the
    identity has the quarter turn applied to its image first, so the
    vertical pass keeps a scale away from zero; each pass's triangle widens
    to its minification.  Departure from StyleGAN2-ADA, whose geometric
    pipeline up-samples, pads and filters instead."""
    b, n, _, c = images.shape
    ctr = (n - 1) / 2.0
    m = inv.float()
    turn = m[:, 0, 1].abs() > m[:, 1, 1].abs()
    quarter = torch.tensor([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0],
                            [0.0, 0.0, 1.0]], device=m.device)
    m = torch.where(turn[:, None, None], quarter @ m, m)
    imgs = torch.where(turn[:, None, None, None],
                       images.transpose(1, 2).flip(1), images)
    a, bb, cc = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    e = torch.where(e.abs() < 1e-6, torch.where(e < 0, -1e-6, 1e-6), e)
    # Pass 1 samples input row r at column u = B1 r + A1 j + c1; pass 2
    # samples the intermediate's column j at row v = E2 i + D2 j + c2.
    a1 = a - bb * d / e
    b1 = bb / e
    c1 = (cc - bb * f / e) + ctr - (a1 + b1) * ctr
    c2 = f + ctr - (d + e) * ctr
    s1 = torch.clamp_min(a1.abs(), 1.0)
    s2 = torch.clamp_min(e.abs(), 1.0)
    grid = torch.arange(n, dtype=torch.float32, device=images.device)
    r, j = grid[None, :, None], grid[None, None, :]

    def col(t):
        return t[:, None, None]

    w1 = _triangle(n, _reflect(col(b1) * r + col(a1) * j + col(c1), n),
                   col(s1).expand(-1, n, n))
    w2 = _triangle(n, _reflect(col(e) * r + col(d) * j + col(c2), n),
                   col(s2).expand(-1, n, n))
    mid = torch.einsum("brjk,brkc->brjc", w1, imgs.float())
    return torch.einsum("bijr,brjc->bijc", w2, mid)


def _color_matrix(d: Dict, b: int, p):
    dev = p.device
    eye = torch.eye(4, device=dev)
    ones = torch.ones(b, device=dev)
    v = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev) / math.sqrt(3)

    def on(name):
        return (d[name + "_apply"] < p).float()

    c = eye.repeat(b, 1, 1)
    m = eye.repeat(b, 1, 1)
    m[:, :3, 3] = (d["brightness"] * BRIGHTNESS_STD * on("brightness"))[:,
                                                                          None]
    c = m @ c
    s = torch.where(on("contrast") > 0,
                    torch.exp2(d["contrast"] * CONTRAST_STD), ones)
    c = torch.diag_embed(torch.stack([s, s, s, ones], 1)) @ c
    i = torch.round(d["lumaflip"]) * on("lumaflip")
    house = eye - 2 * torch.outer(v, v)
    c = torch.where(i[:, None, None] > 0, house[None], eye[None]) @ c
    theta = (d["hue"] * 2 - 1) * math.pi * HUE_MAX * on("hue")
    x, y, z = v[0], v[1], v[2]
    co, si = torch.cos(theta), torch.sin(theta)
    k = 1 - co
    rot = eye.repeat(b, 1, 1)
    rot[:, :3, :3] = _mat([
        [co + x * x * k, x * y * k - z * si, x * z * k + y * si],
        [y * x * k + z * si, co + y * y * k, y * z * k - x * si],
        [z * x * k - y * si, z * y * k + x * si, co + z * z * k]])
    c = rot @ c
    s = torch.where(on("saturation") > 0,
                    torch.exp2(d["saturation"] * SATURATION_STD), ones)
    vv = torch.outer(v, v)
    c = (vv[None] + (eye[None] - vv[None]) * s[:, None, None]) @ c
    return c


def augment(draws: Dict, images, p, skip_warp: bool = False):
    """The 'bgc' pipe on ``images [B, H, W, 3]`` (float32, about [-1, 1])
    at probability ``p`` (a 0-d tensor)."""
    b, h, w, _ = images.shape
    p = torch.as_tensor(p, dtype=torch.float32, device=images.device)
    if not skip_warp:
        g = geometric_matrix(draws, b, h, w, p)
        images = warp(images, torch.linalg.inv(g))
    c = _color_matrix(draws, b, p)
    flat = images.reshape(b, -1, 3)
    flat = torch.einsum("bij,bnj->bni", c[:, :3, :3], flat) \
        + c[:, None, :3, 3]
    return flat.reshape(b, h, w, 3)
