"""Adaptive discriminator augmentation (ADA) pipeline.

Counterpart of ``brushstroke_engine_tpu/train/augment.py`` for NHWC batches:
pixel blitting, general geometric transforms (composed into one inverse
affine and applied with the two-pass warp), color transforms, the 4-band
image filter, additive noise and cutout, with the same formulas.

Random draws are explicit.  JAX's PRNG and torch's generators give different
numbers, so the pipeline is split in two: :func:`draw_augment` makes the raw
uniform and normal draws (one named entry per draw of the JAX function, in
its order, see :func:`draw_spec`), and :func:`augment_pipe` builds the
transforms from them.  The overall probability ``p`` is a 0-d tensor on the
images' device and is never read back to the host.

On a CUDA tensor the geometric warp of square images always runs through the
hand-written kernel (``ops/warp.py``); :func:`_affine_warp_twopass` is its
plain version.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from brushstroke_engine_torch.ops.warp import (
    affine_warp_twopass, warp_twopass_plain,
)
from brushstroke_engine_torch.parallel.distributed import draw_rows


@dataclass(frozen=True)
class AugmentConfig:
    xflip: float = 0.0
    rotate90: float = 0.0
    xint: float = 0.0
    xint_max: float = 0.125
    scale: float = 0.0
    rotate: float = 0.0
    aniso: float = 0.0
    xfrac: float = 0.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    brightness: float = 0.0
    contrast: float = 0.0
    lumaflip: float = 0.0
    hue: float = 0.0
    saturation: float = 0.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    imgfilter: float = 0.0
    imgfilter_std: float = 1.0
    noise: float = 0.0
    cutout: float = 0.0
    noise_std: float = 0.1
    cutout_size: float = 0.5

    @staticmethod
    def from_spec(name: str) -> "AugmentConfig":
        """The reference augpipe presets (train.py:446-457)."""
        blit = ("xflip", "rotate90", "xint")
        geom = ("scale", "rotate", "aniso", "xfrac")
        color = ("brightness", "contrast", "lumaflip", "hue", "saturation")
        bgc = blit + geom + color
        specs = {
            "blit": blit, "geom": geom, "color": color,
            "noise": ("noise",), "cutout": ("cutout",),
            "bg": blit + geom, "bgc": bgc, "filter": ("imgfilter",),
            "bgcf": bgc + ("imgfilter",),
            "bgcfn": bgc + ("imgfilter", "noise"),
            "bgcfnc": bgc + ("imgfilter", "noise", "cutout"),
            "bgcn": bgc + ("noise",),
            "bgcnc": bgc + ("noise", "cutout"),
        }
        if name not in specs:
            raise ValueError(f"unknown augpipe spec {name!r}")
        return AugmentConfig(**{k: 1.0 for k in specs[name]})


_NUM_FILTER_BANDS = 4


def draw_spec(cfg: AugmentConfig, batch: int,
              shape: Tuple[int, int, int]) -> List[Tuple[str, str, Tuple]]:
    """The raw draws of one :func:`augment_pipe` call as ``(name, kind,
    shape)`` with kind 'uniform' or 'normal', in the order the JAX function
    consumes its keys.  ``shape`` is the images' ``(H, W, C)``."""
    b = batch
    spec = []

    def add(name, kind, shp):
        spec.append((name, kind, shp))

    def pair(flag, name, kind, shp=(b,), apply_shp=(b,)):
        if flag > 0:
            add(name, kind, shp)
            add(f"{name}_apply", "uniform", apply_shp)

    pair(cfg.xflip, "xflip", "uniform")
    pair(cfg.rotate90, "rotate90", "uniform")
    pair(cfg.xint, "xint", "uniform", (b, 2), (b, 1))
    pair(cfg.scale, "scale", "normal")
    pair(cfg.rotate, "rotate_pre", "uniform")
    pair(cfg.aniso, "aniso", "normal")
    pair(cfg.rotate, "rotate_post", "uniform")
    pair(cfg.xfrac, "xfrac", "normal", (b, 2), (b, 1))
    pair(cfg.brightness, "brightness", "normal")
    pair(cfg.contrast, "contrast", "normal")
    pair(cfg.lumaflip, "lumaflip", "uniform")
    pair(cfg.hue, "hue", "uniform")
    pair(cfg.saturation, "saturation", "normal")
    if cfg.imgfilter > 0:
        for i in range(_NUM_FILTER_BANDS):
            pair(1.0, f"imgfilter{i}", "normal")
    if cfg.noise > 0:
        pair(1.0, "noise", "normal")
        add("noise_field", "normal", (b,) + tuple(shape))
    pair(cfg.cutout, "cutout", "uniform", (b, 2))
    return spec


def draw_augment(cfg: AugmentConfig, generator, batch: int,
                 shape: Tuple[int, int, int], device) -> Dict:
    """Raw draws for :func:`augment_pipe` from a ``torch.Generator`` (drawn
    on the generator's device, returned on ``device``; None = torch's
    default generator of ``device``)."""
    fns = {"uniform": torch.rand, "normal": torch.randn}
    gdev = device if generator is None else generator.device
    return {name: draw_rows(fns[kind], shp, generator=generator,
                            device=gdev).to(device)
            for name, kind, shp in draw_spec(cfg, batch, shape)}


def _bernoulli(u, prob):
    return (u < prob).float()


def _applied(draws: Dict, name: str, prob):
    """1.0 where the transform ``name`` applies: its ``_apply`` draw < prob."""
    return _bernoulli(draws[f"{name}_apply"], prob)


def _affine_warp(images, mat, out_size=None):
    """Apply per-sample inverse affine matrices with bilinear sampling.

    Square images take the two-pass warp (the CUDA kernel on the card, the
    plain version for a CPU tensor); ``out_size`` or a non-square input takes
    the gather form.

    Args:
      images: [B, H, W, C]
      mat: [B, 3, 3] mapping OUTPUT pixel coords (centered) to INPUT coords.
    """
    if out_size is None and images.shape[1] == images.shape[2]:
        return affine_warp_twopass(images, mat)
    return _affine_warp_gather(images, mat, out_size)


def _affine_warp_gather(images, mat, out_size=None):
    """Reference gather-based bilinear warp (exact spec)."""
    b, h, w, c = images.shape
    oh, ow = out_size or (h, w)
    dev = images.device
    ys = torch.arange(oh, dtype=torch.float32, device=dev) - (oh - 1) / 2.0
    xs = torch.arange(ow, dtype=torch.float32, device=dev) - (ow - 1) / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [oh, ow, 3]
    src = torch.einsum("bij,hwj->bhwi", mat.float(), coords)
    sx = src[..., 0] + (w - 1) / 2.0
    sy = src[..., 1] + (h - 1) / 2.0

    def reflect(v, n):
        period = 2.0 * (n - 1)
        v = torch.remainder(v, period)
        return torch.where(v > (n - 1), period - v, v)

    sx = reflect(sx, w)
    sy = reflect(sy, h)
    x0 = torch.floor(sx).long()
    y0 = torch.floor(sy).long()
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    bidx = torch.arange(b, device=dev)[:, None, None]

    def gather(yy, xx):
        return images[bidx, yy, xx]

    return ((1 - fy) * (1 - fx) * gather(y0, x0)
            + (1 - fy) * fx * gather(y0, x1)
            + fy * (1 - fx) * gather(y1, x0)
            + fy * fx * gather(y1, x1))


def _twopass_prep(images, mat, antialias: bool = True):
    """Shared prep of the two-pass warp's kernel and plain forms.

    Factors an exact quarter-turn out of near-90-degree transforms and
    reduces each per-sample inverse affine to eight pass scalars in 0-based
    pixel coordinates:

        scalars[b] = (A1, B1, c1, s1, D2, E2, c2, s2)

    so pass 1 samples the input row ``r`` at ``u(r, j) = B1*r + A1*j + c1``
    with triangle half-width ``s1``, and pass 2 samples the intermediate at
    ``v(i, j) = E2*i + D2*j + c2`` with half-width ``s2``.

    Returns (imgs, scalars): the (possibly pre-rotated) images and the
    [B, 8] float32 scalar pack.
    """
    b, h, w, c = images.shape
    assert h == w, "two-pass warp requires square images"
    ctr = (w - 1) / 2.0
    m = mat.float()

    use_rot = m[:, 0, 1].abs() > m[:, 1, 1].abs()
    r1inv = torch.tensor([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                         device=m.device)
    m = torch.where(use_rot[:, None, None], r1inv @ m, m)
    img_rot = images.transpose(1, 2).flip(1)
    imgs = torch.where(use_rot[:, None, None, None], img_rot, images)

    a, bb, cc = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, ff = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    tiny = torch.where(e < 0, -1e-6, 1e-6).to(e.dtype)
    e = torch.where(e.abs() < 1e-6, tiny, e)

    a1 = a - bb * d / e                       # du/dj
    b1 = bb / e                               # du/dr
    c1 = (cc - bb * ff / e) + ctr - (a1 + b1) * ctr
    c2 = ff + ctr - (d + e) * ctr
    one = torch.ones_like(a1)
    s1 = torch.clamp_min(a1.abs(), 1.0) if antialias else one
    s2 = torch.clamp_min(e.abs(), 1.0) if antialias else one
    scalars = torch.stack([a1, b1, c1, s1, d, e, c2, s2], dim=-1)
    return imgs, scalars


def _affine_warp_twopass(images, mat, antialias: bool = True):
    """Plain version of the two-pass (Catmull-Smith) affine warp for square
    images: each per-sample inverse affine becomes a horizontal then a
    vertical 1-D resampling pass, each a dense interpolation-matrix
    contraction in f32.

    When the transform is closer to a 90-degree rotation than to the identity
    a quarter-turn is factored out per sample (``_twopass_prep``), so the
    vertical pass scale stays bounded away from zero.  ``antialias=True``
    widens each pass's triangle to the local minification factor;
    ``antialias=False`` reproduces naive bilinear sampling.
    """
    imgs, sc = _twopass_prep(images, mat, antialias)
    return warp_twopass_plain(imgs, sc).to(images.dtype)


def _rows3(r0, r1, r2):
    return torch.stack([torch.stack(r0, -1), torch.stack(r1, -1),
                        torch.stack(r2, -1)], -2)


def _rot2(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return _rows3([c, -s, z], [s, c, z], [z, z, o])


def _scale2(sx, sy):
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return _rows3([sx, z, z], [z, sy, z], [z, z, o])


def _translate2(tx, ty):
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return _rows3([o, z, tx], [z, o, ty], [z, z, o])


def _rotation_about_axis(axis, theta):
    """[B] angles -> [B, 4, 4] homogeneous rotations about a 3-vector axis."""
    x, y, z = axis
    c = torch.cos(theta)
    s = torch.sin(theta)
    one_c = 1 - c
    r = _rows3(
        [c + x * x * one_c, x * y * one_c - z * s, x * z * one_c + y * s],
        [y * x * one_c + z * s, c + y * y * one_c, y * z * one_c - x * s],
        [z * x * one_c - y * s, z * y * one_c + x * s, c + z * z * one_c])
    m = torch.eye(4, device=theta.device).repeat(theta.shape[0], 1, 1)
    m[:, :3, :3] = r
    return m


def geometric_matrix(cfg: AugmentConfig, draws: Dict, batch: int, h: int,
                     w: int, p):
    """The blit and geometric transforms of one pipe call composed into one
    affine ``[B, 3, 3]`` that maps input to output pixel coordinates
    (centred).  ``p`` is a 0-d tensor; the result lies on its device."""
    b, dev = batch, p.device
    ones = torch.ones((b,), device=dev)

    def apply(name, mult):
        return _applied(draws, name, mult * p)

    g = torch.eye(3, device=dev).repeat(b, 1, 1)

    if cfg.xflip > 0:
        i = torch.round(draws["xflip"]) * apply("xflip", cfg.xflip)
        g = _scale2(1 - 2 * i, ones) @ g
    if cfg.rotate90 > 0:
        i = torch.floor(draws["rotate90"] * 4) * apply("rotate90",
                                                       cfg.rotate90)
        g = _rot2(-math.pi / 2 * i) @ g
    if cfg.xint > 0:
        t = (draws["xint"] * 2 - 1) * cfg.xint_max
        t = t * apply("xint", cfg.xint)
        g = _translate2(torch.round(t[:, 0] * w),
                        torch.round(t[:, 1] * h)) @ g

    if cfg.scale > 0:
        s = torch.exp2(draws["scale"] * cfg.scale_std)
        s = torch.where(apply("scale", cfg.scale) > 0, s, ones)
        g = _scale2(s, s) @ g
    # P(pre OR post rotation).
    p_rot = 1 - torch.sqrt(torch.clamp(1 - cfg.rotate * p, 0, 1))
    if cfg.rotate > 0:
        theta = (draws["rotate_pre"] * 2 - 1) * math.pi * cfg.rotate_max
        theta = theta * _applied(draws, "rotate_pre", p_rot)
        g = _rot2(-theta) @ g
    if cfg.aniso > 0:
        s = torch.exp2(draws["aniso"] * cfg.aniso_std)
        s = torch.where(apply("aniso", cfg.aniso) > 0, s, ones)
        g = _scale2(s, 1 / s) @ g
    if cfg.rotate > 0:
        theta = (draws["rotate_post"] * 2 - 1) * math.pi * cfg.rotate_max
        theta = theta * _applied(draws, "rotate_post", p_rot)
        g = _rot2(-theta) @ g
    if cfg.xfrac > 0:
        t = draws["xfrac"] * cfg.xfrac_std
        t = t * apply("xfrac", cfg.xfrac)
        g = _translate2(t[:, 0] * w, t[:, 1] * h) @ g
    return g


def augment_pipe(cfg: AugmentConfig, draws: Dict, images, p):
    """Apply the ADA pipeline.

    Args:
      cfg: static transform multipliers.
      draws: the raw draws of :func:`draw_augment` (or a test's replay of
        the JAX function's).
      images: [B, H, W, C] float in roughly [-1, 1].
      p: 0-d tensor (or float), the overall probability.

    Returns augmented images, same shape.
    """
    b, h, w, c = images.shape
    dev = images.device
    p = torch.as_tensor(p, dtype=torch.float32, device=dev)
    ones = torch.ones((b,), device=dev)

    def apply(name, mult):
        return _applied(draws, name, mult * p)

    is_identity = cfg.xflip == cfg.rotate90 == cfg.xint == cfg.scale == \
        cfg.rotate == cfg.aniso == cfg.xfrac == 0
    if not is_identity:
        # Blit + geometric -> one affine; it maps input->output, so warp
        # with the inverse (inv_ex: no host sync).
        g = geometric_matrix(cfg, draws, b, h, w, p)
        images = _affine_warp(images, torch.linalg.inv_ex(g).inverse)

    # ---------------- color transforms (homogeneous 4x4) -------------------
    eye4 = torch.eye(4, device=dev)
    cmat = eye4.repeat(b, 1, 1)
    v = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev) / math.sqrt(3)

    if cfg.brightness > 0:
        bb = draws["brightness"] * cfg.brightness_std
        bb = bb * apply("brightness", cfg.brightness)
        m = eye4.repeat(b, 1, 1)
        m[:, :3, 3] = bb[:, None]
        cmat = m @ cmat
    if cfg.contrast > 0:
        cc = torch.exp2(draws["contrast"] * cfg.contrast_std)
        cc = torch.where(apply("contrast", cfg.contrast) > 0, cc, ones)
        scale_diag = torch.cat([cc[:, None].expand(-1, 3),
                                torch.ones((b, 1), device=dev)], dim=1)
        cmat = torch.diag_embed(scale_diag) @ cmat
    if cfg.lumaflip > 0:
        i = torch.round(draws["lumaflip"]) * apply("lumaflip", cfg.lumaflip)
        house = eye4 - 2 * torch.outer(v, v)           # reflect about luma
        m = torch.where(i[:, None, None] > 0, house[None], eye4[None])
        cmat = m @ cmat
    if cfg.hue > 0:
        theta = (draws["hue"] * 2 - 1) * math.pi * cfg.hue_max
        theta = theta * apply("hue", cfg.hue)
        cmat = _rotation_about_axis(v[:3], theta) @ cmat
    if cfg.saturation > 0:
        s = torch.exp2(draws["saturation"] * cfg.saturation_std)
        s = torch.where(apply("saturation", cfg.saturation) > 0, s, ones)
        vv = torch.outer(v, v)
        m = vv[None] + (eye4[None] - vv[None]) * s[:, None, None]
        cmat = m @ cmat

    has_color = any([cfg.brightness, cfg.contrast, cfg.lumaflip, cfg.hue,
                     cfg.saturation])
    if has_color and c == 3:
        flat = images.reshape(b, -1, 3)
        flat = torch.einsum("bij,bnj->bni", cmat[:, :3, :3], flat) \
            + cmat[:, None, :3, 3]
        images = flat.reshape(b, h, w, 3)

    if cfg.imgfilter > 0:
        images = _imgfilter(cfg, draws, images, p)

    # ---------------- noise + cutout ---------------------------------------
    if cfg.noise > 0:
        sigma = draws["noise"].abs() * cfg.noise_std
        sigma = sigma * apply("noise", cfg.noise)
        images = images + draws["noise_field"] * sigma[:, None, None, None]
    if cfg.cutout > 0:
        center = draws["cutout"]
        ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] / h
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] / w
        half = cfg.cutout_size / 2
        mask_y = (ys - center[:, 1, None, None]).abs() < half
        mask_x = (xs - center[:, 0, None, None]).abs() < half
        cut = (mask_y & mask_x).float() * apply("cutout",
                                                cfg.cutout)[:, None, None]
        images = images * (1.0 - cut)[..., None]

    return images


def _sym2_filter_bank() -> np.ndarray:
    """4-band orthogonal filter bank from the sym2 wavelet
    (reference augment.py:170-179): band i = i lowpass halvings followed by
    one highpass, materialized as zero-stuffed convolutions."""
    import scipy.signal
    hz_lo = np.asarray([-0.12940952255092145, 0.22414386804185735,
                        0.836516303737469, 0.48296291314469025])
    hz_hi = hz_lo * ((-1.0) ** np.arange(hz_lo.size))
    hz_lo2 = np.convolve(hz_lo, hz_lo[::-1]) / 2.0
    hz_hi2 = np.convolve(hz_hi, hz_hi[::-1]) / 2.0
    fbank = np.eye(4, 1)
    for i in range(1, fbank.shape[0]):
        fbank = np.dstack([fbank, np.zeros_like(fbank)]).reshape(
            fbank.shape[0], -1)[:, :-1]
        fbank = scipy.signal.convolve(fbank, [hz_lo2])
        lo = (fbank.shape[1] - hz_hi2.size) // 2
        fbank[i, lo:lo + hz_hi2.size] += hz_hi2
    return fbank.astype(np.float32)


def _imgfilter(cfg: AugmentConfig, draws: Dict, images, p):
    """Frequency-band amplification (reference augment.py:372-401): amplify
    each of 4 wavelet bands with lognormal gain, power-normalized against the
    expected 1/f spectrum, applied as a separable per-sample FIR filter."""
    b, h, w, c = images.shape
    dev = images.device
    fbank = torch.from_numpy(_sym2_filter_bank()).to(dev)      # [4, taps]
    num_bands = fbank.shape[0]
    expected_power = torch.tensor([10.0, 1.0, 1.0, 1.0], device=dev) / 13.0

    g = torch.ones((b, num_bands), device=dev)
    for i in range(num_bands):
        t_i = torch.exp2(draws[f"imgfilter{i}"] * cfg.imgfilter_std)
        apply = _applied(draws, f"imgfilter{i}", cfg.imgfilter * p)
        t_i = torch.where(apply > 0, t_i, torch.ones_like(t_i))
        t = torch.ones((b, num_bands), device=dev)
        t[:, i] = t_i
        t = t / torch.sqrt((expected_power * t.square()).sum(-1, keepdim=True))
        g = g * t

    hz_prime = g @ fbank                               # [B, taps]
    taps = fbank.shape[1]
    pad = taps // 2
    x = F.pad(images.permute(0, 3, 1, 2), [pad, pad, pad, pad],
              mode="reflect")                          # [B, C, H', W']
    # Separable per-sample depthwise filtering: the batch moves into the
    # channels of one grouped conv (rows pass, then cols pass).
    x = x.reshape(1, b * c, x.shape[2], x.shape[3])
    kern = hz_prime.repeat_interleave(c, dim=0)        # [B*C, taps]
    y = F.conv2d(x, kern[:, None, :, None], groups=b * c)
    y = F.conv2d(y, kern[:, None, None, :], groups=b * c)
    return y.reshape(b, c, h, w).permute(0, 2, 3, 1)
