"""Stroke-quality metrics: transparency, stitching, background uniformity.

Counterpart of ``brushstroke_engine_tpu/metrics/geom.py``:

  * :func:`compute_transparency_metrics`: BG_CLARITY_MEAN = 1 - mean alpha
    over blurred confident-background pixels; FG_OPACITY_MEDIAN.
  * :func:`compute_stitching_metrics`: LPIPS / L1 between fakes and their
    cross-composites (seam quality).
  * :func:`compute_lpips_across_geo`: style stability across geometry.
  * :func:`compute_uniform_bg_lpips_metric`: masked patch-pair LPIPS over
    background regions.

NHWC tensors.  Random patch offsets and permutations are made in one place
each (:func:`uniform_bg_draws`, :func:`across_geo_perm`) from a CPU
``torch.Generator``, so they are host numbers that cost no device read; the
``draws`` / ``perm`` arguments take them from the caller instead (the
parity tests hand in the JAX package's draws).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from brushstroke_engine_torch.metrics.lpips import lpips_batched

BG_THRESH = 0.999
FG_THRESH = 0.3


def gaussian_smoothing(img, kernel_size: int = 5, sigma: float = 1.0):
    """Depthwise gaussian blur of an NHWC tensor, zero padding."""
    xs = np.arange(kernel_size) - (kernel_size - 1) / 2.0
    k1 = np.exp(-0.5 * (xs / sigma) ** 2)
    k2 = np.outer(k1, k1)
    k2 /= k2.sum()
    c = img.shape[-1]
    kernel = torch.as_tensor(k2, dtype=torch.float32, device=img.device)
    kernel = kernel[None, None].expand(c, 1, kernel_size, kernel_size)
    out = F.conv2d(img.float().permute(0, 3, 1, 2), kernel,
                   padding=kernel_size // 2, groups=c)
    return out.permute(0, 2, 3, 1).to(img.dtype)


def _masked_mean(x, mask):
    m = mask.float()
    return (x * m).sum() / m.sum().clamp_min(1)


def _masked_median(x, mask):
    """The lower median of x where mask (+inf if the mask is empty)."""
    flat = torch.where(mask.reshape(-1), x.reshape(-1),
                       torch.full((), float("inf"), device=x.device))
    n = mask.sum()
    idx = ((n - 1) // 2).clamp(0, flat.shape[0] - 1)
    return torch.sort(flat).values[idx]


def compute_transparency_metrics(renders, geom) -> Dict[str, float]:
    """renders: ``[B, W, W, 4]`` in [0, 1]; geom: ``[B, W, W, 1]``, 0 = FG."""
    alphas = renders[..., 3]
    geom_blur = gaussian_smoothing(gaussian_smoothing(geom))[..., 0]
    g = geom[..., 0]
    bg_clarity = 1.0 - float(_masked_mean(alphas, geom_blur > BG_THRESH))
    fg_opacity = float(_masked_median(alphas, g < FG_THRESH))
    return {"BG_CLARITY_MEAN": bg_clarity, "FG_OPACITY_MEDIAN": fg_opacity}


def compute_stitching_metrics(stitching_result, margin: int
                              ) -> Dict[str, float]:
    """Seam quality between fakes and cross-composites (NHWC)."""

    def crop(img):
        if margin == 0:
            return img
        return img[:, margin:img.shape[1] - 2 * margin,
                   margin:img.shape[2] - 2 * margin]

    def pair(im1, im2):
        return (float(lpips_batched(crop(im1), crop(im2)).mean()),
                float((crop(im1) - crop(im2)).abs().mean()))

    lp1, l11 = pair(stitching_result["fake1"],
                    stitching_result["fake1_composite"])
    lp2, l12 = pair(stitching_result["fake2"],
                    stitching_result["fake2_composite"])
    return {"STITCH_LPIPS": 0.5 * (lp1 + lp2),
            "STITCH_L1": 0.5 * (l11 + l12)}


def composite_over_white(renders):
    alpha = renders[..., 3:4]
    return alpha * renders[..., :3] + (1.0 - alpha)


def _generator(rng) -> torch.Generator:
    return rng if rng is not None else torch.Generator().manual_seed(0)


def across_geo_perm(rng: Optional[torch.Generator], batch: int):
    """The permutation :func:`compute_lpips_across_geo` pairs items by."""
    return torch.randperm(batch, generator=_generator(rng))


def compute_lpips_across_geo(renders, rng=None, perm=None
                             ) -> Dict[str, float]:
    """Perceptual spread of one style across geometries."""
    rgb = composite_over_white(renders) * 2.0 - 1.0
    if perm is None:
        perm = across_geo_perm(rng, renders.shape[0])
    scores = lpips_batched(rgb, rgb[torch.as_tensor(perm).to(rgb.device)])
    return {"LPIPS_ACROSS_GEO": float(scores.mean())}


def uniform_bg_patch_width(w: int) -> int:
    pw = w // 4
    if pw < 64:
        pw = w // 2
    if pw < 64:
        pw = int(0.8 * w)
    return min(pw, w)


def uniform_bg_draws(rng: Optional[torch.Generator], batch: int, h: int,
                     w: int, patch_width: int, same_style: bool) -> Dict:
    """Patch corners ``p0``, ``p1`` (``(y, x)`` host ints) and, for one
    style, the permutation ``perm`` that pairs the second patches."""
    gen = _generator(rng)

    def corner():
        return tuple(int(torch.randint(0, n - patch_width + 1, (1,),
                                       generator=gen)) for n in (h, w))

    draws = {"p0": corner(), "p1": corner(), "perm": None}
    if same_style:
        draws["perm"] = torch.randperm(batch, generator=gen)
    return draws


def compute_uniform_bg_lpips_metric(renders, geom, patch_width=None,
                                    same_style: bool = False, rng=None,
                                    key_suffix: Optional[str] = None,
                                    draws: Optional[Dict] = None
                                    ) -> Dict[str, float]:
    """Background-uniformity LPIPS over random background patches.  Patches
    whose background fraction is too low are masked out of the mean."""
    key = "LPIPS_UNIFORM_BG" + (f"_{key_suffix}" if key_suffix else "")
    b, h, w, _ = renders.shape
    if patch_width is None:
        patch_width = uniform_bg_patch_width(w)
    if draws is None:
        draws = uniform_bg_draws(rng, b, h, w, patch_width, same_style)

    rgb = composite_over_white(renders) * 2.0 - 1.0
    bg_mask = (gaussian_smoothing(geom)[..., 0] > 0.99).float()[..., None]

    def patch(corner, arr):
        y, x = corner
        return arr[:, y:y + patch_width, x:x + patch_width]

    p0, m0 = patch(draws["p0"], rgb), patch(draws["p0"], bg_mask)
    p1, m1 = patch(draws["p1"], rgb), patch(draws["p1"], bg_mask)
    if same_style:
        perm = torch.as_tensor(draws["perm"]).to(rgb.device)
        p1, m1 = p1[perm], m1[perm]

    # Only compare patches that are mostly background in both positions.
    frac0 = m0.mean(dim=(1, 2, 3))
    frac1 = m1.mean(dim=(1, 2, 3))
    valid = ((frac0 > 0.6) & (frac1 > 0.6)).float()
    scores = lpips_batched(p0, p1)
    mean = (scores * valid).sum() / valid.sum().clamp_min(1)
    return {key: float(mean)}
