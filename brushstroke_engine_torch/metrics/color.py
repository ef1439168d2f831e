"""Color-space conversions and the Lab color-control metrics.

Counterpart of ``brushstroke_engine_tpu/metrics/color.py``: sRGB -> linear
-> XYZ -> CIELAB, and LAB_E% (percent of foreground pixels whose Lab
distance to the user color exceeds the just-noticeable difference) and
LAB_L2 (mean masked Lab distance).  NHWC tensors.
"""

from __future__ import annotations

import numpy as np
import torch

# D65 white point, standard sRGB matrices.
_RGB2XYZ = np.array([
    [0.412453, 0.212671, 0.019334],
    [0.357580, 0.715160, 0.119193],
    [0.180423, 0.072169, 0.950227],
], np.float32)  # column-multiplied: xyz = rgb @ _RGB2XYZ
_WHITE = np.array([0.950456, 1.0, 1.088754], np.float32)


def srgb_to_linear(srgb):
    srgb = srgb.clamp(0.0, 1.0)
    return torch.where(srgb <= 0.04045, srgb / 12.92,
                       ((srgb + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(rgb):
    rgb = rgb.clamp(0.0, 1.0)
    return torch.where(rgb <= 0.0031308, rgb * 12.92,
                       1.055 * rgb ** (1.0 / 2.4) - 0.055)


def rgb2lab(rgb):
    """sRGB ``[..., 3]`` in [0, 1] -> CIELAB ``[..., 3]`` (L in [0, 100])."""
    lin = srgb_to_linear(rgb)
    xyz = lin @ torch.as_tensor(_RGB2XYZ, device=rgb.device)
    xyz = xyz / torch.as_tensor(_WHITE, device=rgb.device)

    eps = 6.0 / 29.0

    def f(t):
        # The cube root only where t > eps^3 > 0 (torch has no real cbrt).
        return torch.where(t > eps ** 3, t.clamp_min(eps ** 3) ** (1.0 / 3),
                           t / (3 * eps ** 2) + 4.0 / 29.0)

    fx, fy, fz = f(xyz[..., 0]), f(xyz[..., 1]), f(xyz[..., 2])
    lum = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack([lum, a, b], dim=-1)


def compute_lab_deltas(target_colors, renders, ignore_transparency=False):
    """Per-pixel Lab distance to the target stroke color.

    Args:
      target_colors: ``[B, 3]`` float [0, 1] user colors.
      renders: ``[B, W, W, 4]`` RGBA float [0, 1].
    """
    if ignore_transparency:
        rgb = renders[..., :3]
    else:
        alpha = renders[..., 3:4]
        rgb = alpha * renders[..., :3] + (1 - alpha)  # over white canvas
    lab_img = rgb2lab(rgb)
    lab_target = rgb2lab(target_colors)[:, None, None, :]
    return torch.linalg.vector_norm(lab_img - lab_target, dim=-1)


def compute_lab_metrics(target_colors, renders, geom, lab_thresh=10.0,
                        ignore_transparency=False):
    """LAB_E% / LAB_L2 over stroke-foreground pixels (``geom`` ``[B, W, W,
    1]``, 0 = FG); JND 10 as in ColorTriads (SIGGRAPH 2020)."""
    target_colors = torch.as_tensor(target_colors, dtype=torch.float32,
                                    device=renders.device)
    deltas = compute_lab_deltas(target_colors, renders,
                                ignore_transparency=ignore_transparency)
    masks = 1.0 - geom[..., 0]                          # [B, W, W], 1 = FG
    fg_pixels = masks.sum(dim=(1, 2)).clamp_min(1)
    mean_delta = (masks * deltas).mean(dim=(1, 2))
    e_percent = ((deltas > lab_thresh) * masks).sum(dim=(1, 2)) \
        / fg_pixels * 100.0
    return {"LAB_E%": float(e_percent.mean()),
            "LAB_L2": float(mean_delta.mean())}
