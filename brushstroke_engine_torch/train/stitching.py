"""Training-time stitching: render two overlapping crops consistently and
compose them across the seam for the stitching losses and metrics.

Counterpart of ``brushstroke_engine_tpu/train/stitching.py`` (the reference
RandomStitcher).  Crop rectangles are host ints here, so the patch windows
are plain slices.  Composites are built out of place (a coordinate mask and
a zero-filled translation), so gradients reach the generator through both
crops' renders.

Random draws: the second crop comes from a ``random.Random`` the caller
owns (the training loop's and the metric loops' seeded streams; the JAX
package draws it from Python's unseeded global ``random``), the canvas
positions of the first crop from a ``torch.Generator`` or the caller's
``positions1``.  The generator passes use constant noise, so they draw
nothing else.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from brushstroke_engine_torch.engine.areas import gen_overlapping_square_crop
from brushstroke_engine_torch.models.generator import generator_apply


def translate_image(img, dy: int, dx: int):
    """Shift ``[B, H, W, C]`` content by (dy, dx) with zero fill."""
    _, h, w, _ = img.shape
    rolled = torch.roll(img, shifts=(dy, dx), dims=(1, 2))
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    valid_y = ys >= dy if dy >= 0 else ys < h + dy
    valid_x = xs >= dx if dx >= 0 else xs < w + dx
    mask = (valid_y & valid_x).to(img.dtype)[None, :, :, None]
    return rolled * mask


def rect_mask(h, w, rstart, rend, cstart, cend, dtype=torch.float32,
              device=None):
    """``[h, w]`` mask of the rows [rstart, rend) x columns [cstart, cend)."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    m = (ys >= rstart) & (ys < rend) & (xs >= cstart) & (xs < cend)
    return m.to(dtype)


def composite_shifted(fake1, fake2, area1, delta):
    """Paste fake2, translated by ``delta = (dy, dx)`` into fake1's frame,
    into fake1 over ``area1 = (rstart, rend, cstart, cend)``."""
    h, w = fake1.shape[1:3]
    aligned = translate_image(fake2, delta[0], delta[1])
    m = rect_mask(h, w, *area1, dtype=fake1.dtype,
                  device=fake1.device)[None, :, :, None]
    return fake1 * (1 - m) + aligned * m


def draw_positions(rng: Optional[torch.Generator], batch: int,
                   img_resolution: int, device) -> torch.Tensor:
    """The first crop's canvas positions, ``[batch, 2]`` ints in
    ``[0, img_resolution - 1)`` as the JAX stitcher draws them."""
    gen_dev = device if rng is None else rng.device
    return torch.randint(0, img_resolution - 1, (batch, 2), generator=rng,
                         device=gen_dev).to(device)


@dataclass
class RandomStitcher:
    """Overlapping crops and cross-composited fakes (reference
    stitching.py:194-267)."""

    crop_margin: int = 10
    min_overlap: int = 50

    def gen_overlapping_square_crop(self, input_width: int, crop1,
                                    rng: random.Random):
        return gen_overlapping_square_crop(input_width, crop1,
                                           self.crop_margin,
                                           self.min_overlap, rng)

    def generate_with_stitching(self, gen_cfg, g_params, g_state, z,
                                geom_feature1, geom_feature2, crop1, crop2,
                                rng: Optional[torch.Generator] = None,
                                positions1=None) -> Dict:
        """G on two overlapping crops (``(row, col, h, w)`` host ints) at
        consistent canvas positions, and the two cross-composites.

        As the JAX package, this composites over the margin-shrunk overlap
        in aligned coordinates (the reference indexes the pasted image
        relative to the margin-offset crop, shifting it by ``crop_margin``
        pixels), and the patch windows are ``min(min_overlap, width)``
        wide, clipped into the crop."""
        width = int(gen_cfg.img_resolution)
        batch = z.shape[0]
        crop1 = [int(v) for v in crop1]
        crop2 = [int(v) for v in crop2]
        if positions1 is None:
            positions1 = draw_positions(rng, batch, width, z.device)
        positions1 = torch.as_tensor(positions1, device=z.device).long()
        delta = (crop2[0] - crop1[0], crop2[1] - crop1[1])
        positions2 = positions1 + torch.tensor(delta, device=z.device)

        def run(feats, positions):
            img, _ = generator_apply(
                gen_cfg, g_params, g_state, z=z, geom_features=feats,
                positions=positions, noise_mode="const",
                style_mixing_prob=0.0)
            return img

        fake1 = run(geom_feature1, positions1)
        fake2 = run(geom_feature2, positions2)

        def overlap_rel(base, other, margin):
            """Overlap of the base crop with the margin-shrunk other crop,
            in base's frame: (rstart, rend, cstart, cend)."""
            rs = max(base[0], other[0] + margin) - base[0]
            cs = max(base[1], other[1] + margin) - base[1]
            re = min(base[0] + width, other[0] + width - margin) - base[0]
            ce = min(base[1] + width, other[1] + width - margin) - base[1]
            return rs, re, cs, ce

        m = self.crop_margin
        fake1_composite = composite_shifted(
            fake1, fake2, overlap_rel(crop1, crop2, m), delta)
        fake2_composite = composite_shifted(
            fake2, fake1, overlap_rel(crop2, crop1, m),
            (-delta[0], -delta[1]))

        # Aligned windows of the same canvas region for the patch losses.
        pw = min(int(self.min_overlap), width)
        abs_rs = max(crop1[0] + m, crop2[0])
        abs_cs = max(crop1[1] + m, crop2[1])

        def window(img, crop):
            r = min(max(abs_rs - crop[0], 0), width - pw)
            c = min(max(abs_cs - crop[1], 0), width - pw)
            return img[:, r:r + pw, c:c + pw]

        return {
            "fake1": fake1,
            "fake2": fake2,
            "fake1_composite": fake1_composite,
            "fake2_composite": fake2_composite,
            "positions1": positions1,
            "positions2": positions2,
            "patch1": window(fake1, crop1),
            "patch2": window(fake2, crop2),
        }
