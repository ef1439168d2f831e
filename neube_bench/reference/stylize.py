"""Plain reference of whole-drawing stylization with feature blending.

The drawing is padded with background to a whole grid of ``patch``-px
tiles at stride ``patch - 2 * overlap``.  Tiles fall into four
checkerboard classes by (row, column) parity, rendered class after class
in the order (0, 0), (0, 1), (1, 0), (1, 1).  Tiles of one class never
overlap, so within a class the order does not matter.  Each tile reads the
features that earlier classes stored on a feature canvas at the blending
resolution: where a texel holds features (mask 1) they replace the trunk's.
It then writes its own features inside its crop border where none were
stored, and its RGBA, cropped by ``crop`` px, into the canvas.  The RGBA is
stored as ``uint8(clamp(rgba, 0, 1) * 255)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from neube_bench import weights as W
from neube_bench.reference.model import render


def tile_grid(rows: int, cols: int, patch: int, overlap: int):
    """(padded rows, padded cols, [(y, x)] in scan order)."""
    stride = patch - 2 * overlap
    pr = max(patch, math.ceil((rows - 2 * overlap) / stride) * stride
             + 2 * overlap)
    pc = max(patch, math.ceil((cols - 2 * overlap) / stride) * stride
             + 2 * overlap)
    ys = [min(y, pr - patch) for y in range(0, max(pr - 2 * overlap - 1, 1),
                                            stride)]
    xs = [min(x, pc - patch) for x in range(0, max(pc - 2 * overlap - 1, 1),
                                            stride)]
    return pr, pc, [(y, x) for y in ys for x in xs]


def stylize(cfg, trees, drawing, z, dtype, *, overlap: int = 10,
            crop: int = 10, level: int = 2, batch: int = 32) -> np.ndarray:
    """``drawing`` ``[H, W]`` float tensor on the device (1 = background),
    ``z`` ``[1, z_dim]``.  Returns the ``[H', W', 4]`` uint8 canvas."""
    dev = drawing.device
    patch = cfg["img_resolution"]
    stride = patch - 2 * overlap
    rows, cols = drawing.shape
    pr, pc, tiles = tile_grid(rows, cols, patch, overlap)
    geom = torch.ones(pr, pc, device=dev)
    geom[:rows, :cols] = drawing
    down = 2 ** (level - 1)
    r = patch // down
    ch = W.channels(cfg, r)
    feat = torch.zeros(ch, -(-pr // down), -(-pc // down), device=dev)
    mask = torch.zeros(feat.shape[1:], device=dev)
    cm = crop // down
    border = torch.zeros(r, r, device=dev)
    border[cm:r - cm, cm:r - cm] = 1.0
    canvas = torch.zeros(4, pr, pc, dtype=torch.uint8, device=dev)
    inner = patch - 2 * crop
    classes = {}
    for y, x in tiles:
        classes.setdefault(((y // stride) % 2, (x // stride) % 2),
                           []).append((y, x))
    for key in sorted(classes):
        cls = classes[key]
        for at in range(0, len(cls), batch):
            part = cls[at:at + batch]
            g = torch.stack([geom[y:y + patch, x:x + patch]
                             for y, x in part])[:, None]
            pos = torch.tensor(part, device=dev)
            zs = z.to(dev, torch.float32).expand(len(part), -1)
            starts = [(min(y // down, feat.shape[1] - r),
                       min(x // down, feat.shape[2] - r)) for y, x in part]
            f_in = torch.stack([feat[:, a:a + r, b:b + r]
                                for a, b in starts])
            m_in = torch.stack([mask[a:a + r, b:b + r] for a, b in starts])
            rgba, f_out = render(cfg, trees, g, zs, pos, dtype,
                                 blend={r: (f_in, m_in[:, None])},
                                 feature_res=r)
            upd = (1.0 - m_in) * border
            for i, (a, b) in enumerate(starts):
                u = upd[i]
                win = feat[:, a:a + r, b:b + r]
                feat[:, a:a + r, b:b + r] = win * (1 - u) + f_out[i] * u
                mask[a:a + r, b:b + r] = torch.maximum(
                    mask[a:a + r, b:b + r], u)
            u8 = (rgba.clamp(0.0, 1.0) * 255).to(torch.uint8)
            for i, (y, x) in enumerate(part):
                canvas[:, y + crop:y + crop + inner, x + crop:x + crop + inner] \
                    = u8[i, :, crop:patch - crop, crop:patch - crop]
    return canvas.permute(1, 2, 0).cpu().numpy()
