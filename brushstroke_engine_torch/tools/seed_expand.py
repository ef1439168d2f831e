"""Render a W-space neighbourhood grid around a style seed.

The port's counterpart of ``scripts/seed_expand.py``, with its flags plus
``--device``: :func:`tools.latent.seed_grid` around ``--seed``, each W
rendered on the curated 'curve' stroke, written as one PNG sheet
(``seed<N>_grid.png``, without Pillow).

    python3 -m brushstroke_engine_torch.tools.seed_expand \\
        --gan_checkpoint B.pkl --seed 7 --output_dir OUT

Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def curve_geometry(width: int) -> np.ndarray:
    """The curated 'curve' stroke (radius 16) as ``[1, W, W, 1]`` float."""
    from brushstroke_engine_torch.data.curated_geometry import \
        curated_geometry_patch
    return curated_geometry_patch("curve", 16, width)[None, ..., None] \
        .astype(np.float32)


def render_w(engine, geom, ws, style_id) -> np.ndarray:
    """RGB ``[W, W, 3]`` in [0, 1] of W+ ``ws`` ``[1, num_ws, w_dim]``."""
    from brushstroke_engine_torch.engine.brush import GanBrushOptions
    opts = GanBrushOptions()
    opts.set_style_w(ws, style_id)
    out = engine._run_core(geom, opts)
    return out["rgba"][0, ..., :3].cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gan_checkpoint", required=True)
    ap.add_argument("--encoder_checkpoint", default=None)
    ap.add_argument("--seed", type=int, required=True,
                    help="Center style seed.")
    ap.add_argument("--grid", type=int, default=5)
    ap.add_argument("--radius_scale", type=float, default=0.2)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu.")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from brushstroke_engine_torch.engine.brush import PaintEngineFactory
    from brushstroke_engine_torch.tools.latent import seed_grid
    from brushstroke_engine_torch.utils.img_proc import write_png
    from brushstroke_engine_torch.viz.visualize import make_grid, to_uint8

    engine = PaintEngineFactory.create(
        args.gan_checkpoint, encoder_checkpoint=args.encoder_checkpoint,
        device=args.device)
    grid_ws = seed_grid(engine, args.seed, args.radius_scale, args.grid)
    geom = curve_geometry(engine.patch_width)
    renders = np.stack([render_w(engine, geom, ws[None], "grid")
                        for ws in grid_ws])
    sheet = make_grid(renders, nrow=args.grid, pad=2)
    path = os.path.join(args.output_dir, f"seed{args.seed}_grid.png")
    write_png(path, to_uint8(sheet))
    print(f"Wrote seed grid for {args.seed}")
    return sheet


if __name__ == "__main__":
    main()
