"""Stitching sheets of a snapshot: adjacent patches at their correct canvas
positions against random ones, one sheet per style.

The port's counterpart of ``scripts/visualize_stitching_main.py``, with its
flags plus ``--device``; writes ``stitching_style<i>.png`` into
``--output_dir`` (``TrainingVisualizer.visualize_stitching``).

    python3 -m brushstroke_engine_torch.tools.visualize_stitching \\
        --gan_checkpoint bundle.pkl --output_dir sheets

Runs on CUDA unless ``--device cpu``; returns the sheets' paths.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gan_checkpoint", required=True)
    ap.add_argument("--encoder_checkpoint", default=None)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--num_styles", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu.")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from brushstroke_engine_torch.engine.brush import PaintEngineFactory
    from brushstroke_engine_torch.viz.visualize import TrainingVisualizer

    engine = PaintEngineFactory.create(
        args.gan_checkpoint, encoder_checkpoint=args.encoder_checkpoint,
        device=args.device)
    viz = TrainingVisualizer(width=engine.patch_width,
                             num_fixed_styles=args.num_styles,
                             seed=args.seed)
    viz.init(engine.gen_cfg.z_dim)
    os.makedirs(args.output_dir, exist_ok=True)
    paths = []
    for i in range(args.num_styles):
        viz.fixed_z = np.roll(viz.fixed_z, i, axis=0)
        viz.visualize_stitching(args.output_dir, engine, f"style{i}")
        paths.append(os.path.join(args.output_dir, f"stitching_style{i}.png"))
    print(f"Wrote stitching sheets to {args.output_dir}")
    return paths


if __name__ == "__main__":
    main()
