"""Finetune every style of a brush library for background clarity.

The port's counterpart of ``scripts/opt_clarity_main.py``, with its flags
plus ``--device``: optimizes each style's W+ with the clarity objective
(:mod:`tools.clarity`) on random spline strokes (``default_rng(seed)``,
``--batch_size`` per step) and writes ``OPT_<library>.pkl``.

    python3 -m brushstroke_engine_torch.tools.opt_clarity_main \\
        --gan_checkpoint B.pkl --library ALL_projected_styles.pkl \\
        --output_dir OUT

Runs on CUDA unless ``--device cpu``.
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
    ap.add_argument("--library", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--num_steps", type=int, default=300)
    ap.add_argument("--losses",
                    default="0.5*iou_inv(uvs)+0.5*iou(u)"
                            "+50*lpips(fake_orig)+50*l1(fake_orig)")
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu.")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from brushstroke_engine_torch.data.curves import random_spline_stroke
    from brushstroke_engine_torch.engine.brush import PaintEngineFactory
    from brushstroke_engine_torch.engine.library import BrushLibrary
    from brushstroke_engine_torch.tools.clarity import (
        ClarityConfig, optimize_library_clarity,
    )

    engine = PaintEngineFactory.create(
        args.gan_checkpoint, encoder_checkpoint=args.encoder_checkpoint,
        device=args.device)
    library = BrushLibrary.from_file(args.library,
                                     z_dim=engine.gen_cfg.z_dim)

    def geometry_batches():
        rng = np.random.default_rng(args.seed)
        w = engine.patch_width
        while True:
            yield np.stack([
                random_spline_stroke(rng, w)[..., None]
                for _ in range(args.batch_size)])

    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir,
                            "OPT_" + os.path.basename(args.library))
    results = optimize_library_clarity(
        engine, library, geometry_batches(), out_path=out_path,
        cfg=ClarityConfig(num_steps=args.num_steps, losses=args.losses))
    print(f"Wrote {out_path}")
    return results


if __name__ == "__main__":
    main()
