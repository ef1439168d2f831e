"""Stroke metrics of a snapshot over a brush library.

The port's counterpart of ``scripts/metric_main.py``, with its flags plus
``--device``: loads a paint engine, renders every style of a library (a
file, a seeds CSV or ``rand<N>``) over geometry (the dataset's, or synthetic
spline strokes at the patch width + 64), and writes the per-style and
summary metric files and ``all_summary.txt`` into ``--eval_output_dir``.
``--enable_stitching`` adds the stitching metrics (``STITCH_LPIPS``,
``STITCH_L1``) of two overlapping crops of the full geometry.

    python3 -m brushstroke_engine_torch.tools.metric_main \\
        --gan_checkpoint bundle.pkl --eval_output_dir out --enable_stitching

Runs on CUDA unless ``--device cpu``; returns the summary.
"""

from __future__ import annotations

import argparse
import logging
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gan_checkpoint", required=True)
    ap.add_argument("--encoder_checkpoint", default=None)
    ap.add_argument("--geom_data", default=None,
                    help="Triband geometry dataset; synthetic if omitted.")
    ap.add_argument("--library", default="rand200",
                    help="Brush library path / seeds CSV / rand<N>.")
    ap.add_argument("--eval_output_dir", required=True)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--nbatches_per_style", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--enable_stitching", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu.")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from brushstroke_engine_torch.engine.library import BrushLibrary
    from brushstroke_engine_torch.metrics.metric_main import (
        paint_engine_metric_loop, summary_losses_to_file,
    )
    from brushstroke_engine_torch.metrics.stroke_generator import (
        PaintStrokeGenerator, RandomState,
    )
    from brushstroke_engine_torch.train.dataset import (
        BatchIterator, ImageFolderDataset, SyntheticGeometryDataset,
    )
    from brushstroke_engine_torch.train.stitching import RandomStitcher

    gen = PaintStrokeGenerator.create(
        args.encoder_checkpoint, args.gan_checkpoint, args.batch_size,
        random_state=RandomState(args.seed), device=args.device)
    res = gen.engine.patch_width
    if args.geom_data:
        geom_ds = ImageFolderDataset(args.geom_data, res + 64, channels=3)
    else:
        geom_ds = SyntheticGeometryDataset(res + 64)
    geom_iter = BatchIterator(geom_ds, args.batch_size, seed=args.seed)
    gen.set_geometry_source_from_iterator(geom_iter, args.batch_size)

    lib = BrushLibrary.from_arg(args.library,
                                z_dim=gen.engine.gen_cfg.z_dim)
    summary = paint_engine_metric_loop(
        gen, lib, args.nbatches_per_style,
        fullres_geom_iterator=geom_iter if args.enable_stitching else None,
        stitcher=RandomStitcher() if args.enable_stitching else None,
        eval_output_dir=args.eval_output_dir)
    summary_losses_to_file(
        os.path.join(args.eval_output_dir, "all_summary.txt"), summary,
        do_print=True)
    return summary


if __name__ == "__main__":
    main()
