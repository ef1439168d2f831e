"""Render sweeps along W-space PCA directions.

The port's counterpart of ``scripts/visualize_pca_main.py``, with its flags
plus ``--device``: principal directions of dumped (``--ws_file``, from
``tools/get_ws_main.py``) or sampled W vectors, and per direction one PNG
row of renders swept from ``-sweep_scale`` to ``+sweep_scale`` standard
deviations (``pca_<i>.png``, without Pillow).

    python3 -m brushstroke_engine_torch.tools.visualize_pca_main \\
        --gan_checkpoint B.pkl --output_dir OUT

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
    ap.add_argument("--ws_file", default=None,
                    help="Binary f64 W dump (get_ws_main); sampled if absent.")
    ap.add_argument("--num_seeds", type=int, default=200)
    ap.add_argument("--num_components", type=int, default=4)
    ap.add_argument("--num_steps", type=int, default=7)
    ap.add_argument("--sweep_scale", type=float, default=2.0)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu.")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from brushstroke_engine_torch.engine.brush import PaintEngineFactory
    from brushstroke_engine_torch.tools.latent import (
        pca_directions, ws_for_seeds,
    )
    from brushstroke_engine_torch.tools.seed_expand import (
        curve_geometry, render_w,
    )
    from brushstroke_engine_torch.utils.img_proc import write_png
    from brushstroke_engine_torch.viz.visualize import to_uint8

    engine = PaintEngineFactory.create(
        args.gan_checkpoint, encoder_checkpoint=args.encoder_checkpoint,
        device=args.device)
    if args.ws_file:
        w = np.fromfile(args.ws_file, np.float64).reshape(
            -1, engine.gen_cfg.w_dim).astype(np.float32)
    else:
        w = ws_for_seeds(engine, list(range(args.num_seeds)))[:, 0, :]
    comps, var = pca_directions(w, args.num_components)
    mean = w.mean(0)

    geom = curve_geometry(engine.patch_width)
    num_ws = engine.gen_cfg.num_ws
    rows = []
    for ci in range(args.num_components):
        row = []
        for t in np.linspace(-args.sweep_scale, args.sweep_scale,
                             args.num_steps):
            wi = mean + t * np.sqrt(var[ci]) * comps[ci]
            ws = np.tile(wi[None, None, :], (1, num_ws, 1))
            row.append(render_w(engine, geom, ws.astype(np.float32),
                                f"pca{ci}_{t:.1f}"))
        rows.append(np.concatenate(row, axis=1))
        write_png(os.path.join(args.output_dir, f"pca_{ci}.png"),
                  to_uint8(rows[-1]))
    print(f"Wrote {args.num_components} PCA sweeps to {args.output_dir}")
    return rows


if __name__ == "__main__":
    main()
