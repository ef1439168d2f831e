"""Bulk style rendering: one brush icon per style (mode 0, the patch files
of a CLIP dictionary) or a diagnostic grid per style (mode 1).

The port's counterpart of ``scripts/visualize_main.py``, with its flags plus
``--device`` (default ``cuda``; ``cpu`` runs on the CPU):

    python -m brushstroke_engine_torch.tools.visualize_main \\
        --gan_checkpoint B.pkl --library rand20 --output_dir D [--mode 1]

Mode 0 writes ``<style_id>.png`` (``uvs_mapper.get_brush_icon``); mode 1
writes ``grid_<style_id>.png``: the curated ``--geometry`` patch rendered in
the style, as geometry | U | V | S | composite (``visualize_raw_data``).
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gan_checkpoint", required=True)
    ap.add_argument("--encoder_checkpoint", default=None)
    ap.add_argument("--library", default="rand20")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--mode", type=int, default=0,
                    help="0 = per-style patch files, 1 = diagnostic grids.")
    ap.add_argument("--geometry", default="curve",
                    help="Curated shape name for the mode 1 grids.")
    ap.add_argument("--radius", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from brushstroke_engine_torch.data.curated_geometry import (
        curated_geometry_patch,
    )
    from brushstroke_engine_torch.engine.brush import (
        GanBrushOptions, PaintEngineFactory,
    )
    from brushstroke_engine_torch.engine.library import BrushLibrary
    from brushstroke_engine_torch.viz.visualize import (
        save_image, visualize_raw_data,
    )

    engine = PaintEngineFactory.create(
        args.gan_checkpoint, encoder_checkpoint=args.encoder_checkpoint,
        device=args.device)
    lib = BrushLibrary.from_arg(args.library, z_dim=engine.gen_cfg.z_dim)
    os.makedirs(args.output_dir, exist_ok=True)
    ids = lib.get_style_ids()
    if args.mode == 0:
        for style_id in ids:
            opts = GanBrushOptions()
            lib.set_style(style_id, opts)
            save_image(os.path.join(args.output_dir, f"{style_id}.png"),
                       engine.uvs_mapper.get_brush_icon(opts))
        print(f"Wrote {len(ids)} style patches")
    else:
        geom = curated_geometry_patch(args.geometry, args.radius,
                                      engine.patch_width)[None, ..., None]
        geom = np.asarray(geom, np.float32)
        for style_id in ids:
            opts = GanBrushOptions()
            lib.set_style(style_id, opts)
            out = engine._run_core(geom, opts)
            save_image(os.path.join(args.output_dir, f"grid_{style_id}.png"),
                       visualize_raw_data(out, geom))
        print("Wrote diagnostic grids")
    return ids


if __name__ == "__main__":
    main()
