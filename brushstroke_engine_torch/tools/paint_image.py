"""Stylize a line drawing with a brush style (batch painting CLI).

The port's counterpart of ``scripts/paint_image_main.py``, with its flags
(minus the int8 path): reads a geometry image (``.npy`` directly, PNG or
JPEG through ``utils.img_proc.read_image``; a PNG needs no Pillow), tiles it into overlapping patches, renders them through
the paint engine with feature blending across seams, and writes the RGBA
canvas (optionally composited on white) as a PNG.  Style interpolation
(``--style_id2``/``--style_blend_alpha``) and color presets as there.

    python3 -m brushstroke_engine_torch.tools.paint_image \\
        --gan_checkpoint bundle.pkl --geo_image drawing.png --output_dir out

Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

COLOR_PRESETS = {
    1: ([50, 60, 160], [210, 150, 130]),
    2: ([200, 50, 50], [250, 200, 100]),
    3: ([40, 40, 40], [150, 150, 150]),
}


def set_colors(color_mode: int, brush_options):
    """Preset color modes (reference paint_image_main.py:66-100)."""
    if color_mode in COLOR_PRESETS:
        c0, c1 = COLOR_PRESETS[color_mode]
        brush_options.set_color(0, np.asarray(c0, np.uint8))
        brush_options.set_color(1, np.asarray(c1, np.uint8))


def read_image(path: str) -> np.ndarray:
    """The drawing as stored: ``.npy`` directly, else through
    ``utils.img_proc.read_image`` in the file's own mode (a PNG needs no
    Pillow)."""
    if path.endswith(".npy"):
        return np.load(path)
    from brushstroke_engine_torch.utils import img_proc
    return img_proc.read_image(path, None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gan_checkpoint", required=True)
    ap.add_argument("--encoder_checkpoint", default=None)
    ap.add_argument("--geo_image", required=True,
                    help="Line drawing to stylize (.npy, PNG or JPEG).")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--library", default=None,
                    help="Brush library file or spec (e.g. rand10).")
    ap.add_argument("--style_id", default=None)
    ap.add_argument("--style_seed", type=int, default=None)
    ap.add_argument("--style_id2", default=None)
    ap.add_argument("--style_blend_alpha", type=float, default=0.5)
    ap.add_argument("--color_mode", type=int, default=0)
    ap.add_argument("--feature_blending_level", type=int, default=2)
    ap.add_argument("--crop_margin", type=int, default=10)
    ap.add_argument("--overlap_margin", type=int, default=10)
    ap.add_argument("--render_mode", default="clear")
    ap.add_argument("--stitching_mode", choices=["all", "full", "nonempty"],
                    default="all",
                    help="'all' renders every tile; 'full' (alias "
                         "'nonempty') skips tiles whose geometry patch has "
                         "no stroke pixels.")
    ap.add_argument("--renderer",
                    choices=["ondevice", "batched", "sequential"],
                    default="ondevice",
                    help="ondevice = waves with the canvas on the device; "
                         "batched = waves assembled on the host; "
                         "sequential = tile by tile through PaintingHelper.")
    ap.add_argument("--on_white", action="store_true")
    ap.add_argument("--no_binarize", action="store_true")
    ap.add_argument("--precision", choices=["fast", "strict"],
                    default="fast",
                    help="'fast' = TF32 and the geometry encoder in bf16; "
                         "'strict' = full f32 for parity debugging.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log_level", type=int, default=logging.INFO)
    args = ap.parse_args(argv)
    logging.basicConfig(level=args.log_level)

    from brushstroke_engine_torch.engine.brush import (
        GanBrushOptions, PaintEngineFactory,
    )
    from brushstroke_engine_torch.engine.canvas import PaintingHelper
    from brushstroke_engine_torch.engine.library import BrushLibrary
    from brushstroke_engine_torch.engine.stylize import (
        read_geometry_image, stylize_image, stylize_image_batched,
        stylize_image_ondevice,
    )
    from brushstroke_engine_torch.ops.precision import set_precision_mode

    engine = PaintEngineFactory.create(
        args.gan_checkpoint, encoder_checkpoint=args.encoder_checkpoint,
        device=args.device)
    set_precision_mode(args.precision)
    engine.set_render_mode(args.render_mode)
    helper = PaintingHelper(engine, style_seed=args.style_seed)

    opts = GanBrushOptions()
    if args.library is not None:
        lib = BrushLibrary.from_arg(args.library,
                                    z_dim=engine.gen_cfg.z_dim)
        style_id = args.style_id or lib.get_style_ids()[0]
        if args.style_id2 is not None:
            lib.set_interpolated_style(style_id, args.style_id2,
                                       args.style_blend_alpha, opts)
        else:
            lib.set_style(style_id, opts)
    else:
        seed = args.style_seed if args.style_seed is not None else 0
        opts.set_style(engine.random_style(seed), seed)
    set_colors(args.color_mode, opts)

    geom = read_geometry_image(read_image(args.geo_image),
                               binarize=not args.no_binarize)

    crop_mode = "nonempty" if args.stitching_mode in ("full", "nonempty") \
        else "all"
    kw = dict(overlap_margin=args.overlap_margin,
              crop_margin=args.crop_margin,
              feature_blending_level=args.feature_blending_level,
              on_white=args.on_white, mode=crop_mode)
    if args.renderer == "sequential" or not engine.supports_device_render:
        canvas = stylize_image(helper, geom, opts, **kw)
    elif args.renderer == "batched":
        canvas = stylize_image_batched(engine, geom, opts, **kw)
    else:
        canvas = stylize_image_ondevice(engine, geom, opts, **kw)

    from brushstroke_engine_torch.utils.img_proc import write_image
    os.makedirs(args.output_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.geo_image))[0]
    out_path = os.path.join(
        args.output_dir,
        f"{base}_style{opts.style_id}_c{args.color_mode}.png")
    write_image(out_path, canvas)
    print(f"Wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
