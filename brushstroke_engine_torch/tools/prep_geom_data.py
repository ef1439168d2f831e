"""Triband geometry images from gray stroke images.

The port's counterpart of ``scripts/prep_geom_data.py``, with its flags:
channels = [gray input, binarized conditioning, blurred-binary loss target]
(``data/curves.py:triband_from_stroke``); white = background, black =
stroke.  Each image is read as stored (alpha, where there is one, is the
stroke), binarized at Otsu's threshold unless ``--threshold``, and written
as ``<name>_tri.png``.  Host only: numpy and ``utils/img_proc.py`` (Pillow
where it is installed, else its own PNG codec).

    python3 -m brushstroke_engine_torch.tools.prep_geom_data \\
        --input_dir splines --output_dir triband
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--blur_sigma", type=float, default=2.0)
    ap.add_argument("--threshold", type=float, default=None,
                    help="Binarization threshold; Otsu if omitted.")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from brushstroke_engine_torch.data.curves import triband_from_stroke
    from brushstroke_engine_torch.utils.img_proc import (
        alpha_to_gray, read_image, threshold_otsu, write_image,
    )

    os.makedirs(args.output_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(args.input_dir)):
        if not name.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
            continue
        gray = alpha_to_gray(read_image(os.path.join(args.input_dir, name),
                                        None))
        t = args.threshold if args.threshold is not None \
            else threshold_otsu(gray)
        tri = triband_from_stroke(gray, blur_sigma=args.blur_sigma,
                                  threshold=t)
        write_image(os.path.join(args.output_dir,
                                 os.path.splitext(name)[0] + "_tri.png"),
                    (np.clip(tri, 0, 1) * 255).astype(np.uint8))
        count += 1
    print(f"Wrote {count} triband images to {args.output_dir}")


if __name__ == "__main__":
    main()
