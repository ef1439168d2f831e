"""Reorder the channels of triband geometry images.

The port's counterpart of ``scripts/reformat_triband_data_main.py``, with
its flags: each image of ``--input_dir`` (sorted), read as Pillow's
``convert("RGB")``, is written under its own name to ``--output_dir`` with
its channels in ``--channel_order`` (source indices).  Host only: numpy and
``utils/img_proc.py`` (without Pillow only PNG is read and written).

    python3 -m brushstroke_engine_torch.tools.reformat_triband_data_main \\
        --input_dir triband --output_dir triband_bgr --channel_order 2,1,0
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
    ap.add_argument("--channel_order", default="0,1,2",
                    help="New channel order as CSV of source indices.")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from brushstroke_engine_torch.utils.img_proc import (
        read_image, write_image,
    )

    try:
        order = [int(x) for x in args.channel_order.split(",")]
    except ValueError:
        order = []
    if len(order) != 3 or not all(0 <= i < 3 for i in order):
        ap.error(f"--channel_order {args.channel_order!r}: three source "
                 f"indices in 0-2")
    os.makedirs(args.output_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(args.input_dir)):
        if not name.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        img = read_image(os.path.join(args.input_dir, name), "RGB")
        write_image(os.path.join(args.output_dir, name), img[..., order])
        count += 1
    print(f"Reformatted {count} triband images")


if __name__ == "__main__":
    main()
