"""Pack an image folder into a training zip.

The port's counterpart of ``scripts/dataset_tool.py``, with its flags: every
image under ``--source`` (directories and files in sorted order) is read as
Pillow's ``convert("RGB")`` reads it; with ``--resolution`` its short side
is resized to that size (``resize_bilinear``) and the centre square cut;
members are ``{count:08d}.png``.  Triband geometry goes through the same
path and stays 3-channel.  ``tools/train.py`` and ``train_autoencoder.py``
read the zips.  Host only: numpy and ``utils/img_proc.py`` (Pillow where it
is installed, else its own PNG codec: then only PNG sources are read).

    python3 -m brushstroke_engine_torch.tools.dataset_tool \\
        --source media --dest style.zip --resolution 128
"""

from __future__ import annotations

import argparse
import io
import logging
import os
import zipfile

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", required=True, help="Image directory.")
    ap.add_argument("--dest", required=True, help="Output zip.")
    ap.add_argument("--resolution", type=int, default=None,
                    help="Center-crop/resize to this square size.")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from brushstroke_engine_torch.utils.img_proc import (
        read_image, resize_bilinear, write_image,
    )

    count = 0
    with zipfile.ZipFile(args.dest, "w") as zf:
        for root, dirs, files in os.walk(args.source):
            dirs.sort()
            for name in sorted(files):
                if not name.lower().endswith(
                        (".png", ".jpg", ".jpeg", ".bmp", ".webp")):
                    continue
                img = read_image(os.path.join(root, name), "RGB")
                if args.resolution:
                    r = args.resolution
                    h, w = img.shape[:2]
                    s = r / min(h, w)
                    img = np.clip(resize_bilinear(
                        img.astype(np.float32), max(r, round(h * s)),
                        max(r, round(w * s))), 0, 255).astype(np.uint8)
                    h, w = img.shape[:2]
                    y, x = (h - r) // 2, (w - r) // 2
                    img = img[y:y + r, x:x + r]
                buf = io.BytesIO()
                write_image(buf, img)
                zf.writestr(f"{count:08d}.png", buf.getvalue())
                count += 1
    print(f"Packed {count} images into {args.dest}")


if __name__ == "__main__":
    main()
