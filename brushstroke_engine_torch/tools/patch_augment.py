"""Augmented multi-scale style patches, filtered by entropy, into a zip.

The port's counterpart of ``scripts/patch_augment.py``, with its flags: from
each image of ``--input_dir`` (read as Pillow's ``convert("RGB")``, sorted,
skipped when smaller than a patch) ``--patches_per_image`` square patches at
scales ``[--scale_min, --scale_max]`` (``RandomPatchGenerator``), each
mirrored with probability 1/2 and turned by a random multiple of 90 degrees,
all drawn from one ``default_rng(seed)`` in the JAX script's order; patches
whose gray entropy is below ``--min_entropy`` are skipped; members are
``{base}_{i:04d}.png``.  Host only: numpy and ``utils/img_proc.py``.

    python3 -m brushstroke_engine_torch.tools.patch_augment \\
        --input_dir media --output_zip patches.zip --patch_width 128
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
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--output_zip", required=True)
    ap.add_argument("--patch_width", type=int, default=128)
    ap.add_argument("--patches_per_image", type=int, default=50)
    ap.add_argument("--scale_min", type=float, default=1.0)
    ap.add_argument("--scale_max", type=float, default=2.0)
    ap.add_argument("--min_entropy", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from brushstroke_engine_torch.utils.img_proc import (
        RandomPatchGenerator, patch_entropy, read_image, resize_bilinear,
        write_image,
    )

    rng = np.random.default_rng(args.seed)
    gen = RandomPatchGenerator(rng, args.patch_width,
                               (args.scale_min, args.scale_max))
    written = skipped = 0
    with zipfile.ZipFile(args.output_zip, "w") as zf:
        for name in sorted(os.listdir(args.input_dir)):
            if not name.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
                continue
            img = read_image(os.path.join(args.input_dir, name), "RGB")
            if min(img.shape[:2]) < args.patch_width:
                continue
            for i in range(args.patches_per_image):
                patch = gen.sample(img)
                if patch.shape[0] != args.patch_width:
                    patch = np.clip(resize_bilinear(
                        patch.astype(np.float32), args.patch_width,
                        args.patch_width), 0, 255).astype(np.uint8)
                if rng.random() < 0.5:
                    patch = patch[:, ::-1]
                patch = np.rot90(patch, k=int(rng.integers(0, 4)))
                gray = patch.astype(np.float32).mean(-1) / 255.0
                if patch_entropy(gray) < args.min_entropy:
                    skipped += 1
                    continue
                buf = io.BytesIO()
                write_image(buf, patch)
                zf.writestr(f"{os.path.splitext(name)[0]}_{i:04d}.png",
                            buf.getvalue())
                written += 1
    print(f"Wrote {written} patches ({skipped} low-entropy skipped) to "
          f"{args.output_zip}")


if __name__ == "__main__":
    main()
