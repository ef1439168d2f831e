"""The seeded synthetic style images of the metric yardstick.

The port's counterpart of ``scripts/make_synthetic_styles.py``, with its
flags: flat colour + gaussian noise + a linear luminance ramp per image,
from one ``default_rng(seed)``, so ``--seed 0 --num_images 1200`` gives the
distribution ``PARITY.md`` records its FID/KID/PR yardstick against, pixel
for pixel.  Written as ``{i:04d}.png``; pack them with
``tools/dataset_tool.py``.  Host only: numpy and ``utils/img_proc.py``.

    python3 -m brushstroke_engine_torch.tools.make_synthetic_styles \\
        --output_dir styles --num_images 1200 --resolution 128 --seed 0
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--num_images", type=int, default=1200)
    ap.add_argument("--resolution", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from brushstroke_engine_torch.utils.img_proc import write_image

    os.makedirs(args.output_dir, exist_ok=True)
    r = args.resolution
    rng = np.random.default_rng(args.seed)
    for i in range(args.num_images):
        base = rng.integers(30, 220, 3)
        img = np.clip(base[None, None] + rng.normal(0, 30, (r, r, 3)),
                      0, 255)
        gy = np.linspace(0, rng.integers(-40, 40), r)[:, None, None]
        gx = np.linspace(0, rng.integers(-40, 40), r)[None, :, None]
        img = np.clip(img + gy + gx, 0, 255).astype(np.uint8)
        write_image(os.path.join(args.output_dir, f"{i:04d}.png"), img)
    print(f"Wrote {args.num_images} style images to {args.output_dir}")


if __name__ == "__main__":
    main()
