"""Random spline stroke patches: the geometry of the training data.

The port's counterpart of ``scripts/create_splines.py``, with its flags:
centripetal Catmull-Rom splines with a sampled thickness, drawn by the
native rasterizer (``data/curves.py:draw_stroke``), written as black-on-white
8-bit gray PNGs ``spline_{idx:06d}_rad{radius:03d}.png``.  Image ``idx``
comes from ``default_rng(seed * 1000003 + idx)``, so it is the JAX script's
whatever the number of workers.  Host only: numpy and ``utils/img_proc.py``
(Pillow where it is installed, else its own PNG writer).

    python3 -m brushstroke_engine_torch.tools.create_splines \\
        --output_dir splines --num_images 1000 --width 192 --seed 0
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing
import os

import numpy as np


def render_one(task) -> str:
    """Draw and write spline ``idx`` of ``task``; returns its path."""
    from brushstroke_engine_torch.data.curves import (
        random_spline_stroke, sample_radius,
    )
    from brushstroke_engine_torch.utils.img_proc import write_image
    idx, width, out_dir, seed, min_radius, max_radius = task
    rng = np.random.default_rng(seed * 1000003 + idx)
    radius = sample_radius(rng, min_radius, max_radius)
    stroke = random_spline_stroke(rng, width, radius=radius)
    path = os.path.join(out_dir, f"spline_{idx:06d}_rad{int(radius):03d}.png")
    write_image(path, (stroke * 255).astype(np.uint8))
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--num_images", type=int, default=1000)
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--min_radius", type=float, default=1.0)
    ap.add_argument("--max_radius", type=float, default=26.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    os.makedirs(args.output_dir, exist_ok=True)
    tasks = [(i, args.width, args.output_dir, args.seed, args.min_radius,
              args.max_radius) for i in range(args.num_images)]
    if args.workers > 1:
        # Spawned workers start from a fresh import: no state of the
        # caller (threads, torch) is forked into them.
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.workers) as pool:
            for i, _ in enumerate(pool.imap_unordered(render_one, tasks)):
                if i % 100 == 0:
                    print(f"{i}/{len(tasks)}")
    else:
        for t in tasks:
            render_one(t)
    print(f"Wrote {args.num_images} spline patches to {args.output_dir}")


if __name__ == "__main__":
    main()
