"""3D RGB scatter of an image's colour distribution (host only).

The port's counterpart of ``scripts/plot_colors.py``, with its flags:
samples pixels with ``default_rng(seed)``, sizes each marker by how often
its pixel was drawn and plots it at its own colour in RGB space; useful when
choosing triad override colours for a style.  Writes a PNG beside the input
(``--show`` opens a window).  Needs matplotlib; the image is read through
``utils.img_proc.read_image(..., "RGB")``.

    python -m brushstroke_engine_torch.tools.plot_colors --image I.png
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def sample_colors(img: np.ndarray, samples: int, seed: int):
    """The sampled pixels' colours in [0, 1] (``[N, 3]``, one row per
    distinct pixel) and how often each was drawn, as the JAX script draws
    them."""
    flat = img.reshape(-1, 3)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, flat.shape[0], samples)
    uniq, counts = np.unique(idx, return_counts=True)
    return flat[uniq].astype(np.float32) / 255.0, counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", required=True)
    ap.add_argument("--samples", type=int, default=5000)
    ap.add_argument("--out", default=None,
                    help="Output PNG (default: <image>.colors.png).")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--show", action="store_true")
    args = ap.parse_args(argv)

    import matplotlib
    if not args.show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from brushstroke_engine_torch.utils.img_proc import read_image

    colors, counts = sample_colors(read_image(args.image, "RGB"),
                                   args.samples, args.seed)
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(colors[:, 0], colors[:, 1], colors[:, 2], c=colors,
               edgecolors="none", depthshade=False, s=5.0 * counts)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_zlim(0, 1)
    ax.set_xlabel("R")
    ax.set_ylabel("G")
    ax.set_zlabel("B")
    if args.show:
        plt.show()
        return None
    out = args.out or (os.path.splitext(args.image)[0] + ".colors.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"Wrote {out}")
    return out


if __name__ == "__main__":
    main()
