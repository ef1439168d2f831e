"""Project real (style image, geometry) pairs into W+ / noise brush styles.

The port's counterpart of ``scripts/project_main.py``, with its flags plus
``--device``: samples patches of each artwork (``default_rng(seed)``, Otsu
foreground, foreground-centred tries), runs :func:`tools.projection.project`
for one target or :func:`~tools.projection.project_parallel` for several
(all styles in one pass per step), writes ``<style>.npz`` per style and
adds each style to the aggregate W library (``ALL_projected_styles.pkl``),
skipping styles already there with ``--skip_existing``.

    python3 -m brushstroke_engine_torch.tools.project_main \\
        --gan_checkpoint B.pkl --target_image a.png b.png --output_dir OUT

Targets are read as Pillow reads them (``utils/img_proc.py:read_image``):
any format Pillow opens where it is installed, else PNG of any kind but
interlaced.  Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle

import numpy as np

logger = logging.getLogger(__name__)


def read_rgb(path: str) -> np.ndarray:
    """An image file -> float ``[H, W, 3]`` in [0, 1], as the JAX CLI reads
    it: Pillow's ``convert("RGB")``."""
    from brushstroke_engine_torch.utils.img_proc import read_image
    return read_image(path, "RGB").astype(np.float32) / 255.0


def load_target_patches(image_path, patch_width, num_patches, seed,
                        fg_centered=True):
    """Sample square patches from a large artwork -> (targets ``[N, W, W,
    3]`` in [-1, 1], geometry ``[N, W, W, 1]``, 0 = FG)."""
    from brushstroke_engine_torch.utils.img_proc import threshold_otsu
    img = read_rgb(image_path)
    gray = img.mean(-1)
    fg_mask = gray <= threshold_otsu(gray)
    rng = np.random.default_rng(seed)
    targets, geoms = [], []
    h, w = img.shape[:2]
    for _ in range(num_patches):
        for _try in range(30):
            y = rng.integers(0, max(h - patch_width, 0) + 1)
            x = rng.integers(0, max(w - patch_width, 0) + 1)
            patch = img[y:y + patch_width, x:x + patch_width]
            mpatch = fg_mask[y:y + patch_width, x:x + patch_width]
            if not fg_centered or mpatch.mean() > 0.05:
                break
        targets.append(patch * 2 - 1)
        geoms.append(1.0 - mpatch.astype(np.float32))
    return np.stack(targets), np.stack(geoms)[..., None]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gan_checkpoint", required=True)
    ap.add_argument("--encoder_checkpoint", default=None)
    ap.add_argument("--target_image", required=True, nargs="+",
                    help="Artwork image(s) to project.")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--style_name", default=None)
    ap.add_argument("--num_steps", type=int, default=1000)
    ap.add_argument("--num_patches", type=int, default=4)
    ap.add_argument("--w_plus", type=int, default=1)
    ap.add_argument("--optimize_noise", type=int, default=1)
    ap.add_argument("--l1_fg_weight", type=float, default=0.0)
    ap.add_argument("--bg_weight", type=float, default=0.0)
    ap.add_argument("--with_composite", action="store_true")
    ap.add_argument("--regularize_noise_weight", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--library_name", default="ALL_projected_styles.pkl")
    ap.add_argument("--skip_existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu.")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from brushstroke_engine_torch.engine.brush import PaintEngineFactory
    from brushstroke_engine_torch.tools import projection

    engine = PaintEngineFactory.create(
        args.gan_checkpoint, encoder_checkpoint=args.encoder_checkpoint,
        device=args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    lib_path = os.path.join(args.output_dir, args.library_name)

    library = {}
    if os.path.isfile(lib_path):
        from brushstroke_engine_torch.engine.library import load_styles_pkl
        library = load_styles_pkl(lib_path)

    names = [args.style_name] if (args.style_name
                                  and len(args.target_image) == 1) else \
        [os.path.splitext(os.path.basename(p))[0]
         for p in args.target_image]
    jobs = [(nm, p) for nm, p in zip(names, args.target_image)
            if not (args.skip_existing and nm in library)]
    for nm in sorted(set(names) - {nm for nm, _ in jobs}):
        logger.info("Style %s already projected; skipping", nm)
    if not jobs:
        return {}

    cfg = projection.ProjectionConfig(
        num_steps=args.num_steps, w_plus=bool(args.w_plus),
        optimize_noise=bool(args.optimize_noise),
        l1_fg_weight=args.l1_fg_weight, bg_weight=args.bg_weight,
        with_composite=args.with_composite,
        regularize_noise_weight=args.regularize_noise_weight)

    pairs = [load_target_patches(p, engine.patch_width, args.num_patches,
                                 args.seed) for _, p in jobs]
    if len(jobs) == 1:
        results = [projection.project(engine, pairs[0][0], pairs[0][1], cfg,
                                      seed=args.seed)]
    else:
        # All styles in one pass over their rows per step.
        results = projection.project_parallel(
            engine, np.stack([t for t, _ in pairs]),
            np.stack([g for _, g in pairs]), cfg, seed=args.seed)

    for (style_name, _), result in zip(jobs, results):
        npz_path = os.path.join(args.output_dir, f"{style_name}.npz")
        np.savez(npz_path, w=result["w"], bg=result["bg"],
                 step=result["step"],
                 **{f"noise/{k}": v for k, v in result["noise"].items()})
        library[style_name] = {"w": result["w"], "noise": result["noise"]}
        print(f"Projected {style_name}: lpips {result['lpips']:.4f} "
              f"-> {npz_path}; library {lib_path}")
    with open(lib_path, "wb") as f:
        pickle.dump(library, f)
    return {nm: r for (nm, _), r in zip(jobs, results)}


if __name__ == "__main__":
    main()
