"""FID (and optionally precision / recall) between two image folders or
zips, each image cropped to ``--resolution``.

The port's counterpart of ``scripts/fid_from_images.py``, with its flags
plus ``--device``; used to hold stylization outputs against real media.

    python3 -m brushstroke_engine_torch.tools.fid_from_images \\
        --images0 real/ --images1 painted/ --pr

Runs on CUDA unless ``--device cpu``; returns ``{"fid", "detector"}`` and,
with ``--pr``, ``"precision"`` and ``"recall"``.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np


def batches_from_path(path, resolution, batch_size, max_items):
    from brushstroke_engine_torch.train.dataset import ImageFolderDataset
    ds = ImageFolderDataset(path, resolution, resize_mode="crop")
    n = min(len(ds), max_items) if max_items else len(ds)
    for i in range(0, n, batch_size):
        yield np.stack([ds[j] for j in range(i, min(i + batch_size, n))])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images0", required=True)
    ap.add_argument("--images1", required=True)
    ap.add_argument("--resolution", type=int, default=128)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--max_items", type=int, default=50000)
    ap.add_argument("--detector", default=None,
                    help="Path to real Inception-v3 detector weights; "
                         "defaults to NEUBE_FID_DETECTOR or the labeled "
                         "random fallback.")
    ap.add_argument("--pr", action="store_true",
                    help="Also report improved precision/recall "
                         "(Kynkaanniemi 2019, nhood_size=3).")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu.")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from brushstroke_engine_torch.metrics import fid as fid_lib
    from brushstroke_engine_torch.utils.util import resolve_device

    device = resolve_device(args.device)
    if args.detector:
        fid_lib.set_default_extractor(
            fid_lib.load_detector(args.detector, device=device))

    def batches(path):
        return batches_from_path(path, args.resolution, args.batch_size,
                                 args.max_items)

    fid = fid_lib.fid_from_image_iterables(
        batches(args.images0), batches(args.images1),
        max_items=args.max_items, device=device)
    out = {"fid": fid, "detector": fid_lib.default_detector_kind(device)}
    print(f"FID: {fid:.4f} (detector={out['detector']})")
    if args.pr:
        from brushstroke_engine_torch.metrics.pr import \
            compute_pr_from_images
        out["precision"], out["recall"] = compute_pr_from_images(
            batches(args.images0), batches(args.images1),
            max_items=args.max_items, device=device)
        print(f"precision: {out['precision']:.4f}")
        print(f"recall: {out['recall']:.4f}")
    return out


if __name__ == "__main__":
    main()
