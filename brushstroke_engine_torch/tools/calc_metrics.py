"""Metric-zoo evaluation of a snapshot: fid / fid_fadecanvas / kid / is /
pr / ppl_w / ppl_z.

The port's counterpart of ``scripts/calc_metrics.py``, with its flags plus
``--device``: real statistics from a style image folder or zip, generated
ones by painting random styles over geometry (the dataset's, or synthetic
spline strokes at the patch width + 64) in 'full' render mode.

    python3 -m brushstroke_engine_torch.tools.calc_metrics \\
        --gan_checkpoint bundle.pkl --data styles/ --metrics fid,kid,pr

``--manifest metrics_manifest.json`` pins the protocol (metrics, item
count, batch, seed, detector kind): a conflicting flag or another detector
kind is an error, and the output's ``vs_recorded`` holds each value minus
the manifest's recorded one (the JAX package's numbers, taken on a TPU).
Prints one JSON line (each value, the detector kind and the seconds of each
step) and writes it to ``--out``.  Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np

logger = logging.getLogger(__name__)

METRICS = ("fid", "fid_fadecanvas", "kid", "is", "pr", "ppl", "ppl_w",
           "ppl_z")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gan_checkpoint", required=True)
    ap.add_argument("--encoder_checkpoint", default=None)
    ap.add_argument("--data", default=None,
                    help="Style image dataset (dir or zip) for real stats; "
                         "required for fid/kid/pr.")
    ap.add_argument("--geom_data", default=None,
                    help="Triband geometry dataset; synthetic if omitted.")
    ap.add_argument("--metrics", default="fid,kid,is,pr,ppl",
                    help="CSV subset of: fid, fid_fadecanvas, kid, is, pr, "
                         "ppl_w, ppl_z.")
    ap.add_argument("--num_items", type=int, default=2000,
                    help="Real/generated sample budget per metric.")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="Optional JSON output path.")
    ap.add_argument("--manifest", default=None,
                    help="A pinned protocol (metrics_manifest.json): its "
                         "metrics, num_items, batch, seed and detector kind "
                         "are used and checked; prints the deltas against "
                         "its recorded values.")
    ap.add_argument("--detector", default=None,
                    help="Path to real Inception-v3 detector weights "
                         "(torchvision or reference-TorchScript state_dict); "
                         "defaults to NEUBE_FID_DETECTOR or the labeled "
                         "random fallback.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu.")
    return ap


def apply_manifest(ap, args):
    """Protocol parameters from the manifest; an explicitly passed
    conflicting value is an error.  Returns the manifest."""
    with open(args.manifest) as f:
        manifest = json.load(f)
    proto = manifest["protocol"]
    for flag, key in (("metrics", "metrics"), ("num_items", "num_items"),
                      ("batch_size", "batch_size"), ("seed", "seed")):
        want = proto[key]
        got = getattr(args, flag)
        if got != ap.get_default(flag) and got != want:
            ap.error(f"--{flag}={got!r} conflicts with the manifest's "
                     f"pinned {key}={want!r}")
        setattr(args, flag, want)
    return manifest


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    manifest = apply_manifest(ap, args) if args.manifest else None
    metrics = [m.strip() for m in args.metrics.split(",") if m.strip()]
    for m in metrics:
        if m not in METRICS:
            raise ValueError(f"unknown metric {m!r}")

    import torch
    from brushstroke_engine_torch.metrics import fid as fid_lib
    from brushstroke_engine_torch.metrics.metric_main import \
        forger_compute_fid
    from brushstroke_engine_torch.metrics.stroke_generator import (
        PaintStrokeGenerator, RandomState,
    )
    from brushstroke_engine_torch.train.dataset import (
        BatchIterator, ImageFolderDataset, SyntheticGeometryDataset,
    )

    device = args.device
    if args.detector:
        fid_lib.set_default_extractor(
            fid_lib.load_detector(args.detector, device=device))
    gen = PaintStrokeGenerator.create(
        args.encoder_checkpoint, args.gan_checkpoint, args.batch_size,
        random_state=RandomState(args.seed), device=device)
    eng = gen.engine
    res = eng.patch_width
    if args.geom_data:
        geom_ds = ImageFolderDataset(args.geom_data, res + 64, channels=3)
    else:
        geom_ds = SyntheticGeometryDataset(res + 64)
    geom_iter = BatchIterator(geom_ds, args.batch_size, seed=args.seed)
    gen.set_geometry_source_from_iterator(geom_iter, args.batch_size)

    def real_batches():
        if not args.data:
            raise ValueError("--data is required for real-statistics "
                             "metrics")
        ds = ImageFolderDataset(args.data, res, resize_mode="crop")
        n = min(len(ds), args.num_items)
        for i in range(0, n, args.batch_size):
            yield np.stack([ds[j]
                            for j in range(i, min(i + args.batch_size, n))])

    def gen_images(n):
        gen.set_render_mode("full")
        out, total = [], 0
        while total < n:
            gen.set_new_geom()
            gen.set_new_styles(gen.get_random_styles())
            gen.set_random_colors()
            rgb = gen.generate()[..., :3]
            out.append((rgb * 255).clamp(0, 255).to(torch.uint8)
                       .cpu().numpy())
            total += len(out[-1])
        return np.concatenate(out)[:n]

    def features(batches):
        return np.concatenate([
            fid_lib.extract_features(b, device=device).cpu().numpy()
            for b in batches])

    seconds = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        value = fn()
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        seconds[key] = time.perf_counter() - t0
        return value

    results = {}
    real_feats = gen_feats = None
    if {"kid", "is", "pr"} & set(metrics):
        imgs = timed("gen_images", lambda: gen_images(args.num_items))
        gen_feats = timed("gen_features", lambda: features(
            imgs[i:i + args.batch_size]
            for i in range(0, len(imgs), args.batch_size)))
        if {"kid", "pr"} & set(metrics):
            real_feats = timed("real_features",
                               lambda: features(real_batches()))

    for m in metrics:
        if m in ("fid", "fid_fadecanvas"):
            results[m] = timed(m, lambda: forger_compute_fid(
                gen, real_batches(), num_items=args.num_items,
                fade_canvas=m == "fid_fadecanvas"))
        elif m == "kid":
            results[m] = timed(m, lambda: fid_lib.kernel_inception_distance(
                real_feats, gen_feats, seed=args.seed))
        elif m == "is":
            results[m] = timed(m, lambda: fid_lib.inception_score(gen_feats))
        elif m == "pr":
            from brushstroke_engine_torch.metrics.pr import compute_pr
            p, r = timed(m, lambda: compute_pr(real_feats, gen_feats,
                                               device=device))
            results["precision"] = p
            results["recall"] = r
        else:
            from brushstroke_engine_torch.metrics.ppl import compute_ppl
            from brushstroke_engine_torch.models.geo_encoder import \
                geo_encoder_encode
            geom = next(geom_iter)
            g = (np.asarray(geom, np.float32) / 255.0)[:1, :res, :res, 1:2]
            with torch.no_grad():
                feats = geo_encoder_encode(
                    eng.enc_cfg, eng.enc_params, eng.enc_state,
                    torch.as_tensor(np.ascontiguousarray(g),
                                    device=eng.device),
                    res=list(eng.enc_res))
            results[m] = timed(m, lambda: compute_ppl(
                eng, feats, num_samples=min(args.num_items, 256),
                space="z" if m == "ppl_z" else "w",
                batch=args.batch_size, seed=args.seed))
        logger.info("%s computed in %.2f s", m, seconds[m])

    out = {k: round(float(v), 6) for k, v in results.items()}
    # Random-detector values serve regression tracking within this code
    # base; they are not comparable to published (pretrained) numbers.
    out["detector"] = fid_lib.default_detector_kind(device)
    out["seconds"] = seconds
    if manifest is not None:
        want_det = manifest["protocol"].get("detector")
        if want_det and out["detector"] != want_det:
            raise SystemExit(
                f"detector kind {out['detector']!r} does not match the "
                f"manifest's pinned {want_det!r}; the numbers would not be "
                "comparable to the recorded yardstick")
        recorded = manifest.get("recorded", {})
        out["vs_recorded"] = {
            k: round(float(out[k]) - float(v), 6)
            for k, v in recorded.items()
            if k in out and isinstance(v, (int, float))}
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
