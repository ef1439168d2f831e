"""Install pretrained weights from local files, verified.

The port's counterpart of ``scripts/fetch_and_verify_weights.py`` for local
files: each family given is read by the port's own loader and run once --
Inception-v3 (``metrics/fid.load_detector``, 2048-d pool features), LPIPS
(``metrics/lpips.LPIPSModel.from_torch_state``, d(x, x) = 0 < d(x, y)),
VGG16 (``metrics/pr.VGG16Features.from_torch_state``), CLIP
(``tools/clip_model.load_openai_clip``, an image and a text embedding) --
and a ``--reference_pkl`` snapshot is loaded by ``load_engine_bundle`` and
renders one stroke (verified and digested, not installed).  ``--expect
FAMILY=SHA256`` pins a digest; a mismatch fails before anything is
installed.  When every family passes, the files are copied into
``$NEUBE_WEIGHTS_DIR`` (default ``weights/`` at the repository root, or
``--weights_dir``), their sha256 merged into ``manifest.json``, and the
default detectors' kinds printed before and after (they flip from the
labelled random fallbacks to the real detectors).

Paths only: nothing is fetched, and a URL is refused.  Files are read with
``torch.load(weights_only=True)`` or, for a TorchScript archive,
``torch.jit.load``, so no code of the file runs.

    python -m brushstroke_engine_torch.tools.fetch_and_verify_weights \\
        --inception inception.pt --lpips lpips_alex.pth --vgg16 vgg16.pth \\
        --clip ViT-B-32.pt --clip_bpe bpe_simple_vocab_16e6.txt.gz \\
        [--reference_pkl network-snapshot.pkl] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

FAMILIES = ("inception", "lpips", "vgg16", "clip", "clip_bpe")


def _host(x) -> np.ndarray:
    """A device tensor's values on the host."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


def _local(src: str) -> str:
    if "://" in src:
        raise SystemExit(
            f"{src}: this tool installs local files only and fetches "
            f"nothing; download the file and pass its path")
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    return src


def _verify_inception(path: str, device) -> str:
    from brushstroke_engine_torch.metrics import fid, inception
    det = fid.load_detector(path, device=device)
    assert det.kind == "inception_v3", det.kind
    assert det.param_count() == inception.PARAM_COUNT, \
        (det.param_count(), inception.PARAM_COUNT)
    img = (np.random.RandomState(0).rand(2, 64, 64, 3) * 255).astype(np.uint8)
    feats = _host(fid.extract_features(img, det, device=device))
    assert feats.shape == (2, 2048) and np.isfinite(feats).all()
    return f"kind={det.kind} pool=2048 finite"


def _verify_lpips(path: str, device) -> str:
    import torch
    from brushstroke_engine_torch.metrics import lpips
    from brushstroke_engine_torch.utils.weights import load_state_dict
    model = lpips.LPIPSModel.from_torch_state(
        {k: v.numpy() for k, v in load_state_dict(path).items()},
        device=device)
    rng = np.random.RandomState(1)
    x, y = (torch.as_tensor(rng.rand(1, 64, 64, 3).astype(np.float32) * 2
                            - 1, device=model.device) for _ in range(2))
    same = float(lpips.lpips_pair(x, x, model)[0])
    diff = float(lpips.lpips_pair(x, y, model)[0])
    assert abs(same) < 1e-6 and np.isfinite(diff) and diff > 0, (same, diff)
    return f"d(x,x)={same:.1e} d(x,y)={diff:.4f}"


def _verify_vgg16(path: str, device) -> str:
    from brushstroke_engine_torch.metrics import pr
    from brushstroke_engine_torch.utils.weights import load_state_dict
    vgg = pr.VGG16Features.from_torch_state(load_state_dict(path))
    assert vgg.kind == "vgg16", vgg.kind
    img = (np.random.RandomState(2).rand(2, 224, 224, 3) * 255)
    feats = _host(pr.vgg16_extract_features(img.astype(np.uint8), vgg,
                                            device=device))
    assert feats.shape[0] == 2 and np.isfinite(feats).all()
    return f"kind={vgg.kind} feat_dim={feats.shape[1]}"


def _verify_clip(path: str, bpe_path, device) -> str:
    import torch
    from brushstroke_engine_torch.tools import clip_model as cm
    cfg, params, tokenizer = cm.load_openai_clip(path, bpe_path,
                                                 device=device)
    img = torch.as_tensor(np.random.RandomState(3).rand(
        1, 224, 224, 3).astype(np.float32),
        device=params["visual"]["conv"].device)
    ie = _host(cm.encode_image(cfg, params, img))
    if tokenizer is None:
        return f"embed_dim={cfg.embed_dim} (no --clip_bpe: image tower only)"
    te = _host(cm.encode_text(cfg, params, tokenizer(
        ["a painted brush stroke"])))
    assert ie.shape[-1] == cfg.embed_dim == te.shape[-1]
    sim = float((ie @ te.T).ravel()[0] /
                (np.linalg.norm(ie) * np.linalg.norm(te)))
    assert np.isfinite(sim)
    return f"embed_dim={cfg.embed_dim} cos(img,text)={sim:.3f}"


def _verify_reference_pkl(path: str, device) -> str:
    from brushstroke_engine_torch.engine.brush import (
        CanvasPaintEngine, GanBrushOptions, TriadGanPaintEngine,
    )
    from brushstroke_engine_torch.utils.checkpoint import load_engine_bundle
    bundle = load_engine_bundle(path, device=device)
    cls = TriadGanPaintEngine if bundle.color_format == "triad" \
        else CanvasPaintEngine
    eng = cls(bundle.gen_cfg, bundle.gen_params, bundle.gen_state,
              bundle.enc_cfg, bundle.enc_params, bundle.enc_state,
              geom_inject_resolutions=bundle.geom_inject_resolutions,
              device=device)
    w = eng.patch_width
    patch = np.zeros((w, w, 4), np.uint8)
    patch[w // 4:-w // 4, w // 4:-w // 4, 3] = 255
    opts = GanBrushOptions()
    opts.set_style(np.random.RandomState(0).randn(
        1, bundle.gen_cfg.z_dim).astype(np.float32))
    img, _ = eng.render_stroke(patch, None, opts)
    assert img.shape == (w, w, 4) and img.dtype == np.uint8
    return f"res={w} color_format={bundle.color_format} render ok"


def kind_probe(which: str, device, fresh: bool = False) -> str:
    """The default detector's kind (``fresh`` drops the cached defaults so
    the probe sees what was just installed)."""
    try:
        if which == "fid":
            from brushstroke_engine_torch.metrics import fid
            if fresh:
                fid._DEFAULTS.clear()
            return fid.default_detector_kind(device)
        if which == "lpips":
            from brushstroke_engine_torch.metrics import lpips
            if fresh:
                lpips._DEFAULT_MODELS.clear()
            return lpips.get_default_model(device).kind
        if which == "clip":
            from brushstroke_engine_torch.tools import clip_search
            return type(clip_search.default_backbone(device)).__name__
    except Exception as e:  # the report is best effort
        return f"probe-failed: {e}"
    return "?"


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    for fam in FAMILIES:
        ap.add_argument(f"--{fam}", default=None,
                        help=f"Path of the {fam} weights")
    ap.add_argument("--reference_pkl", default=None,
                    help="Reference training snapshot to convert and "
                         "verify (digested, not installed)")
    ap.add_argument("--expect", action="append", default=[],
                    metavar="FAMILY=SHA256",
                    help="Pin an expected sha256 digest (repeatable)")
    ap.add_argument("--weights_dir", default=None,
                    help="Install here (default: $NEUBE_WEIGHTS_DIR or "
                         "weights/ at the repository root)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from brushstroke_engine_torch.utils import weights as W
    from brushstroke_engine_torch.utils.util import resolve_device
    device = resolve_device(args.device)
    if args.weights_dir:
        os.environ["NEUBE_WEIGHTS_DIR"] = args.weights_dir
    expect = dict(e.split("=", 1) for e in args.expect)
    requested = {fam: getattr(args, fam) for fam in FAMILIES
                 if getattr(args, fam)}
    if not requested and not args.reference_pkl:
        ap.error("nothing to do: pass at least one weights file")
    for src in list(requested.values()) + [args.reference_pkl]:
        if src:
            _local(src)

    probes = ("fid", "lpips", "clip")
    before = {k: kind_probe(k, device) for k in probes}
    failures, staged = [], {}
    for fam, src in requested.items():
        print(f"[{fam}] verifying {src}")
        try:
            digest = W.sha256_file(src)
            if fam in expect and expect[fam].lower() != digest:
                raise RuntimeError(
                    f"sha256 mismatch: expected {expect[fam]}, got {digest}")
            if fam == "inception":
                note = _verify_inception(src, device)
            elif fam == "lpips":
                note = _verify_lpips(src, device)
            elif fam == "vgg16":
                note = _verify_vgg16(src, device)
            elif fam == "clip":
                note = _verify_clip(src, requested.get("clip_bpe"), device)
            else:   # clip_bpe: checked through the tokenizer with --clip
                note = "bpe vocab staged (validated with --clip)"
            staged[fam] = (src, digest, note)
            print(f"[{fam}] VERIFIED {note} sha256={digest[:16]}...")
        except Exception as e:
            failures.append((fam, str(e)))
            print(f"[{fam}] FAILED: {e}")

    if args.reference_pkl:
        try:
            note = _verify_reference_pkl(args.reference_pkl, device)
            print(f"[reference_pkl] VERIFIED {note} "
                  f"sha256={W.sha256_file(args.reference_pkl)[:16]}...")
        except Exception as e:
            failures.append(("reference_pkl", str(e)))
            print(f"[reference_pkl] FAILED: {e}")

    if failures:
        print("\nNOT installing; fix these first:")
        for fam, msg in failures:
            print(f"  {fam}: {msg}")
        return 1

    manifest = {}
    os.makedirs(W.weights_dir(), exist_ok=True)
    for fam, (src, digest, note) in staged.items():
        dst = os.path.join(W.weights_dir(), W.CANONICAL[fam][0])
        if os.path.abspath(src) != os.path.abspath(dst):
            shutil.copy2(src, dst)
        manifest[fam] = {"file": W.CANONICAL[fam][0], "sha256": digest,
                         "verified": note}
    if manifest:
        mpath = W.write_manifest(manifest)
        print(f"\nInstalled {len(manifest)} weight file(s) into "
              f"{W.weights_dir()}; manifest: {mpath}")
    after = {k: kind_probe(k, device, fresh=True) for k in probes}
    print("Detector kinds (before -> after):")
    for k in probes:
        print(f"  {k}: {before[k]} -> {after[k]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
