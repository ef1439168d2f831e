"""Diagnose the LAB_E% colour-control of trained snapshots.

The port's counterpart of ``scripts/diagnose_color_control.py``: for each
snapshot it reports, over geometry-foreground and background pixels, how
much softmax mass each of U / V / S carries, the learned per-channel
colours, and LAB_E% under (a) the primary-only override (what the metric
loop and the UI do) and (b) an override of both stroke channels (U and V).
If (b) collapses LAB_E% while (a) fails, the stroke interior has moved into
the secondary channel V.  It writes two sheets per snapshot
(``override_ab_<tag>.png``: a row per override; ``uvs_<tag>.png``: geometry
| U | V | S | composite of the first style) and ``report.json``.

    python -m brushstroke_engine_torch.tools.diagnose_color_control \\
        SNAPSHOT [SNAPSHOT ...] --out D [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

SWEEP = np.asarray([
    [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
    [1.0, 1.0, 0.0], [1.0, 0.0, 1.0],
], np.float32)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def render(engine, z, geom, color0=None, color1=None):
    from brushstroke_engine_torch.engine.brush import GanBrushOptions
    opts = GanBrushOptions()
    opts.set_style(np.asarray(z, np.float32))
    if color0 is not None:
        opts.set_color(0, np.asarray(color0 * 255, np.uint8))
    if color1 is not None:
        opts.set_color(1, np.asarray(color1 * 255, np.uint8))
    return engine._run_core(np.asarray(geom, np.float32), opts)


def lab_e(colors, out, geom):
    from brushstroke_engine_torch.metrics import color as color_metric
    rgba = out["rgba"]
    m = color_metric.compute_lab_metrics(
        colors, rgba, torch.as_tensor(geom, device=rgba.device))
    return m["LAB_E%"], m["LAB_L2"]


def diagnose(path, out_dir, n_styles=8, seed=0, device="cuda", raw=None):
    """The report of one snapshot (values rounded as the JAX script rounds
    them); ``raw``, a dict, receives the unrounded FG / BG masses and LAB_E%
    values."""
    from brushstroke_engine_torch.engine.brush import PaintEngineFactory
    from brushstroke_engine_torch.viz.visualize import (
        MAPPER_SHAPES, curated_geometry_batch, save_image, to_uint8,
    )
    engine = PaintEngineFactory.create(path, device=device)
    engine.set_render_mode("clear")
    rng = np.random.RandomState(seed)
    z = rng.randn(n_styles, engine.gen_cfg.z_dim).astype(np.float32)
    geom = curated_geometry_batch(MAPPER_SHAPES, radius=16,
                                  width=engine.patch_width)[..., None]
    geom = np.asarray(geom[:n_styles], np.float32)
    n = min(n_styles, geom.shape[0])
    z, geom = z[:n], geom[:n]

    # 1) Channel attribution: softmax mass per channel over geometry FG/BG.
    out = render(engine, z, geom)
    uvs = _np(out["uvs"])                               # [B, H, W, 3]
    fg = 1.0 - geom[..., 0]                             # 1 = stroke FG
    bg = geom[..., 0]
    fg_mass = (uvs * fg[..., None]).sum((0, 1, 2)) / max(fg.sum(), 1)
    bg_mass = (uvs * bg[..., None]).sum((0, 1, 2)) / max(bg.sum(), 1)
    learned_colors = _np(out["colors"])                 # [B, 3(rgb), 3(uvs)]

    # The tag carries the run directory: snapshot names repeat across runs.
    run = os.path.basename(os.path.dirname(os.path.dirname(path))) or "run"
    tag = run + "_" + os.path.basename(path).replace(".pkl", "")
    report = {
        "snapshot": path,
        "fg_mass_uvs": [round(float(x), 4) for x in fg_mass],
        "bg_mass_uvs": [round(float(x), 4) for x in bg_mass],
        "mean_learned_colors_rgb_per_channel":
            [[round(float(c), 3) for c in learned_colors[:, :, k].mean(0)]
             for k in range(3)],
    }

    # 2) The LAB_E sweep: primary-only override against U+V override.
    rows_primary, rows_both = [], []
    e_primary, e_both = [], []
    for c in SWEEP:
        cb = np.tile(c[None], (n, 1))
        o1 = render(engine, z, geom, color0=c)
        e1, _ = lab_e(cb, o1, geom)
        o2 = render(engine, z, geom, color0=c, color1=c)
        e2, _ = lab_e(cb, o2, geom)
        e_primary.append(e1)
        e_both.append(e2)
        rows_primary.append(_np(o1["rgba"])[0, ..., :3])
        rows_both.append(_np(o2["rgba"])[0, ..., :3])
    if raw is not None:
        raw.update(fg_mass_uvs=fg_mass, bg_mass_uvs=bg_mass,
                   lab_e_primary_only=e_primary,
                   lab_e_primary_and_secondary=e_both)
    report["lab_e_primary_only"] = round(float(np.mean(e_primary)), 2)
    report["lab_e_primary_and_secondary"] = round(float(np.mean(e_both)), 2)

    os.makedirs(out_dir, exist_ok=True)
    sheet = np.concatenate(
        [np.concatenate(rows_primary, axis=1),
         np.concatenate(rows_both, axis=1)], axis=0)
    save_image(os.path.join(out_dir, f"override_ab_{tag}.png"),
               to_uint8(sheet))

    # 3) The UVS panel of the first style (geom | U | V | S | composite).
    panels = [np.tile(geom[:1], (1, 1, 1, 3))]
    for k in range(3):
        panels.append(np.tile(uvs[:1, ..., k:k + 1], (1, 1, 1, 3)))
    panels.append(_np(out["rgba"])[:1, ..., :3])
    save_image(os.path.join(out_dir, f"uvs_{tag}.png"),
               to_uint8(np.concatenate([p[0] for p in panels], axis=1)))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("snapshots", nargs="+")
    ap.add_argument("--out", default="docs/evidence/r5_color_diag")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    reports = [diagnose(p, args.out, device=args.device)
               for p in args.snapshots]
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(reports, f, indent=2)
    for r in reports:
        print(json.dumps(r, indent=2))
    return reports


if __name__ == "__main__":
    main()
