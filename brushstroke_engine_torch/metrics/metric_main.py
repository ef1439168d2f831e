"""Metric evaluation loops: per-style stroke metrics, stitching, FID.

Counterpart of ``brushstroke_engine_tpu/metrics/metric_main.py``: per style,
Lab color control, transparency, background uniformity, across-geometry
LPIPS and (with a stitcher) the stitching metrics; FID from real style
images against strokes painted in 'full' mode over dataset geometry.

Random draws: :func:`paint_engine_metric_loop` makes each batch's patch
corners and permutations in one place (:func:`metric_draws`) from a CPU
``torch.Generator`` seeded like the JAX package's key; its ``draws``
argument takes them from the caller instead.  The stitching metrics draw
the first crop from the stroke generator's ``RandomState`` (as the JAX
package), the second crop from a ``random.Random`` seeded like the loop
(the JAX package draws it from Python's unseeded global ``random``), and
the first crop's canvas positions from the loop's ``torch.Generator``; a
batch's draws may give ``"positions1"`` instead.
"""

from __future__ import annotations

import logging
import os
import pickle
import random
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from brushstroke_engine_torch.metrics import color as color_metric
from brushstroke_engine_torch.metrics import fid as fid_lib
from brushstroke_engine_torch.metrics import geom as geom_metric
from brushstroke_engine_torch.models.geo_encoder import geo_encoder_encode
from brushstroke_engine_torch.models.mapping import mapping_apply
from brushstroke_engine_torch.train.stitching import RandomStitcher

logger = logging.getLogger(__name__)


def update_sum_dict(total: Dict, new: Dict):
    for k, v in new.items():
        total[k] = total.get(k, 0.0) + float(v)


def normalize_sum_dict(total: Dict, denom: float):
    for k in total:
        total[k] = total[k] / denom


def to_file_line(values, do_strip=True) -> str:
    parts = []
    for v in values:
        parts.append("{:<15}".format(
            v if isinstance(v, str) else "%0.4f" % float(v)))
    return " ".join(parts).rstrip() + "\n" if do_strip else \
        " ".join(parts) + "\n"


def ordered_dict_values(d: Dict, keys):
    return [d[k] for k in keys]


def metric_draws(rng: torch.Generator, batch: int, width: int) -> Dict:
    """One batch's draws: the patch corners of the two background-uniformity
    metrics (``"bg_multicolor"``, ``"bg_same"`` with its permutation) and
    the across-geometry permutation (``"across_geo"``)."""
    pw = geom_metric.uniform_bg_patch_width(width)
    return {
        "bg_multicolor": geom_metric.uniform_bg_draws(
            rng, batch, width, width, pw, same_style=False),
        "bg_same": geom_metric.uniform_bg_draws(
            rng, batch, width, width, pw, same_style=True),
        "across_geo": geom_metric.across_geo_perm(rng, batch),
    }


def _stitch_for_style(generator, z, tri_batch, gic: int,
                      stitcher: RandomStitcher, crop_rng: random.Random,
                      pos_rng: Optional[torch.Generator],
                      draws: Optional[Dict] = None) -> Dict[str, float]:
    """The stitching render of one batch and its metrics ({} when the
    geometry is no wider than the patch)."""
    eng = generator.engine
    geom = np.asarray(tri_batch, np.float32) / 255.0
    geom = geom[..., gic:gic + 1]
    res_w = eng.patch_width
    h, w = geom.shape[1:3]
    if h <= res_w or w <= res_w:
        return {}
    draws = draws or {}
    rng = generator.random_state.rng
    y = int(rng.randint(0, h - res_w))
    x = int(rng.randint(0, w - res_w))
    crop1 = (y, x, res_w, res_w)
    crop2 = stitcher.gen_overlapping_square_crop(h, crop1, crop_rng)

    def encode(crop):
        g = geom[:, crop[0]:crop[0] + res_w, crop[1]:crop[1] + res_w]
        with torch.no_grad():
            return geo_encoder_encode(
                eng.enc_cfg, eng.enc_params, eng.enc_state,
                torch.as_tensor(np.ascontiguousarray(g), device=eng.device),
                res=list(eng.enc_res))

    w_avg = eng.gen_state.get("w_avg")
    if w_avg is None:
        w_avg = torch.zeros(eng.gen_cfg.w_dim, device=eng.device)
    with torch.no_grad():
        res = stitcher.generate_with_stitching(
            eng.gen_cfg, eng.gen_params,
            {"w_avg": w_avg, "noise": eng.gen_state["noise"]},
            torch.as_tensor(z, dtype=torch.float32, device=eng.device),
            encode(crop1), encode(crop2), crop1, crop2, pos_rng,
            positions1=draws.get("positions1"))
    return geom_metric.compute_stitching_metrics(res, stitcher.crop_margin)


def paint_engine_metric_loop(generator, style_library, nbatches_per_style,
                             fullres_geom_iterator=None,
                             stitcher: Optional[RandomStitcher] = None,
                             geom_input_channel: int = 1,
                             eval_output_dir: Optional[str] = None,
                             files_prefix: str = "",
                             draws: Optional[Iterable[Dict]] = None
                             ) -> Dict[str, float]:
    """Per-style metric loop; returns the metrics averaged over styles.
    ``draws``: per-batch :func:`metric_draws` dicts, in batch order (with a
    ``"stitch"`` dict of ``"positions1"`` where the stitching metrics
    run)."""
    generator.set_render_mode("clear")
    seed = generator.random_state.seed or 0
    rng = torch.Generator().manual_seed(seed)
    crop_rng = random.Random(seed)
    if draws is None:
        w = generator.engine.patch_width
        draws = iter(lambda: metric_draws(rng, generator.batch_size, w),
                     None)
    else:
        draws = iter(draws)
    style_ofile = summary_ofile = None
    if eval_output_dir is not None:
        os.makedirs(eval_output_dir, exist_ok=True)
        style_ofile = open(os.path.join(
            eval_output_dir, f"{files_prefix}style_metrics.txt"), "w")
        summary_ofile = open(os.path.join(
            eval_output_dir, f"{files_prefix}summary_metrics.txt"), "w")

    ordered_keys = None
    summary_losses: Dict[str, float] = {}
    style_ws = {}
    nprocessed = 0
    eng = generator.engine

    for style_id in style_library.get_style_ids():
        seed_str = "{:<15}".format(style_id)
        style_library.set_style(style_id, generator.brush_options)

        # Record the style's W for library export.
        opts = generator.brush_options
        if opts.style_ws is not None:
            style_ws[seed_str] = np.asarray(opts.style_ws)
        elif opts.style_z is not None:
            ws = mapping_apply(
                eng.gen_cfg.mapping, eng.gen_params["mapping"],
                torch.as_tensor(np.asarray(opts.style_z, np.float32),
                                device=eng.device),
                w_avg=eng.gen_state.get("w_avg"))
            style_ws[seed_str] = ws.cpu().numpy()

        style_losses: Dict[str, float] = {}
        for _ in range(nbatches_per_style):
            d = next(draws)
            colors = generator.random_colors()
            generator.set_new_geom()
            generator.set_new_primary_color(colors)
            render = generator.generate()
            geom = torch.as_tensor(generator.geom, device=render.device)

            batch_losses = color_metric.compute_lab_metrics(
                colors, render, geom)
            batch_losses.update(
                geom_metric.compute_transparency_metrics(render, geom))
            batch_losses.update(geom_metric.compute_uniform_bg_lpips_metric(
                render, geom, same_style=False, draws=d["bg_multicolor"],
                key_suffix="multicolor"))

            generator.unset_colors()
            render = generator.generate()
            batch_losses.update(geom_metric.compute_uniform_bg_lpips_metric(
                render, geom, same_style=True, draws=d["bg_same"]))
            batch_losses.update(geom_metric.compute_lpips_across_geo(
                render, perm=d["across_geo"]))

            if stitcher is not None and fullres_geom_iterator is not None \
                    and generator.current_styles() is not None:
                tri = next(fullres_geom_iterator)
                z = generator.current_styles()[:tri.shape[0]]
                if z.shape[0] == tri.shape[0]:
                    batch_losses.update(_stitch_for_style(
                        generator, z, tri, geom_input_channel, stitcher,
                        crop_rng, rng, d.get("stitch")))
            update_sum_dict(style_losses, batch_losses)

        if ordered_keys is None:
            ordered_keys = sorted(style_losses.keys())
            header = "SEED            " + to_file_line(ordered_keys)
            if style_ofile:
                style_ofile.write(header)
            if summary_ofile:
                summary_ofile.write(to_file_line(ordered_keys))

        normalize_sum_dict(style_losses, float(nbatches_per_style))
        update_sum_dict(summary_losses, style_losses)
        line = seed_str + " " + to_file_line(
            ordered_dict_values(style_losses, ordered_keys), do_strip=False)
        if style_ofile:
            style_ofile.write(line)
            style_ofile.flush()
        logger.debug("%d: %s", nprocessed, line.strip())
        nprocessed += 1

    normalize_sum_dict(summary_losses, float(max(nprocessed, 1)))
    if style_ofile:
        style_ofile.close()
    if summary_ofile:
        summary_ofile.write(to_file_line(
            ordered_dict_values(summary_losses, ordered_keys or []),
            do_strip=False))
        summary_ofile.close()
    if eval_output_dir is not None:
        with open(os.path.join(eval_output_dir,
                               f"{files_prefix}style_ws.pkl"), "wb") as f:
            pickle.dump(style_ws, f)
    return summary_losses


def stitching_metric_loop(generator, fullres_geom_iterator, num_batches,
                          stitcher: Optional[RandomStitcher] = None,
                          geom_input_channel: int = 1,
                          draws: Optional[Iterable[Dict]] = None
                          ) -> Dict[str, float]:
    """Stitching metrics over ``num_batches`` full-resolution geometry
    batches (reference metric_main.py:75-103); ``draws``: per-batch dicts
    of ``"positions1"``."""
    stitcher = stitcher or RandomStitcher()
    seed = generator.random_state.seed or 0
    pos_rng = torch.Generator().manual_seed(seed)
    crop_rng = random.Random(seed)
    draws = iter(draws) if draws is not None else None
    summary: Dict[str, float] = {}
    n = 0
    for _ in range(num_batches):
        tri = next(fullres_geom_iterator)
        z = generator.random_state.rng.randn(
            tri.shape[0], generator.engine.gen_cfg.z_dim).astype(np.float32)
        losses = _stitch_for_style(
            generator, z, tri, geom_input_channel, stitcher, crop_rng,
            pos_rng, next(draws) if draws is not None else None)
        if losses:
            update_sum_dict(summary, losses)
            n += 1
    normalize_sum_dict(summary, float(max(n, 1)))
    return summary


def forger_compute_fid(generator, real_batches: Iterable,
                       num_items: int = 50000,
                       fade_canvas: bool = False) -> float:
    """FID between real style images and strokes painted in 'full' mode
    ('fadecanvas' composites over a blurred copy of the stroke)."""
    generator.set_render_mode("full")
    device = generator.engine.device
    stats_real = fid_lib.FeatureStats(num_items)
    stats_gen = fid_lib.FeatureStats(num_items)

    for batch in real_batches:
        stats_real.append(fid_lib.extract_features(batch, device=device))
        if stats_real.is_full:
            break

    while not stats_gen.is_full:
        generator.set_new_geom()
        generator.set_new_styles(generator.get_random_styles())
        generator.set_random_colors()
        render = generator.generate()
        rgb = render[..., :3]
        if fade_canvas:
            blur = geom_metric.gaussian_smoothing(rgb)
            alpha = render[..., 3:4]
            rgb = alpha * rgb + (1 - alpha) * blur
        img = (rgb * 255).clamp(0, 255).to(torch.uint8)
        stats_gen.append(fid_lib.extract_features(img, device=device))

    return fid_lib.compute_fid_from_feature_stats(stats_real, stats_gen)


def summary_losses_to_file(fname, losses, step=None, do_print=False):
    """Append a metrics line (with a header line when the file is new)."""
    ordered_keys = sorted(losses.keys())
    exists = os.path.isfile(fname)
    with open(fname, "a") as f:
        if not exists:
            head = ("STEP " if step is not None else "") + \
                to_file_line(ordered_keys)
            f.write(head)
        line = (("%d " % step) if step is not None else "") + to_file_line(
            ordered_dict_values(losses, ordered_keys), do_strip=False)
        f.write(line)
    if do_print:
        print(line.strip())
