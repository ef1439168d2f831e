"""Tick-time evaluation hooks: visual diagnostics, the metric suite, FID.

Counterpart of ``brushstroke_engine_tpu/train/eval_hooks.py``: the
``TrainingVisualizer`` sheets every ``image_snapshot_ticks`` ticks, and at
every ``metric_snapshot_ticks``-th snapshot the forger metric loop and FID
(when real style batches are given), appended to
``run_dir/summary_metrics.txt``.  A hook that raises is logged and counted
in ``loop.hook_failure_counts``, which the loop reports as
``Eval/<name>_failures``; training goes on.
"""

from __future__ import annotations

import logging
import os
from typing import Iterable, Optional

import numpy as np

from brushstroke_engine_torch.train.loop import LoopHooks

logger = logging.getLogger(__name__)


def _engine_from_loop(loop):
    """An in-memory paint engine over the loop's current G_ema, on the
    loop's device (it holds the loop's tensors; training steps make new
    ones, so later steps do not change it)."""
    from brushstroke_engine_torch.engine.brush import (
        CanvasPaintEngine, TriadGanPaintEngine,
    )
    cfg = loop.cfg
    cls = TriadGanPaintEngine \
        if cfg.gen_cfg.synthesis.color_format == "triad" \
        else CanvasPaintEngine
    return cls(cfg.gen_cfg, loop.state["g_ema"],
               {"w_avg": loop.state["w_avg"], "noise": loop.state["noise"]},
               cfg.enc_cfg, loop.enc_params, loop.enc_state,
               geom_inject_resolutions=cfg.enc_res, device=loop.device)


def _count_failure(loop, name, err):
    loop.hook_failure_counts[name] = loop.hook_failure_counts.get(name, 0) + 1
    logger.exception("%s tick failed: %s", name, err)


def make_eval_hooks(image_snapshot_ticks: int = 1,
                    metric_snapshot_ticks: Optional[int] = None,
                    num_metric_styles: int = 8,
                    metric_batch_size: int = 4,
                    fid_real_batches: Optional[Iterable] = None,
                    fid_items: int = 256,
                    geom_iterator=None,
                    metrics=("forger",)) -> LoopHooks:
    """LoopHooks running the visualizer every ``image_snapshot_ticks``
    ticks and the metric suite every ``metric_snapshot_ticks`` ticks."""
    from brushstroke_engine_torch.viz.visualize import TrainingVisualizer

    state = {"viz": None}

    def on_tick(loop, stats):
        if image_snapshot_ticks and loop.cur_tick % image_snapshot_ticks == 0:
            try:
                engine = _engine_from_loop(loop)
                if state["viz"] is None:
                    state["viz"] = TrainingVisualizer(
                        batch_size=metric_batch_size,
                        width=loop.cfg.gen_cfg.img_resolution)
                    state["viz"].init(loop.cfg.gen_cfg.z_dim)
                viz_dir = os.path.join(loop.run_dir, "viz")
                state["viz"].do_visualize(
                    viz_dir, engine, f"{loop.cur_nimg // 1000:06d}")
            except Exception as e:
                _count_failure(loop, "viz", e)

    def on_snapshot(loop, snap_path):
        if metric_snapshot_ticks is None or \
                loop.cur_tick % metric_snapshot_ticks != 0:
            return
        try:
            from brushstroke_engine_torch.engine.library import (
                RandomBrushLibrary,
            )
            from brushstroke_engine_torch.metrics.metric_main import (
                forger_compute_fid, paint_engine_metric_loop,
                summary_losses_to_file,
            )
            from brushstroke_engine_torch.metrics.stroke_generator import (
                PaintStrokeGenerator, RandomState,
            )
            engine = _engine_from_loop(loop)
            gen = PaintStrokeGenerator(metric_batch_size, engine,
                                       RandomState(0))
            if geom_iterator is not None:
                gen.set_geometry_source_from_iterator(
                    geom_iterator, metric_batch_size)
            else:
                from brushstroke_engine_torch.data.curves import \
                    random_spline_stroke
                w = engine.patch_width

                def synth_iter():
                    rng = np.random.default_rng(0)
                    while True:
                        g = np.stack([
                            random_spline_stroke(rng, w)
                            for _ in range(metric_batch_size)])
                        tri = np.stack([g, g, g], axis=-1)
                        yield (tri * 255).astype(np.uint8)

                gen.set_geometry_source_from_iterator(
                    synth_iter(), metric_batch_size)

            results = {}
            if "forger" in metrics:
                lib = RandomBrushLibrary(num_metric_styles,
                                         loop.cfg.gen_cfg.z_dim)
                results.update(paint_engine_metric_loop(
                    gen, lib, nbatches_per_style=1))
            if "fid" in metrics and fid_real_batches is not None:
                from brushstroke_engine_torch.metrics import fid as fid_lib
                results["FID"] = forger_compute_fid(
                    gen, fid_real_batches, num_items=fid_items)
                logger.info("FID detector kind: %s",
                            fid_lib.default_detector_kind(loop.device))
            summary_losses_to_file(
                os.path.join(loop.run_dir, "summary_metrics.txt"),
                results, step=loop.cur_nimg // 1000, do_print=True)
        except Exception as e:
            _count_failure(loop, "metric", e)

    return LoopHooks(on_tick=on_tick, on_snapshot=on_snapshot)
