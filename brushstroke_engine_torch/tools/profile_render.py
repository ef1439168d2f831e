"""Where the render's time goes on the GPU.

Traces the 256-px flagship render with ``torch.profiler`` (CPU and CUDA
activities) in three configurations -- ``render_stroke`` (B=1, strict f32,
UVS mapping on), ``render_batch`` B=16 strict f32, ``render_batch`` B=16
with bf16 blocks in 'fast' mode -- and prints, per configuration, the wall
time per call, the device's busy time and idle share, K1's share and the
kernels that take the most device time, then each of the program's
``bse.*`` spans with its count, host ms and the ms within it in which the
device was idle.  With ``--canvas`` it traces the paint path instead
(strict f32): one blended ``PaintingHelper`` stroke and one
``DevicePaintSession`` stroke on a 1024-px canvas at blending level 2, and
the 2048-px stylize of ``chip_smoke.py`` through
``stylize_image_batched`` (B=16: 7 wave chunks) and
``stylize_image_ondevice`` (B=32: 4).  The full tables go to
``<out_dir>/profile_<config>.txt`` (default ``build/profile``).

    python3 -m brushstroke_engine_torch.tools.profile_render [--iters N]
        [--out_dir DIR] [--canvas]

Needs a CUDA device; weights are random, from a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from brushstroke_engine_torch.data.curated_geometry import \
    curated_geometry_patch
from brushstroke_engine_torch.engine.brush import GanBrushOptions
from brushstroke_engine_torch.flagship import flagship_engine, flagship_trees
from brushstroke_engine_torch.ops.precision import precision_mode
from brushstroke_engine_torch.utils.util import device_activity

RES = 256
BATCH = 16


def _patch():
    geom = curated_geometry_patch("curve", 9, RES)
    patch = np.zeros((RES, RES, 4), np.uint8)
    patch[..., 3] = np.round((1.0 - geom) * 255).astype(np.uint8)
    return patch


def _opts(engine, i, uvs):
    o = GanBrushOptions(primary_color=np.array([220, 40, 60], np.uint8))
    o.set_style(engine.random_style(7 if uvs else 100 + i), style_id=7)
    o.set_position(x=1000 + 37 * i, y=333)
    o.enable_uvs_mapping = uvs
    return o


def trace(name, fn, iters, out_dir):
    """Profile ``iters`` calls of ``fn``; device time is the sum of the CUDA
    activity (kernels, copies, memsets) the profiler recorded."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    events = prof.events()
    device = device_activity(events)
    per_name = {}
    for e in device:
        us, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in per_name.values()) / 1e3 / iters
    if busy_ms <= 0:
        raise RuntimeError(f"{name}: the profiler recorded no device time")
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])

    def rows(items):
        return [{"name": k[:100], "ms_per_call": us / 1e3 / iters,
                 "share": us / 1e3 / iters / busy_ms,
                 "launches_per_call": n / iters} for k, (us, n) in items]

    own = rows([kv for kv in ranked if "fir4_epilogue" in kv[0]])
    result = {"config": name, "iters": iters, "wall_ms": wall_ms,
              "device_busy_ms": busy_ms,
              "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
              "k1_ms": sum(r["ms_per_call"] for r in own),
              "k1_share": sum(r["share"] for r in own),
              "top_kernels": rows(ranked[:15]),
              # The port's own kernel, every instantiation the call launched.
              "own_kernels": own}
    spans = span_table(events, device, iters)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))
        f.write("\n" + spans)
    print(json.dumps(result), flush=True)
    print(spans, flush=True)
    return result


def _merge(spans):
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap_us(a, b):
    """Length of the intersection of two merged lists of spans."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_table(events, device, iters):
    """Each ``bse.*`` span of the program (``utils.util.span``) per call:
    how often it opened, its host ms, and the ms within it in which no
    device activity ran -- the attribution of the device's idle time that
    the program's spans give."""
    busy = _merge([(e.time_range.start, e.time_range.end) for e in device])
    by = {}
    for e in events:
        if e.name.startswith("bse.") and e.device_type == DeviceType.CPU:
            by.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    lines = [f"{'span':<24} {'count':>8} {'host ms':>10} {'idle ms':>10}"
             f"   (per call, {iters} calls)"]
    for name in sorted(by):
        spans = by[name]
        merged = _merge(spans)
        host = sum(e - s for s, e in merged)
        idle = host - _overlap_us(merged, busy)
        lines.append(f"{name:<24} {len(spans) / iters:>8.2f} "
                     f"{host / 1e3 / iters:>10.3f} "
                     f"{idle / 1e3 / iters:>10.3f}")
    return "\n".join(lines) + "\n"


def trace_canvas(trees, iters, out_dir):
    """The paint path: a blended stroke through each canvas, and the
    2048-px stylize through the two wave renderers."""
    from brushstroke_engine_torch.data.curves import line_drawing
    from brushstroke_engine_torch.engine.canvas import PaintingHelper
    from brushstroke_engine_torch.engine.device_canvas import \
        DevicePaintSession
    from brushstroke_engine_torch.engine.stylize import (
        stylize_image_batched, stylize_image_ondevice,
    )
    engine = flagship_engine(trees, RES, 0, "cuda")
    patch = _patch()
    canvas, step = 1024, 48
    helper = PaintingHelper(engine, style_seed=0)
    helper.make_new_canvas(canvas, canvas, feature_blending=2)
    session = DevicePaintSession(engine, canvas, canvas,
                                 feature_blending_level=2, crop_margin=10)
    opts = _opts(engine, 0, False)
    calls = {"helper": 0, "session": 0}

    def position(key):
        # Overlapping strokes along a diagonal, so each blends with the last.
        i = calls[key] = calls[key] + 1
        return (i * step) % (canvas - RES), (i * step // 2) % (canvas - RES)

    def helper_stroke():
        x, y = position("helper")
        opts.set_position(x, y)
        helper.render_stroke(patch, None, opts,
                             meta={"x": x, "y": y, "crop_margin": 10})

    def session_stroke():
        x, y = position("session")
        session.render_stroke(patch, opts, x=x, y=y)

    trace("paint_helper_stroke_f32", helper_stroke, iters, out_dir)
    trace("device_session_stroke_f32", session_stroke, iters, out_dir)
    drawing = line_drawing(2048, 64, 0)
    kw = dict(overlap_margin=10, crop_margin=10, feature_blending_level=2)
    trace("stylize_batched_2048_f32",
          lambda: stylize_image_batched(engine, drawing,
                                        _opts(engine, 0, False), **kw),
          max(iters // 5, 1), out_dir)
    trace("stylize_ondevice_2048_f32",
          lambda: stylize_image_ondevice(engine, drawing,
                                         _opts(engine, 0, False), **kw),
          max(iters // 5, 1), out_dir)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out_dir", default="build/profile")
    p.add_argument("--canvas", action="store_true",
                   help="trace the paint path instead of the render")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_render needs a CUDA device")
    trees = flagship_trees(RES, seed=0, noise_strength=0.1)
    if args.canvas:
        with precision_mode("strict"):
            trace_canvas(trees, args.iters, args.out_dir)
        return
    patch = _patch()
    with precision_mode("strict"):
        engine = flagship_engine(trees, RES, 0, "cuda")
        geoms = np.repeat(engine.prepare_geom_input(patch), BATCH, axis=0)
        trace("render_stroke_f32",
              lambda: engine.render_stroke(patch, None,
                                           _opts(engine, 0, True)),
              args.iters, args.out_dir)
        trace("render_batch16_f32",
              lambda: engine.render_batch(
                  geoms, [_opts(engine, i, False) for i in range(BATCH)]),
              args.iters, args.out_dir)
    with precision_mode("fast"):
        engine16 = flagship_engine(trees, RES, 6, "cuda")
        trace("render_batch16_bf16",
              lambda: engine16.render_batch(
                  geoms, [_opts(engine16, i, False) for i in range(BATCH)]),
              args.iters, args.out_dir)


if __name__ == "__main__":
    main()
