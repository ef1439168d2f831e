"""Closed-loop painter sessions against the serving core, per image path.

The port's counterpart of ``measure_ws_slo`` in ``bench.py``, without a
transport: N painter sessions talk to ``ui.core`` directly (bytes in, the
reply callback out) on the running ``asyncio`` loop, each sending a stroke,
waiting for its reply, then sending the next.  Per path (helper, device
canvas, ``RenderBatcher``, the pool) and session count it reports the
per-stroke latency as the client sees it (p50/p99), the timing side
channel's ``server_ms`` and ``render_ms`` (p50/p99), strokes/s, rows per
generator pass, K1 launches, and the device's idle share over a traced run
of a few more strokes (``torch.profiler``, CUDA activity only).

    python3 -m brushstroke_engine_torch.tools.bench_serve
        [--gan_checkpoint B.pkl] [--paths helper,device_canvas,batched,pooled]
        [--sessions 1,8] [--strokes 48] [--warmup 8] [--out_dir DIR]

Defaults mirror ``measure_ws_slo``: a 1024-px canvas at blending level 2,
crop margin 10, positions and timing on, whole 256-px patches at seeded
positions, 4 ms flush window.  Without ``--gan_checkpoint`` the 256-px
flagship with random weights from ``--seed`` serves.  Needs a CUDA device
unless ``--device cpu``.  Imports neither tornado nor PIL.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import time

import numpy as np
import torch

from brushstroke_engine_torch.ui import core as ui_core
from brushstroke_engine_torch.ui import protocol
from brushstroke_engine_torch.utils.util import resolve_device

PATHS = ("helper", "device_canvas", "batched", "pooled")


def path_options(path: str, window_ms: float) -> dict:
    """``create_core`` flags of an image path (the JAX server's
    ``--device_canvas`` / ``--batch_window_ms``)."""
    return {"helper": {},
            "device_canvas": {"use_device_canvas": True},
            "batched": {"batch_window_ms": window_ms},
            "pooled": {"use_device_canvas": True,
                       "batch_window_ms": window_ms}}[path]


def stroke_patches(pw: int, n: int = 4):
    """``n`` whole-patch strokes (uint8 RGBA, the alpha is the stroke)."""
    from brushstroke_engine_torch.data.curated_geometry import \
        curated_geometry_patch
    geom = curated_geometry_patch("curve", 9, pw)
    base = np.zeros((pw, pw, 4), np.uint8)
    base[..., 3] = np.round((1.0 - geom) * 255).astype(np.uint8)
    return [np.ascontiguousarray(np.roll(base, (pw // 7) * i, i % 2))
            for i in range(n)]


def stroke_plan(sessions: int, strokes: int, canvas: int, pw: int,
                seed: int):
    """Per session, ``strokes`` (patch index, x, y) at seeded positions."""
    plans = []
    for s in range(sessions):
        rng = np.random.RandomState(seed + 100 + s)
        plans.append([(int(rng.randint(4)), int(rng.randint(canvas - pw)),
                       int(rng.randint(canvas - pw)))
                      for _ in range(strokes)])
    return plans


def _quantiles(values):
    v = np.asarray(values, np.float64)
    return {"p50": float(np.percentile(v, 50)),
            "p99": float(np.percentile(v, 99)), "n": int(v.size)}


class Painter:
    """One closed-loop client session of a core, over an in-process stand-in
    for the websocket: the client puts its messages in ``inbox`` and a
    server task hands them to the session one at a time, in order, as
    tornado does for a connection, so a message waits there while the loop
    is busy with other sessions."""

    def __init__(self, core, brush_seed: int, canvas: int, level: int,
                 crop: int, reply_timeout: float):
        self.inbox = asyncio.Queue()
        self.replies = asyncio.Queue()
        self.session = core.session(self.replies.put_nowait)
        self.brush_seed = brush_seed
        self.canvas, self.level, self.crop = canvas, level, crop
        self.reply_timeout = reply_timeout
        self.brushinfos = 0
        self.records = []
        self._server = None

    async def _serve(self):
        while True:
            msg = await self.inbox.get()
            if msg is None:
                return
            await self.session.on_message(msg)

    async def _next(self):
        msg = await asyncio.wait_for(self.replies.get(), self.reply_timeout)
        if isinstance(msg, dict) and msg["type"] == "brushinfo":
            self.brushinfos += 1
        return msg

    async def configure(self):
        self._server = asyncio.get_running_loop().create_task(self._serve())
        self.session.open()
        for msg in ({"type": "set_option", "option": "positions",
                     "value": True},
                    {"type": "set_option", "option": "timing",
                     "value": True},
                    {"type": "new_canvas", "rows": self.canvas,
                     "cols": self.canvas, "feature_blending": self.level},
                    {"type": "set_brush", "seed": self.brush_seed}):
            self.inbox.put_nowait(json.dumps(msg))
        while self.brushinfos < 2:        # at connect and after set_brush
            await self._next()

    async def close(self):
        self.inbox.put_nowait(None)
        await self._server
        self.session.on_close()

    async def paint(self, patches, plan, keep: bool):
        """Send ``plan``'s strokes one at a time; each waits for its image
        and its timing message (a missing reply raises after the
        timeout)."""
        for idx, x, y in plan:
            raw = protocol.encode_render_request(patches[idx], x, y,
                                                 crop_margin=self.crop)
            t0 = time.perf_counter()
            self.inbox.put_nowait(raw)
            while True:
                msg = await self._next()
                if isinstance(msg, bytes):
                    break
            rtype, meta, img = protocol.decode_render_response(msg)
            client_ms = (time.perf_counter() - t0) * 1e3
            while True:
                timing = await self._next()
                if isinstance(timing, dict) and timing["type"] == "timing":
                    break
            self.records.append({
                "stroke": (idx, x, y), "client_ms": client_ms,
                "timing": timing["data"], "meta": meta,
                "image": img.copy() if keep else None})


def _busy_ms(prof) -> float:
    """Union of the CUDA activity intervals the profiler recorded, ms."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


async def _drive(core, painters, patches, plans, lo, hi, keep):
    await asyncio.gather(*[p.paint(patches, plan[lo:hi], keep)
                           for p, plan in zip(painters, plans)])


def make_core(engine, path: str, window_ms: float = 4.0, canvas: int = 1024,
              level: int = 2, crop: int = 10, warm: bool = True):
    """A core serving ``engine`` through ``path``; ``warm``: run the
    server's start-up warm-up for that canvas configuration first."""
    core = ui_core.create_core(paint_engine=engine, device=engine.device,
                               **path_options(path, window_ms))
    if warm:
        core.warmup(canvas=(canvas, canvas), level=level, crop_margin=crop)
    return core


def serve(core, path: str, sessions: int, strokes: int, warmup: int,
          canvas: int = 1024, level: int = 2, crop: int = 10, seed: int = 0,
          trace_strokes: int = 4, keep_images: bool = False,
          reply_timeout: float = 120.0):
    """Serve ``sessions`` closed-loop painters through ``core`` (made for
    ``path``): ``warmup`` strokes each, then ``strokes`` timed, then
    ``trace_strokes`` under the profiler for the idle share (none on the
    CPU).  Returns (stats, painters); each painter's ``records`` hold every
    stroke in order."""
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    engine = core.engine
    dev = engine.device
    pw = engine.patch_width
    patches = stroke_patches(pw)
    plans = stroke_plan(sessions, warmup + strokes + trace_strokes, canvas,
                        pw, seed)
    launches0 = fir4_epilogue.launches
    batchers = [b for b in (core.batcher, core.dev_batcher) if b is not None]
    sizes0 = [len(b.batch_sizes) for b in batchers]

    async def run():
        painters = [Painter(core, seed + 7 + s, canvas, level, crop,
                            reply_timeout) for s in range(sessions)]
        for p in painters:
            await p.configure()
        await _drive(core, painters, patches, plans, 0, warmup, keep_images)
        b0 = [len(b.batch_sizes) for b in batchers]
        t0 = time.perf_counter()
        await _drive(core, painters, patches, plans, warmup,
                     warmup + strokes, keep_images)
        wall = time.perf_counter() - t0
        sizes = [s for b, n in zip(batchers, b0) for s in b.batch_sizes[n:]]
        idle = None
        if trace_strokes and dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize(dev)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                await _drive(core, painters, patches, plans,
                             warmup + strokes,
                             warmup + strokes + trace_strokes, keep_images)
                torch.cuda.synchronize(dev)
                traced_ms = (time.perf_counter() - t1) * 1e3
            busy = _busy_ms(prof)
            if busy <= 0:
                raise RuntimeError(f"{path}: the profiler recorded no "
                                   f"device time")
            idle = {"traced_ms": traced_ms, "busy_ms": busy,
                    "idle_share": max(0.0, 1.0 - busy / traced_ms)}
        else:
            await _drive(core, painters, patches, plans, warmup + strokes,
                         warmup + strokes + trace_strokes, keep_images)
        for p in painters:
            await p.close()
        return painters, wall, sizes, idle

    painters, wall, sizes, idle = asyncio.run(run())
    timed = [r for p in painters for r in p.records[warmup:warmup + strokes]]
    # Generator passes: one per stroke on the serial paths, one per batch on
    # the batched ones, plus one per color swatch of a brush info.
    n_batches = sum(len(b.batch_sizes) - n for b, n in zip(batchers, sizes0))
    n_strokes = sum(len(p.records) for p in painters)
    passes = (n_batches if batchers else n_strokes) \
        + sum(p.brushinfos for p in painters)
    stats = {
        "path": path, "sessions": sessions, "strokes_per_session": strokes,
        "warmup": warmup, "canvas": canvas, "level": level, "crop": crop,
        "window_ms": batchers[0].window_ms if batchers else None,
        "client_ms": _quantiles([r["client_ms"] for r in timed]),
        "server_ms": _quantiles([r["timing"]["server_ms"] for r in timed]),
        "render_ms": _quantiles([r["timing"]["render_ms"] for r in timed]),
        "queue_ms": _quantiles([r["timing"]["queue_ms"] for r in timed]),
        "strokes_per_s": len(timed) / wall,
        "timed_paths": sorted({r["timing"]["path"] for r in timed}),
        "rows_per_pass": {"mean": statistics.mean(sizes),
                          "max": max(sizes), "passes": len(sizes)}
        if sizes else None,
        "strokes_served": n_strokes, "generator_passes": passes,
        "k1_launches": fir4_epilogue.launches - launches0,
        "device": idle,
        "fallbacks": core.fallbacks, "errors": core.errors,
    }
    return stats, painters


def run_path(engine, path: str, sessions: int, strokes: int, warmup: int,
             canvas: int = 1024, level: int = 2, crop: int = 10,
             window_ms: float = 4.0, seed: int = 0, trace_strokes: int = 4,
             keep_images: bool = False, warm_core: bool = True):
    """:func:`make_core` and :func:`serve` with one configuration."""
    core = make_core(engine, path, window_ms, canvas, level, crop, warm_core)
    try:
        return serve(core, path, sessions, strokes, warmup, canvas, level,
                     crop, seed, trace_strokes, keep_images)
    finally:
        core.close()


def serial_replay(engine, path: str, painter, canvas: int, level: int,
                  crop: int):
    """A painter's strokes again, one at a time on a fresh canvas, through
    the serial render its path stands for: ``PaintingHelper.render_stroke``
    for the helper and batched paths, ``DevicePaintSession.render_stroke``
    for the device-canvas and pooled ones.  Returns [(image, meta)]."""
    import copy

    from brushstroke_engine_torch.engine.brush import GanBrushOptions
    from brushstroke_engine_torch.engine.canvas import PaintingHelper
    from brushstroke_engine_torch.engine.device_canvas import \
        DevicePaintSession
    patches = stroke_patches(engine.patch_width)
    opts = GanBrushOptions()
    opts.set_style(engine.random_style(painter.brush_seed),
                   painter.brush_seed)
    out = []
    if path in ("helper", "batched"):
        helper = PaintingHelper(engine, style_seed=0)
        helper.make_new_canvas(canvas, canvas, feature_blending=level)
        for r in painter.records:
            idx, x, y = r["stroke"]
            o = copy.copy(opts)
            o.set_position(x, y)
            img, _, meta = helper.render_stroke(
                patches[idx], None, o,
                meta={"x": x, "y": y, "crop_margin": crop})
            out.append((img, meta))
    else:
        session = DevicePaintSession(engine, canvas, canvas,
                                     feature_blending_level=level,
                                     crop_margin=crop)
        for r in painter.records:
            idx, x, y = r["stroke"]
            o = copy.copy(opts)
            o.set_position(x, y)
            out.append(session.render_stroke(patches[idx], o, x, y))
    return out


def bench_engine(gan_checkpoint, device, seed: int):
    """The engine under test: a bundle, or the 256-px flagship with random
    weights (``noise_strength`` 0.1) from ``seed``."""
    from brushstroke_engine_torch.engine.brush import PaintEngineFactory
    from brushstroke_engine_torch.flagship import (
        flagship_engine, flagship_trees,
    )
    if gan_checkpoint:
        return PaintEngineFactory.create(gan_checkpoint, device=device)
    return flagship_engine(flagship_trees(256, seed, 0.1), 256, 0, device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gan_checkpoint", type=str, default=None)
    ap.add_argument("--paths", type=str, default=",".join(PATHS))
    ap.add_argument("--sessions", type=str, default="1,8")
    ap.add_argument("--strokes", type=int, default=48)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--trace_strokes", type=int, default=4)
    ap.add_argument("--canvas", type=int, default=1024)
    ap.add_argument("--level", type=int, default=2)
    ap.add_argument("--crop", type=int, default=10)
    ap.add_argument("--window_ms", type=float, default=4.0)
    ap.add_argument("--precision", choices=["fast", "strict"],
                    default="strict")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out_dir", type=str, default=None,
                    help="Also write the results as JSON lines there.")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    from brushstroke_engine_torch.ops.precision import set_precision_mode
    set_precision_mode(args.precision)
    engine = bench_engine(args.gan_checkpoint, dev, args.seed)
    results = []
    for path in args.paths.split(","):
        for n in (int(s) for s in args.sessions.split(",")):
            stats, _ = run_path(
                engine, path, n, args.strokes, args.warmup, args.canvas,
                args.level, args.crop, args.window_ms, args.seed,
                args.trace_strokes)
            stats["precision"] = args.precision
            results.append(stats)
            print(json.dumps(stats), flush=True)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "bench_serve.jsonl"), "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return results


if __name__ == "__main__":
    main()
