"""Closed-loop painters against the program's serving core, no transport.

Set-up makes the weights and the painters' stroke patches from the seed,
builds the program's engine and its serving core on the traffic's image
path, and runs the core's own start-up warm-up.  Every painter then opens a
session (its own canvas and its own seeded brush) and paints for
``warm_seconds``, which warms the batch sizes the traffic reaches.  Then
the window: each painter sends a stroke, waits for its reply, and sends
the next at once, until ``seconds`` have passed.  Strokes still in flight
at the end are waited for: their latency counts.  With ``--trace 1`` the
painters then paint ``trace_seconds`` more under the profiler (after the
window: strokes after a profiled span run slower than before it).
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List

import numpy as np
import torch

from neube_bench import weights as W
from neube_bench.traffic.drawings import make_drawing
from neube_bench.traffic.painter import Painter


class Cell:

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device,
                 impl: str = "program"):
        if impl != "program":
            raise ValueError("the serve cell's control runs in the check")
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.setup_phases = {}
        self.trace_passes: List[int] = []
        self.trace_strokes = 0

    def setup(self):
        from brushstroke_engine_torch.ops.precision import set_precision_mode
        from brushstroke_engine_torch.ui import core as ui_core
        from neube_bench.drivers.engine import program_engine
        t = self.traffic
        t0 = time.perf_counter()
        self.trees = W.make_trees(self.cfg, self.seed, self.device)
        pw = self.cfg["img_resolution"]
        self.patches = []
        for k in range(t["patches"]):
            g = make_drawing(pw, self.seed, 1000 + k, t["drawing"],
                             self.device)
            p = np.zeros((pw, pw, 4), np.uint8)
            p[..., 3] = np.round((1.0 - g) * 255).astype(np.uint8)
            self.patches.append(p)
        rng = np.random.default_rng([int(self.seed), 31])
        span = t["canvas"] - pw
        self.plans = [[(int(a), int(b), int(c)) for a, b, c in zip(
            rng.integers(0, t["patches"], t["plan_strokes"]),
            rng.integers(0, span, t["plan_strokes"]),
            rng.integers(0, span, t["plan_strokes"]))]
            for _ in range(t["painters"])]
        self.brushes = [int(b) for b in rng.integers(
            0, 2 ** 31, t["painters"])]
        self.setup_phases["weights and strokes"] = time.perf_counter() - t0
        set_precision_mode(self.cfg["precision"])
        self.engine = program_engine(self.cfg, self.trees, self.device)
        self.core = ui_core.create_core(
            paint_engine=self.engine, device=self.device,
            use_device_canvas=t["path"] == "pooled",
            batch_window_ms=t["window_ms"])
        self.core.warmup(canvas=(t["canvas"], t["canvas"]),
                         level=t["level"], crop_margin=t["crop"])
        self.setup_phases["core warm-up"] = time.perf_counter() - t0
        self.loop = asyncio.new_event_loop()
        self.painters = self.loop.run_until_complete(self._open())
        self._phase(t["warm_seconds"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_phases["painters warm"] = time.perf_counter() - t0

    async def _open(self):
        from brushstroke_engine_torch.ui import protocol
        t = self.traffic
        painters = [Painter(self.core, protocol, b, t["canvas"], t["level"],
                            t["crop"], t["reply_timeout"])
                    for b in self.brushes]
        for p in painters:
            await p.configure()
        return painters

    def _batches(self):
        b = self.core.dev_batcher or self.core.batcher
        return b.batch_sizes if b is not None else []

    def _phase(self, seconds: float):
        """All painters paint for ``seconds``; returns (start, end) and
        each painter's record count before it."""
        before = [len(p.records) for p in self.painters]
        t0 = time.perf_counter()
        deadline = t0 + seconds

        async def go():
            await asyncio.gather(*[
                p.paint_until((self.patches, plan), deadline)
                for p, plan in zip(self.painters, self.plans)])
        self.loop.run_until_complete(go())
        return t0, deadline, before

    def window(self, seconds: float, trace_out=None) -> Dict:
        t = self.traffic
        n0 = len(self._batches())
        t0, t1, before = self._phase(seconds)
        self.window_passes = self._batches()[n0:]
        recs = [r for p, b in zip(self.painters, before)
                for r in p.records[b:]]
        if trace_out is not None:
            from neube_bench.trace import traced
            n0 = len(self._batches())
            with traced(self.device.type, trace_out):
                _, _, before = self._phase(t["trace_seconds"])
            self.trace_passes = self._batches()[n0:]
            self.trace_strokes = sum(
                1 for p, b in zip(self.painters, before)
                for r in p.records[b:] if r["client_ms"] is not None)
        done = [r for r in recs if r["client_ms"] is not None]
        self.window_records = recs
        return {"seconds": t1 - t0,
                "replies": sum(1 for r in done if r["t_done"] <= t1),
                "latencies_ms": [r["client_ms"] if r["client_ms"] is not None
                                 else float("inf") for r in recs],
                "queue_ms": [r["timing"]["queue_ms"] for r in done],
                "render_ms": [r["timing"]["render_ms"] for r in done]}

    def free_program(self):
        for p in self.painters:
            self.loop.run_until_complete(p.close())
        self.core.close()
        self.core = self.engine = None
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        raise NotImplementedError("the serve cell has no check yet")

    def counters(self) -> Dict:
        recs = getattr(self, "window_records", [])
        return {"trace_passes": self.trace_passes,
                "trace_strokes": self.trace_strokes,
                "window_passes": getattr(self, "window_passes", []),
                "attempted": len(recs),
                "failed": sum(1 for r in recs if r["client_ms"] is None)}
