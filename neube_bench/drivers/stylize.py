"""Whole-drawing stylization, one drawing after another.

Set-up makes the weights and the traffic's drawings from the seed, builds
the program's engine and stylizes one drawing to warm every shape.  The
window then stylizes the drawings in turn, each with a new brush (a style
latent drawn from the seed), through the program's entry named in the
traffic file, each returned to the host as its uint8 canvas; it ends with
the first drawing that finishes at or after ``seconds``.  Of the finished
canvases it keeps one per drawing, a reservoir slot drawn from the seed, so
that the window holds no more host memory as it goes.

A traced window (``--trace 1``) stylizes ``host_images`` drawings without
the profiler, whose seconds are the host-clock time per tile that the
shares of the pass divide by (the profiler stretches the host's time, not
the device's), then ``trace_images`` under it, and ends there.  The
untraced drawings come first: drawings after a profiled span run slower
than those of an untraced run.

The check, once the window has closed and the program's state is freed,
renders the kept drawings with the plain reference in float32 (TF32 off)
and compares every canvas value.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from neube_bench import weights as W
from neube_bench.reference import stylize as ref
from neube_bench.traffic.drawings import make_drawing


class _Phases:
    """Seconds of each set-up step, kept in ``cell.setup_phases``."""

    def __init__(self, cell):
        self.cell = cell
        cell.setup_phases = {}
        self.t = time.perf_counter()

    def __call__(self, name):
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)
        now = time.perf_counter()
        self.cell.setup_phases[name] = now - self.t
        self.t = now


def _dtype(name: str):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class Cell:
    """One stylize cell.  ``impl`` 'program' drives the program; a dtype
    name ('bfloat16') puts the plain reference in its place at that
    precision (the control)."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device,
                 impl: str = "program"):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.impl = impl
        self.n_finished = 0
        self.kept: Dict[int, tuple] = {}  # drawing -> (index, canvas)
        self._reservoir = np.random.default_rng([int(seed), 13])
        self.unit_seconds: List[float] = []
        self.passes: List[int] = []      # rows of each render pass
        self.trace_passes: List[int] = []
        self.trace_tiles = 0
        self.host_tiles = 0
        self.host_seconds = 0.0

    # -- set-up ----------------------------------------------------------
    def setup(self):
        t = self.traffic
        clock = _Phases(self)
        self.trees = W.make_trees(self.cfg, self.seed, self.device)
        clock("weights")
        self.drawings = [make_drawing(t["image_size"], self.seed, i,
                                      t["drawing"], self.device)
                         for i in range(t["drawings"])]
        clock("drawings")
        self.styles = W.style_latents(self.seed, t["max_images"] + 1,
                                      self.cfg["z_dim"])
        self.tiles_per_image = len(ref.tile_grid(
            t["image_size"], t["image_size"], self.cfg["img_resolution"],
            t["overlap_margin"])[2])
        if self.impl == "program":
            from brushstroke_engine_torch.ops.precision import \
                set_precision_mode
            from neube_bench.drivers.engine import program_engine
            set_precision_mode(self.cfg["precision"])
            self.engine = program_engine(self.cfg, self.trees, self.device)
            run_core = self.engine._run_core

            def counted(geom, opts, **kw):
                self.passes.append(int(geom.shape[0]))
                with torch.profiler.record_function("neube_bench.pass"):
                    return run_core(geom, opts, **kw)
            self.engine._run_core = counted
        clock("engine")
        # The warm-up drawing: the first, with a style of its own.
        self._stylize(0, self.styles[-1])
        self._sync()
        clock("warm-up drawing")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stylize(self, drawing: int, z) -> np.ndarray:
        t = self.traffic
        kw = dict(overlap_margin=t["overlap_margin"],
                  crop_margin=t["crop_margin"],
                  feature_blending_level=t["feature_blending_level"])
        if self.impl == "program":
            from brushstroke_engine_torch.engine import stylize
            from brushstroke_engine_torch.engine.brush import GanBrushOptions
            opts = GanBrushOptions()
            opts.set_style(z, None)
            return getattr(stylize, t["entry"])(
                self.engine, self.drawings[drawing], opts,
                batch_size=t["batch_size"], mode=t["mode"], **kw)
        return ref.stylize(
            self.cfg, self.trees,
            torch.from_numpy(self.drawings[drawing]).to(self.device),
            torch.from_numpy(z).float(), _dtype(self.impl),
            overlap=kw["overlap_margin"], crop=kw["crop_margin"],
            level=kw["feature_blending_level"], batch=t["batch_size"])

    # -- window ----------------------------------------------------------
    def run_unit(self):
        i = self.n_finished
        if i >= self.traffic["max_images"]:
            raise RuntimeError("the window outran the traffic's max_images")
        d = i % len(self.drawings)
        t0 = time.perf_counter()
        canvas = self._stylize(d, self.styles[i])
        self.unit_seconds.append(time.perf_counter() - t0)
        self.n_finished += 1
        # Reservoir of one per drawing: the k-th finish of drawing d takes
        # the slot with chance 1/k, so each is kept alike.
        k = i // len(self.drawings) + 1
        if self._reservoir.integers(k) == 0:
            self.kept[d] = (i, canvas)

    def window(self, seconds: float, trace_out=None) -> Dict:
        """Stylize until ``seconds`` have passed at a drawing's end.  With
        ``trace_out`` the traced window instead: ``host_images`` drawings
        timed on the host clock, then ``trace_images`` under the profiler
        (``neube_bench/trace.py``)."""
        t = self.traffic
        t0 = time.perf_counter()
        if trace_out is not None:
            from neube_bench.trace import traced
            for _ in range(t["host_images"]):
                self.run_unit()
            self.host_seconds = time.perf_counter() - t0
            self.host_tiles = t["host_images"] * self.tiles_per_image
            n0 = len(self.passes)
            with traced(self.device.type, trace_out):
                for _ in range(t["trace_images"]):
                    self.run_unit()
            self.trace_passes = self.passes[n0:]
            self.trace_tiles = t["trace_images"] * self.tiles_per_image
        else:
            while not self.n_finished or \
                    time.perf_counter() - t0 < seconds:
                self.run_unit()
        elapsed = time.perf_counter() - t0
        return {"seconds": elapsed, "images": self.n_finished,
                "tiles": self.n_finished * self.tiles_per_image,
                "unit_seconds": self.unit_seconds}

    # -- check -----------------------------------------------------------
    def free_program(self):
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> List[tuple]:
        """The finished drawings to check, (index, canvas): the kept one of
        each drawing, as far as each finished."""
        return [self.kept[d] for d in sorted(self.kept)][
            :self.traffic["check_images"]]

    def check(self) -> Dict[str, float]:
        """The compared numbers, each the largest over the sample:
        ``share_ge2lsb``, the share of the canvas's values that lie 2 LSB
        or more from the reference's, and ``worst_tile_share_ge2lsb``, the
        same within the tile where it is largest (one tile rendered wrong
        shows there).  More statistics of the differences (means, other
        thresholds, the largest difference) are kept in
        ``self.diagnostics``."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t = self.traffic
        patch = self.cfg["img_resolution"]
        _, _, tiles = ref.tile_grid(t["image_size"], t["image_size"], patch,
                                    t["overlap_margin"])
        crop = t["crop_margin"]
        inner = patch - 2 * crop
        worst = {}
        for i, got in self.sample():
            want = ref.stylize(
                self.cfg, self.trees,
                torch.from_numpy(self.drawings[i % len(self.drawings)]).to(
                    self.device),
                torch.from_numpy(self.styles[i]).float(), torch.float32,
                overlap=t["overlap_margin"], crop=crop,
                level=t["feature_blending_level"], batch=t["batch_size"])
            if got is None or got.shape != want.shape:
                return {k: float("inf") for k in t["limits"]}
            d = (torch.from_numpy(got).to(self.device).short()
                 - torch.from_numpy(want).to(self.device).short()).abs()
            tl = torch.stack([d[y + crop:y + crop + inner,
                                x + crop:x + crop + inner]
                              for y, x in tiles]).float()
            stats = {"canvas_mean_lsb": float(d.float().mean()),
                     "worst_tile_mean_lsb": float(
                         tl.mean(dim=(1, 2, 3)).max())}
            for k in (2, 3, 4, 8):
                stats[f"share_ge{k}lsb"] = float((d >= k).float().mean())
                stats[f"worst_tile_share_ge{k}lsb"] = float(
                    (tl >= k).float().mean(dim=(1, 2, 3)).max())
            stats["max_lsb"] = float(d.max())
            for k, v in stats.items():
                worst[k] = max(worst.get(k, 0.0), v)
        self.diagnostics = worst
        return {k: worst[k] for k in t["limits"]}

    def counters(self) -> Dict:
        return {"trace_passes": self.trace_passes,
                "trace_tiles": self.trace_tiles,
                "host_tiles": self.host_tiles,
                "host_seconds": self.host_seconds,
                "attempted": self.n_finished, "failed": 0}
