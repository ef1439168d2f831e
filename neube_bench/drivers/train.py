"""GAN training through the training CLI's own loop.

Set-up writes the traffic's seeded style images and triband geometry as
the zips ``--data`` and ``--geom_data`` read, makes the weights of G, D and
the geometry encoder from the seed, builds the loop with
``tools/train.py:build`` from the configuration's flags, hands it those
weights (``train/state.py:init_train_state``, as ``--resume`` does) and
places it as if resumed at ``start_batch``.  It then runs the
``check_batches`` batches from there through ``TrainingLoop.run``: the
first of them runs every phase and shape of the schedule (Dmain, Dr1,
Gmain, Gpl, ADA's step), which builds the kernels.  The window runs whole
periods of ``period_batches`` batches on: it ends with the first period
finished at or after ``seconds`` (or after ``max_periods``, which keeps the
next Ggeom batch out), each period timed on the host clock between device
synchronisations at its boundaries.  Every period must hold the phases the
schedule gives it and no Ggeom and no snapshot; the driver raises
otherwise.  Once the window has closed, the same warm loop is placed again
as set-up placed it, from the seeded weights, and runs the checked
batches (``run_checked``).

The loop is driven from outside through its own hooks: the batch-start
hook (``_profile_window``) marks the batches and ends a run by raising;
the steps module's phase functions, which the loop calls by name, are
wrapped to count the phases and, in the checked batches, to hand each
phase the benchmark's draws (``train/steps.py``'s ``draws`` convention)
and to keep what it returns; so are its ADA pipe and its generator pass,
to keep the real images as the pipe augmented them for D and Gmain's
images.  The latents of the checked batches are the benchmark's too.

A traced window (``--trace 1``) runs ``host_periods`` periods on the host
clock, then one under ``torch.profiler``, and ends.

The check (``check``), once the loop is freed: the rows the data chain
delivered in the checked batches are matched against the benchmark's own
images, and the plain reference (``reference/train.py``, float32, TF32
off) runs the same batches from the same weights with the same latents
and draws.  ``impl`` 'program' compares
the program; 'control:<kind>' puts a control of the reference in its
place; 'fault:<kind>' breaks the program's phases underneath.
"""

from __future__ import annotations

import gc
import hashlib
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from neube_bench import train_weights as TW
from neube_bench import weights as W
from neube_bench.drivers.stylize import _Phases
from neube_bench.reference import augment as RA
from neube_bench.reference import train as RT
from neube_bench.traffic.train_data import (
    geometry_items, style_images, write_zip,
)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD = os.path.join(ROOT, "build")

# The steps module's phase functions the loop calls, by the phase names of
# the reference.
STEPS = {"Dmain": "d_main_step", "Dr1": "d_reg_step",
         "Gmain": "g_main_step", "Gpl": "g_reg_step", "ada": "ada_update"}
LOSS_STAT = {"Dmain": "Loss/D/loss", "Dr1": "Loss/D/reg",
             "Gmain": "Loss/G/loss", "Gpl": "Loss/G/reg"}
# What a checked phase's run keeps: (kind, the wrapped function whose
# outputs it is, which of its calls in the phase).  Dmain's pipe sees the
# fakes, then the reals.
SEEN = {"Dmain": ("aug", "augment_pipe", 1), "Dr1": ("aug", "augment_pipe", 0),
        "Gmain": ("img", "_run_g", 0)}
CONTROLS = {
    "bf16_all": dict(prec="bf16_all"),
    "below": dict(prec="below"),
    "no_r1_second_order": dict(r1_second_order=False),
    "gpl_half": dict(pl_rows_share=0.5),
    "no_warp": dict(skip_warp=True),
}


class _Stop(Exception):
    """Raised at a batch's start to end ``TrainingLoop.run`` there."""


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _rows(tree, n: int):
    """Every tensor of a draws tree with a leading dimension cut to its
    first ``n`` rows (0-d draws stay)."""
    if isinstance(tree, dict):
        return {k: _rows(v, n) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rows(v, n) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.dim():
        return tree[:n]
    return tree


def _digest(a: np.ndarray) -> bytes:
    return hashlib.blake2b(a.tobytes(), digest_size=16).digest()


class Cell:
    """One training cell (see the module doc)."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device,
                 impl: str = "program"):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.impl = impl
        self.work = None              # this cell's folder of zips and runs
        t = traffic
        self.batch = cfg["batch"]
        self.start = t["start_batch"]
        self.period = t["period_batches"]
        self.n_check = t["check_batches"]
        self.calls = {k: 0 for k in list(STEPS) + ["Ggeom", "snapshot"]}
        self.records: List = []       # (batch, phase, state in, out, stats)
        self.fed: Dict[int, tuple] = {}   # batch -> (style u8, tri u8, crop)
        self.seen = {"aug": {}, "img": {}}    # SEEN's outputs by phase.batch
        self._outputs = None          # a checked phase's wrapped calls' outputs
        self.after_check = None       # the state after the checked batches
        self.period_seconds: List[float] = []
        self.trace_seconds = 0.0
        self.attempted = 0
        self._mode = "setup"
        self._trace_out = None
        self._traced = None

    # -- set-up ----------------------------------------------------------
    def setup(self):
        cfg, t, dev = self.cfg, self.traffic, self.device
        clock = _Phases(self)
        os.makedirs(BUILD, exist_ok=True)
        self.work = tempfile.mkdtemp(prefix="bench_train_", dir=BUILD)
        res = cfg["img_resolution"]
        self.styles = style_images(t["styles"], res, self.seed, t["style"],
                                   dev)
        self.geoms = geometry_items(t["geometries"], res + t["geom_margin"],
                                    self.seed, t["drawing"], dev)
        style_zip = os.path.join(self.work, "styles.zip")
        geom_zip = os.path.join(self.work, "geometry.zip")
        write_zip(style_zip, self.styles)
        write_zip(geom_zip, self.geoms)
        clock("data")
        self.trees = TW.make_training_trees(cfg, self.seed, dev)
        self.draws = self._make_draws()
        clock("weights and draws")
        # TensorBoard, which the loop writes to where it is installed, takes
        # TensorFlow where that is installed, and TensorFlow loads JAX where
        # that is: TensorBoard's own stub of TensorFlow serves instead.
        if "tensorflow" not in sys.modules:
            sys.modules["tensorflow"] = None
        from brushstroke_engine_torch.ops.precision import set_precision_mode
        from brushstroke_engine_torch.tools import train as cli
        set_precision_mode(cfg["precision"])
        argv = list(cfg["flags"]) + [
            "--outdir", os.path.join(self.work, "runs"), "--data", style_zip,
            "--geom_data", geom_zip, "--seed", str(self.seed % 2 ** 31),
            "--device", dev.type]
        self.loop, _ = cli.build(argv)
        self.loop.enc_params = self.trees["enc_params"]
        self.loop.enc_state = self.trees["enc_state"]
        self._place()
        self._instrument()
        clock("build")
        try:
            self._run_to(self.start + self.n_check)
        except BaseException:
            self.free_program()     # the steps module as it was
            raise
        clock("warm-up batches")

    def _place(self):
        """The loop's train state from the seeded weights (Adam's moments,
        the w-average and the path-length mean at zero, as ``--resume``
        leaves them), ADA's p and the counters of ``start_batch``."""
        from brushstroke_engine_torch.train.state import init_train_state
        loop, tr, t, dev = self.loop, self.trees, self.traffic, self.device
        loop.state = init_train_state(
            loop.cfg, 0, g_params=tr["gen_params"], g_state=tr["gen_state"],
            d_params=tr["disc_params"], device=dev)
        loop.state["ada_p"] = torch.full((), float(t["ada_p"]), device=dev)
        loop.cur_nimg = self.start * self.batch
        loop.batch_idx = self.start
        loop.cur_tick = t["start_tick"]

    def run_checked(self):
        """The checked batches on the warm loop, placed again as set-up
        placed it, with the benchmark's latents and draws."""
        self._place()
        self._mode = "check"
        self._run_to(self.start + self.n_check)

    def _make_draws(self) -> List[Dict]:
        """The latents and the phases' draws of the checked batches, from
        the seed: ``[{"z": {phase: [B, z]}, "draws": {phase: draws}}]``."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed + 2 ** 41)
        b, zd = self.batch, cfg["z_dim"]
        pl = b // cfg["pl_batch_shrink"]

        def g_draws(n):
            noise = {}
            for r in W.block_resolutions(cfg):
                for i in ((1,) if r == 4 else (0, 1)):
                    noise[f"b{r}.conv{i}"] = torch.randn(
                        (n, r, r, 1), generator=gen, device=dev)
            return {"mixing": {
                "cutoff_u": torch.rand((), generator=gen, device=dev),
                "apply_u": torch.rand((), generator=gen, device=dev),
                "z2": torch.randn((n, zd), generator=gen, device=dev)},
                "noise": noise}

        out = []
        for k in range(self.n_check):
            idx = self.start + k
            z = {ph: torch.randn((b, zd), generator=gen, device=dev)
                 for ph in ("Dmain", "Gmain", "Gpl")}
            dr = {"Dmain": {"g": g_draws(b),
                            "aug_fake": RA.make_draws(gen, b, dev),
                            "aug_real": RA.make_draws(gen, b, dev)},
                  "Gmain": {"g": g_draws(b), "aug": RA.make_draws(gen, b, dev)}}
            if idx % cfg["d_reg_interval"] == 0:
                dr["Dr1"] = {"aug": RA.make_draws(gen, b, dev)}
            if idx % cfg["g_reg_interval"] == 0:
                res = cfg["img_resolution"]
                dr["Gpl"] = {"g": g_draws(pl), "pl_noise": torch.randn(
                    (pl, res, res, 3), generator=gen, device=dev)}
            out.append({"z": z, "draws": dr})
        return out

    # -- the loop's hooks ------------------------------------------------
    def _instrument(self):
        import brushstroke_engine_torch.train.steps as steps
        loop = self.loop
        self._steps = steps
        self._orig = {name: getattr(steps, name) for name in
                      list(STEPS.values()) + ["augment_pipe", "_run_g"]}
        for ph, name in STEPS.items():
            setattr(steps, name, self._wrap(ph, self._orig[name]))
        for name in ("augment_pipe", "_run_g"):
            setattr(steps, name, self._keep(name, self._orig[name]))
        hook, fetch, normal = loop._profile_window, loop._fetch_batch, \
            loop._host_normal
        z_queue: List = []

        def profile_window(done):
            if not done:
                self._batch_start(loop.batch_idx, z_queue)
            hook(done)

        def fetch_batch():
            out = fetch()
            k = loop.batch_idx - self.start
            if self._mode == "check" and 0 <= k < self.n_check:
                style, tri, crop = out[0], out[1], out[2]
                self.fed[k] = (
                    np.rint((style + 1.0) * 127.5).astype(np.uint8),
                    np.rint(tri * 255.0).astype(np.uint8), crop)
            return out

        def host_normal(n, dim):
            return z_queue.pop(0) if z_queue else normal(n, dim)

        loop._profile_window = profile_window
        loop._fetch_batch = fetch_batch
        loop._host_normal = host_normal
        if loop.geom_step is not None:
            geom = loop.geom_step

            def geom_step(*a, **kw):
                self.calls["Ggeom"] += 1
                return geom(*a, **kw)
            loop.geom_step = geom_step
        snap = loop.save_snapshot

        def save_snapshot():
            self.calls["snapshot"] += 1
            return snap()
        loop.save_snapshot = save_snapshot

    def _wrap(self, phase: str, fn):
        kind = self.impl.split(":", 1)[1] \
            if self.impl.startswith("fault:") else None

        def wrapped(cfg, state, *args, **kw):
            self.calls[phase] += 1
            if phase == "ada":
                return fn(cfg, state, *args, **kw)
            k = self.loop.batch_idx - self.start
            checked = self._mode == "check" and 0 <= k < self.n_check
            if checked:
                self._outputs = {"augment_pipe": [], "_run_g": []}
                kw["draws"] = {**(kw.get("draws") or {}),
                               **self.draws[k]["draws"][phase]}
            if kind == "half_batch" and phase != "Gpl":
                n = self.batch // 2
                args = _rows(list(args[:3 if phase != "Dr1" else 1]), n) + \
                    list(args[3 if phase != "Dr1" else 1:])
                if "draws" in kw:
                    kw["draws"] = {k2: v if k2 == "loss_rng" else _rows(v, n)
                                   for k2, v in kw["draws"].items()}
            new, stats = fn(cfg, state, *args, **kw)
            if checked:
                outputs, self._outputs = self._outputs, None
                if phase in SEEN:
                    what, name, i = SEEN[phase]
                    if i < len(outputs[name]):
                        self.seen[what][f"{phase}.{k}"] = outputs[name][i]
            if kind == "unchanged":
                new = state
            elif kind == "altered" and phase == "Gmain":
                new = self._altered(state, new, f"b{cfg.gen_cfg.img_resolution}")
            if checked:
                self.records.append((k, phase, state, new, stats))
            return new, stats
        return wrapped

    def _keep(self, name: str, fn):
        """``fn`` whose outputs a checked phase keeps (the images: the
        first of a tuple)."""
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if self._outputs is not None:
                img = out[0] if isinstance(out, tuple) else out
                self._outputs[name].append(img.detach().float().clone())
            return out
        return wrapped

    @staticmethod
    def _altered(old, new, block: str):
        """``new`` with the update of one weight of ``block`` doubled."""
        g = dict(new["g_params"])
        syn = dict(g["synthesis"])
        blk = dict(syn[block])
        conv = dict(blk["conv1"])
        before = old["g_params"]["synthesis"][block]["conv1"]["weight"]
        conv["weight"] = before + 2 * (conv["weight"] - before)
        blk["conv1"], syn[block], g["synthesis"] = conv, blk, syn
        return dict(new, g_params=g)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _batch_start(self, idx: int, z_queue: List):
        k = idx - self.start
        if self._mode == "check":
            if k < self.n_check:
                z_queue[:] = [self.draws[k]["z"][ph]
                              for ph in ("Dmain", "Gmain")]
                if "Gpl" in self.draws[k]["draws"]:
                    z_queue.append(self.draws[k]["z"]["Gpl"])
            else:
                z_queue[:] = []
                self.after_check = self.loop.state
        if self._mode != "window":
            if idx >= self._stop_at:
                raise _Stop
            return
        rel = idx - self.w0
        if rel % self.period:
            return
        self._sync()
        now = time.perf_counter()
        n = rel // self.period
        if n:
            self._check_period()
            if self._traced is not None:
                self._traced.__exit__(None, None, None)
                self._traced = None
                self.trace_seconds = now - self._t
                self.attempted += self.period
                raise _Stop
            self.period_seconds.append(now - self._t)
            self.attempted += self.period
        self._counts = dict(self.calls)
        if self._trace_out is not None:
            if n == self.traffic["host_periods"]:
                from neube_bench.trace import traced
                self._traced = traced(self.device.type, self._trace_out)
                self._traced.__enter__()
        elif n >= self.traffic["max_periods"] or (
                n and now - self._t0 >= self._seconds):
            raise _Stop
        self._t = time.perf_counter()

    def _check_period(self):
        """Each period holds its schedule's phases, no Ggeom, no
        snapshot."""
        cfg, p = self.cfg, self.period
        want = {"Dmain": p, "Gmain": p, "Dr1": p // cfg["d_reg_interval"],
                "Gpl": p // cfg["g_reg_interval"],
                "ada": p // cfg["ada_interval"], "Ggeom": 0, "snapshot": 0}
        got = {k: self.calls[k] - self._counts[k] for k in want}
        if got != want:
            raise RuntimeError(f"a timed period ran {got}, not {want}")

    def _run_to(self, stop_at: int):
        self._stop_at = stop_at
        try:
            self.loop.run()
        except _Stop:
            pass
        self._sync()

    # -- window ----------------------------------------------------------
    def window(self, seconds: float, trace_out=None) -> Dict:
        """Whole periods until one ends at or after ``seconds``; with
        ``trace_out`` ``host_periods`` periods, then one traced.  Then the
        checked batches (``run_checked``), outside the window."""
        self._mode = "window"
        self._seconds, self._trace_out = seconds, trace_out
        self.w0 = self.loop.batch_idx
        self._t0 = time.perf_counter()
        try:
            self.loop.run()
        except _Stop:
            pass
        self.run_checked()
        periods = len(self.period_seconds)
        return {"seconds": sum(self.period_seconds),
                "images": periods * self.period * self.batch,
                "periods": periods, "unit_seconds": self.period_seconds}

    def counters(self) -> Dict:
        return {"attempted": self.attempted, "failed": 0,
                "host_seconds": sum(self.period_seconds),
                "host_batches": len(self.period_seconds) * self.period,
                "trace_batches": self.period if self.trace_seconds else 0,
                "batch": self.batch, "period_batches": self.period}

    # -- check -----------------------------------------------------------
    def free_program(self):
        if getattr(self, "_orig", None):
            for name, fn in self._orig.items():
                setattr(self._steps, name, fn)
            self._orig = None
        self.loop = None
        if self.work:
            shutil.rmtree(self.work, ignore_errors=True)
            self.work = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _program_readings(self) -> Dict:
        """What the checked batches returned, in the reference's terms:
        losses, each phase's first gradient (from its Adam moment:
        ``(m' - b1 m) / (1 - b1)``), the change of G and D and the
        w-average after them, and the images the phases kept (``seen``)."""
        cfg = self.cfg
        out = {"loss": {}, "grad": {}}
        for k, ph, old, new, stats in self.records:
            out["loss"][f"{ph}.{k}"] = float(stats[LOSS_STAT[ph]])
            if ph in out["grad"]:
                continue
            net = "d_opt" if ph.startswith("D") else "g_opt"
            interval = cfg["d_reg_interval"] if net == "d_opt" \
                else cfg["g_reg_interval"]
            b1 = RT.lazy_adam(cfg, interval)[1]
            m0, m1 = _flat(old[net]["mu"]), _flat(new[net]["mu"])
            out["grad"][ph] = {n: (m1[n] - b1 * m0[n]) / (1 - b1)
                               for n in m1}
        st, tr = self.after_check, self.trees
        if st is None:
            return None
        g0, d0 = _flat(tr["gen_params"]), _flat(tr["disc_params"])
        g1, d1 = _flat(st["g_params"]), _flat(st["d_params"])
        out["change"] = {"G": {n: g1[n] - g0[n] for n in g0},
                         "D": {n: d1[n] - d0[n] for n in d0}}
        out["w_avg"] = st["w_avg"]
        out.update(self.seen)
        return out

    def _reference_batches(self):
        """The checked batches as the reference takes them, from the
        benchmark's own images: (batches, rows the data chain delivered
        that match none of them)."""
        dev, res = self.device, self.cfg["img_resolution"]
        style_at = {_digest(a): i for i, a in enumerate(self.styles)}
        geom_at = {_digest(a): i for i, a in enumerate(self.geoms)}
        unmatched, batches = 0, []
        for k in range(self.n_check):
            if k not in self.fed:
                return None, self.batch * 2 * self.n_check
            style_u8, tri_u8, (y, x, _, _) = self.fed[k]
            rows_s, rows_g = [], []
            for s, g in zip(style_u8, tri_u8):
                i, j = style_at.get(_digest(s)), geom_at.get(_digest(g))
                unmatched += (i is None) + (j is None)
                rows_s.append(self.styles[i] if i is not None else s)
                rows_g.append(self.geoms[j] if j is not None else g)
            real = torch.from_numpy(np.stack(rows_s)).to(dev).float() \
                / 127.5 - 1.0
            tri = torch.from_numpy(np.stack(rows_g)).to(dev).float() / 255.0
            batches.append({"real": real,
                            "geom": tri[:, y:y + res, x:x + res, 1:2],
                            **self.draws[k]})
        return batches, unmatched

    def _follow(self, batches, kind: str = None) -> Dict:
        knobs = dict(CONTROLS.get(kind, {}))
        prec = RT.precision(self.cfg, knobs.pop("prec", "reference"))
        share = knobs.pop("pl_rows_share", None)
        if share:
            knobs["pl_rows"] = int(self.batch // self.cfg["pl_batch_shrink"]
                                   * share)
        tf32 = prec["tf32"]
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            return RT.follow(self.cfg, self.trees, batches, self.start,
                             float(self.traffic["ada_p"]),
                             RT.Knobs(prec, **knobs))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def check(self) -> Dict[str, float]:
        """The compared numbers (``reference/train.py:compare``) and
        ``feed_rows_unmatched``; more are kept in ``self.diagnostics``."""
        limits = self.traffic["limits"]
        if getattr(self, "_want", None) is None:
            self._batches, self._unmatched = self._reference_batches()
            self._want = None if self._batches is None \
                else self._follow(self._batches)
        batches, unmatched, want = self._batches, self._unmatched, self._want
        if batches is None:
            return {k: float("inf") for k in limits}
        if self.impl.startswith("control:"):
            got = self._follow(batches, self.impl.split(":", 1)[1])
        else:
            got = self._program_readings()
        if got is None:
            return {k: float("inf") for k in limits}
        numbers = RT.compare(got, want)
        numbers["feed_rows_unmatched"] = float(unmatched)
        leaves = {ph: RT.leaf_table(got["grad"][ph], want["grad"][ph])
                  for ph in RT.PHASES if ph in got["grad"]}
        leaves.update({f"change.{n}": RT.leaf_table(got["change"][n],
                                                    want["change"][n])
                       for n in ("G", "D")})
        images = {**RT.image_gaps(got["aug"], want["aug"]),
                  **RT.image_gaps(got["img"], want["img"])}
        self.diagnostics = {**numbers, "images": images, "leaves": leaves}
        return {k: numbers[k] for k in limits}
