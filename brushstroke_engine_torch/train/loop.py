"""Host-side training loop: phase scheduling, data feed, ticks, snapshots.

Counterpart of the unfused single-device branch of
``brushstroke_engine_tpu/train/loop.py``: the same phase machine --
Dmain(1), Dreg(d_reg_interval), Gmain(1), Greg(g_reg_interval), the
optional Gstitch(stitch_interval) and Ggeom(geom_interval), with a separate
Ggeom-warm schedule during the
warm-start kimg -- driving the phase functions of ``train/steps.py``.  This
loop only feeds fixed-shape numpy batches, applies the schedule, updates
ADA p and handles ticks: ``stats.jsonl`` (and TensorBoard events where the
package is installed), the ``on_tick`` hook, and every ``snapshot_ticks``
ticks (and at the end) a network snapshot, the resumable train state and
the ``on_snapshot`` hook.

Per-batch loss scalars stay on the device until the tick boundary: reading
them every batch would stall the launch queue once per scalar.

The train state file (``train_state.pkl``) is the port's own: the state
tree as numpy leaves in the port's layouts (0-d leaves stay 0-d, Adam
counts stay ints), the counters, and both random streams -- the host numpy
generator and the device ``torch.Generator`` -- and the stitch phase's
crop stream (a ``random.Random``; a state file without it starts that stream
from the seed), so that a resumed run goes on as the uninterrupted one
would.

The production path (the JAX loop's ``use_fused`` branch): ``use_fused``
runs each batch as one fused step (``train/fused.py``, one geometry encode,
stats with NaN for the phases that did not run); ``device_banks``
(``train/device_dataset.py``) samples the batch from uint8 banks on the
device, the host drawing only the crop offsets; ``steps_per_dispatch=K``
runs K batches per step call, the crops drawn from the host stream, with
the counters advancing by ``B * K`` and ``K`` and ticks on dispatch
boundaries.  At a tick each stat keeps its most recent finite value (a
chunk's stats are ``[K]``).  ``profile_dir`` writes a ``torch.profiler``
trace of batches ``profile_batches`` (Chrome trace JSON: Perfetto,
TensorBoard's profiler plugin).

Data parallelism (the JAX loop's ``mesh``): ``mesh`` is a group mesh
(``parallel.mesh.make_mesh`` after ``parallel.distributed.
maybe_initialize_distributed``), one card per rank.  The batch size must
divide by the world; the state and the encoder are broadcast from rank 0;
the host iterators give this rank's rows (``infinite_indices(rank=,
num_ranks=)``), the host normals are drawn for the global batch and
sliced, and every step runs under the group's rank context
(``parallel/distributed.py``), so the ranks together take the step one
process takes at the same global batch.  Rank 0 alone writes
``stats.jsonl``, TensorBoard, the snapshots and the train state and runs
the eval hooks; the others wait at a barrier where they must.

``save_train_state`` / ``load_train_state(backend="orbax")``: the JAX
package's tensor-wise backend, for large state and multi-rank saves.  The
name is kept so that callers port unchanged, but the format is
``torch.distributed.checkpoint`` (DCP), not Orbax's: the card's machine has
no ``orbax``.  A directory (default ``run_dir/train_state_orbax``) holds the
state, the counters and the device generator's state, one tensor each;
``<dir>.nprng.pkl`` beside it holds the numpy and stitch streams, as the
JAX package keeps its numpy stream there.  It round-trips bitwise, is
written once under a group (rank 0) and read on every rank, and does not
depend on the world that wrote it: a state saved by 2 ranks resumes in 1,
and the other way round.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import random
import shutil
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from brushstroke_engine_torch.parallel.distributed import rank_context
from brushstroke_engine_torch.parallel.mesh import mean_stats, replicate
from brushstroke_engine_torch.train import steps as train_steps
from brushstroke_engine_torch.train.dataset import (
    geom_batch_to_float, style_batch_to_float,
)
from brushstroke_engine_torch.train.device_dataset import gen_crops
from brushstroke_engine_torch.train.state import TrainConfig, \
    init_train_state
from brushstroke_engine_torch.train.stitching import RandomStitcher
from brushstroke_engine_torch.utils.checkpoint import EngineBundle, \
    save_native
from brushstroke_engine_torch.utils.util import (
    resolve_device, span, tree_map, tree_to,
)

TRAIN_STATE_MAGIC = "brushstroke_engine_torch.train_state.v1"

logger = logging.getLogger(__name__)


@dataclass
class LoopHooks:
    """Optional callbacks invoked at tick time."""
    on_tick: Optional[Callable] = None          # (loop, stats_dict)
    on_snapshot: Optional[Callable] = None      # (loop, snapshot_path)


def _to_numpy(t):
    """A state leaf for the train-state file: tensors become numpy arrays
    of their own shape (0-d stays 0-d), ints stay ints."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True).numpy()
    return t


def _fetch_stats(stats: Dict) -> Dict[str, float]:
    """Host floats of a batch's stats in one transfer: each key keeps its
    most recent finite entry (0-d and ``[K]`` values alike); keys with none
    are dropped."""
    tensors = {k: v for k, v in stats.items() if isinstance(v, torch.Tensor)}
    values = {k: np.asarray([v], np.float64) for k, v in stats.items()
              if k not in tensors}
    if tensors:
        flat = torch.cat([v.detach().reshape(-1).float()
                          for v in tensors.values()]).cpu().numpy()
        at = 0
        for k, v in tensors.items():
            values[k] = flat[at:at + v.numel()].astype(np.float64)
            at += v.numel()
    out = {}
    for k, a in values.items():
        a = a[np.isfinite(a)]
        if a.size:
            out[k] = float(a[-1])
    return out


class TrainingLoop:
    def __init__(self, cfg: TrainConfig, enc_params, enc_state,
                 style_iter, geom_iter, run_dir: str,
                 seed: int = 0, hooks: Optional[LoopHooks] = None,
                 resume_state=None, auto_resume: bool = False,
                 profile_phases: bool = False,
                 use_fused: bool = False, mesh=None, device_banks=None,
                 steps_per_dispatch: int = 1, profile_dir=None,
                 profile_batches=(10, 13), snapshot_ticks: int = 1,
                 device="cuda"):
        if mesh is not None and mesh.group is None and mesh.size > 1:
            raise ValueError("training runs one card per process: make the "
                             "mesh over a process group (make_mesh after "
                             "maybe_initialize_distributed)")
        # One card per rank: rank / num_ranks shard the host data, rank 0
        # persists.  No mesh, or a local mesh of one device: (0, 1).
        self.mesh = mesh
        self._ranks = mesh.ranks() if mesh is not None else None
        self.rank, self.num_ranks = (self._ranks.rank, self._ranks.world) \
            if self._ranks is not None else (0, 1)
        if cfg.batch_size % self.num_ranks:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                             f"{self.num_ranks} ranks")
        if mesh is not None:
            device = mesh.devices[0]
        if device_banks is not None and not use_fused:
            raise ValueError("device_banks requires use_fused=True")
        self.steps_per_dispatch = max(int(steps_per_dispatch), 1)
        if self.steps_per_dispatch > 1 and device_banks is None:
            raise ValueError("steps_per_dispatch > 1 requires device_banks "
                             "(per-step data must live on-device)")
        self.device = resolve_device(device)
        self.device_banks = device_banks
        # A torch.profiler trace of batches profile_batches[0] up to
        # profile_batches[1] (dispatch boundaries with steps_per_dispatch).
        self.profile_dir = profile_dir
        self.profile_batches = tuple(profile_batches)
        self._profiler, self._profile_from = None, 0
        self._profiled = False
        # profile_phases: synchronise after each phase, report its seconds
        # as Timing/<phase> in the tick stats and keep every call's seconds
        # in phase_seconds[<phase>].
        self.profile_phases = profile_phases
        self.phase_seconds: Dict[str, List[float]] = {}
        self.cfg = cfg
        self.enc_params = tree_to(enc_params, self.device)
        self.enc_state = tree_to(enc_state, self.device)
        self.style_iter = style_iter
        self.geom_iter = geom_iter
        self.run_dir = run_dir
        self.hooks = hooks or LoopHooks()
        os.makedirs(run_dir, exist_ok=True)

        self.state = tree_to(resume_state, self.device) \
            if resume_state is not None else \
            init_train_state(cfg, seed, device=self.device)
        if self._ranks is not None:
            # Replicated from rank 0, as the JAX loop replicates over its
            # mesh.
            self.state = replicate(mesh, self.state)
            self.enc_params = replicate(mesh, self.enc_params)
            self.enc_state = replicate(mesh, self.enc_state)
        # Host stream: latents, crops and loss crops.  Device stream: noise
        # planes, style mixing and augment draws, made where they are used.
        self.rng = np.random.default_rng(seed)
        self.device_rng = torch.Generator(device=self.device)
        self.device_rng.manual_seed(seed + 1)
        # The second crop of the stitch phase: a seeded stream of its own,
        # so the other draws are those of a run without stitching.
        self.seed = seed
        self.stitch_rng = random.Random(seed)
        self.stitcher = RandomStitcher()
        self.stitch_on = cfg.stitch_interval > 0 and \
            bool(cfg.losses("stitch").items)

        # With no injected resolution there is no geometry: no encoder
        # pass, no geometry batch, no Ggeom and no warm start.
        self.geometry = bool(cfg.enc_res)
        self.geom_step = train_steps.make_geom_step(cfg, warmstart=False) \
            if self.geometry and cfg.geom_interval > 0 and \
            cfg.losses("geom").items else None
        self.warm_step = train_steps.make_geom_step(cfg, warmstart=True) \
            if self.geometry and cfg.geom_warmstart_kimg > 0 else None
        self.fused_step = None
        if use_fused:
            from brushstroke_engine_torch.train.fused import \
                make_fused_train_step
            self.fused_step = make_fused_train_step(
                cfg, device_data=device_banks is not None, mesh=mesh,
                chunk=self.steps_per_dispatch
                if self.steps_per_dispatch > 1 else 0,
                crop_margin=self.stitcher.crop_margin,
                min_overlap=self.stitcher.min_overlap)

        # Network snapshot and train state every snapshot_ticks ticks (the
        # final tick always persists).
        self.snapshot_ticks = max(int(snapshot_ticks), 1)
        self.cur_nimg = 0
        self.batch_idx = 0
        self.cur_tick = 0
        self.stats_path = os.path.join(run_dir, "stats.jsonl")
        # TensorBoard events beside stats.jsonl, where the package is
        # installed.
        self.tb_writer = None
        if self.rank == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb_writer = SummaryWriter(log_dir=run_dir)
            except ImportError:
                logger.info(
                    "TensorBoard unavailable; writing stats.jsonl only")
        self._last_stats: Dict[str, float] = {}
        self._last_snapshot_sec: Optional[float] = None
        # Eval-hook failures, reported in the tick stats as
        # Eval/<name>_failures, so a broken metric or viz path shows in
        # stats.jsonl and not only in the log.
        self.hook_failure_counts: Dict[str, int] = {}
        if auto_resume and resume_state is None:
            self.load_train_state()

        # Clarity finetune: fake_orig losses compare against the FROZEN
        # original generator (a real copy, taken after any resume).
        self.g_orig_params = None
        needs_orig = (
            self.warm_step is not None and
            cfg.losses("warmstart").require_original_fake_image()
        ) or (
            self.geom_step is not None and
            cfg.losses("geom").require_original_fake_image()
        )
        if needs_orig:
            self.g_orig_params = tree_map(torch.clone,
                                          self.state["g_params"])

    # ------------------------------------------------------------------

    def save_train_state(self, path: Optional[str] = None,
                         backend: str = "pickle") -> str:
        """Write the whole resumable state (see the module doc) to ``path``
        (default ``run_dir/train_state.pkl``, or ``run_dir/
        train_state_orbax`` for ``backend="orbax"``), atomically; under a
        group rank 0 writes and every rank returns once it has."""
        if backend not in ("pickle", "orbax"):
            raise ValueError(f"unknown train-state backend {backend!r}")
        if backend == "orbax":
            path = path or os.path.join(self.run_dir, "train_state_orbax")
            write = self._write_tensorwise
        else:
            path = path or os.path.join(self.run_dir, "train_state.pkl")
            write = self._write_train_state
        if self.rank == 0:
            write(path, self.cur_tick)
        self._barrier()
        return path

    def _barrier(self):
        """Wait for every rank (nothing without a group)."""
        if self._ranks is not None:
            import torch.distributed as dist
            dist.barrier(group=self._ranks.group)

    def _tensorwise_payload(self, cur_tick: int):
        """The flat ``{key: tensor}`` of the tensor-wise backend: the state
        leaves (ints as int64 0-d tensors), the counters and the device
        generator's state."""
        flat = {}

        def walk(t, prefix):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{prefix}/{k}")
            elif isinstance(t, torch.Tensor):
                flat[prefix] = t.detach().to("cpu", copy=True)
            else:
                flat[prefix] = torch.tensor(int(t), dtype=torch.int64)

        walk(self.state, "state")
        for k, v in (("cur_nimg", self.cur_nimg),
                     ("batch_idx", self.batch_idx), ("cur_tick", cur_tick)):
            flat[f"counters/{k}"] = torch.tensor(int(v), dtype=torch.int64)
        flat["rng/device"] = self.device_rng.get_state()
        return flat

    def _write_tensorwise(self, path: str, cur_tick: int) -> str:
        import torch.distributed.checkpoint as dcp
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        dcp.save(self._tensorwise_payload(cur_tick), checkpoint_id=tmp,
                 no_dist=True)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        with open(path + ".nprng.pkl.tmp", "wb") as f:
            pickle.dump({"magic": TRAIN_STATE_MAGIC,
                         "np_rng": self.rng.bit_generator.state,
                         "stitch_rng": self.stitch_rng.getstate()}, f,
                        protocol=4)
        os.replace(path + ".nprng.pkl.tmp", path + ".nprng.pkl")
        return path

    def _load_tensorwise(self, path: str) -> bool:
        import torch.distributed.checkpoint as dcp
        if not os.path.isdir(path):
            return False
        with open(path + ".nprng.pkl", "rb") as f:
            streams = pickle.load(f)
        if streams.get("magic") != TRAIN_STATE_MAGIC:
            raise ValueError(f"not a train state of this package: {path}")
        # The current state is the template: same configuration, same
        # leaves; DCP fills its copies in place.
        flat = {k: torch.empty_like(v)
                for k, v in self._tensorwise_payload(0).items()}
        dcp.load(flat, checkpoint_id=path, no_dist=True)

        def build(t, prefix):
            if isinstance(t, dict):
                return {k: build(v, f"{prefix}/{k}") for k, v in t.items()}
            if isinstance(t, torch.Tensor):
                return flat[prefix].to(self.device)
            return int(flat[prefix])

        self.state = build(self.state, "state")
        self.cur_nimg = int(flat["counters/cur_nimg"])
        self.batch_idx = int(flat["counters/batch_idx"])
        self.cur_tick = int(flat["counters/cur_tick"])
        self.device_rng.set_state(flat["rng/device"])
        self.rng.bit_generator.state = streams["np_rng"]
        self.stitch_rng.setstate(streams["stitch_rng"])
        logger.info("Resumed training state (tensor-wise) at %d kimg",
                    self.cur_nimg // 1000)
        return True

    def _write_train_state(self, path: Optional[str], cur_tick: int) -> str:
        path = path or os.path.join(self.run_dir, "train_state.pkl")
        payload = {
            "magic": TRAIN_STATE_MAGIC,
            "state": tree_map(_to_numpy, self.state),
            "rng_state": {
                "np_rng": self.rng.bit_generator.state,
                "device_rng": self.device_rng.get_state().numpy(),
                "stitch_rng": self.stitch_rng.getstate()},
            "cur_nimg": self.cur_nimg, "batch_idx": self.batch_idx,
            "cur_tick": cur_tick,
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=4)
        os.replace(tmp, path)
        return path

    def load_train_state(self, path: Optional[str] = None,
                         backend: str = "pickle") -> bool:
        """Restore what :meth:`save_train_state` wrote (every rank reads
        it); False if there is none."""
        if backend not in ("pickle", "orbax"):
            raise ValueError(f"unknown train-state backend {backend!r}")
        if backend == "orbax":
            return self._load_tensorwise(
                path or os.path.join(self.run_dir, "train_state_orbax"))
        path = path or os.path.join(self.run_dir, "train_state.pkl")
        if not os.path.isfile(path):
            return False
        with open(path, "rb") as f:
            payload = pickle.load(f)
        if payload.get("magic") != TRAIN_STATE_MAGIC:
            raise ValueError(f"not a train state of this package: {path}")
        self.state = tree_map(
            lambda a: torch.as_tensor(a, device=self.device)
            if isinstance(a, np.ndarray) else a, payload["state"])
        self.cur_nimg = payload["cur_nimg"]
        self.batch_idx = payload["batch_idx"]
        self.cur_tick = payload["cur_tick"]
        self.rng.bit_generator.state = payload["rng_state"]["np_rng"]
        self.device_rng.set_state(
            torch.from_numpy(payload["rng_state"]["device_rng"]))
        stitch = payload["rng_state"].get("stitch_rng")
        if stitch is None:
            self.stitch_rng.seed(self.seed)
        else:
            self.stitch_rng.setstate(stitch)
        logger.info("Resumed training state at %d kimg",
                    self.cur_nimg // 1000)
        return True

    def save_snapshot(self) -> str:
        """A self-contained engine bundle of G_ema and the geometry encoder
        (``network-snapshot-<kimg>.pkl``), through ``save_native``."""
        path = os.path.join(
            self.run_dir,
            f"network-snapshot-{self.cur_nimg // 1000:06d}.pkl")
        save_native(path, EngineBundle(
            gen_cfg=self.cfg.gen_cfg,
            gen_params=self.state["g_ema"],
            gen_state={"w_avg": self.state["w_avg"],
                       "noise": self.state["noise"]},
            enc_cfg=self.cfg.enc_cfg,
            enc_params=self.enc_params,
            enc_state=self.enc_state,
            color_format=self.cfg.gen_cfg.synthesis.color_format,
            geom_inject_resolutions=self.cfg.enc_res,
            extra={"cur_nimg": self.cur_nimg}))
        return path

    def _data(self, x):
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _host_normal(self, n: int, dim: int):
        """``[n, dim]`` normal draw from the host stream, on the device:
        under a group every rank draws the same global array and keeps its
        rows, as the JAX loop does."""
        x = np.asarray(self.rng.standard_normal((n, dim)), np.float32)
        if self.num_ranks > 1:
            local = n // self.num_ranks
            x = x[self.rank * local:(self.rank + 1) * local]
        return self._data(x)

    def _ema_beta(self) -> float:
        ema_nimg = self.cfg.ema_kimg * 1000.0
        if self.cfg.ema_rampup is not None:
            ema_nimg = min(ema_nimg, self.cur_nimg * self.cfg.ema_rampup)
        return float(np.float32(0.5 ** (self.cfg.batch_size /
                                        max(ema_nimg, 1e-8))))

    def in_warmstart(self) -> bool:
        c = self.cfg
        start = c.geom_warmstart_start_kimg * 1000
        return (self.warm_step is not None and self.cur_nimg >= start and
                self.cur_nimg - start < c.geom_warmstart_kimg * 1000)

    # ------------------------------------------------------------------

    def _fetch_batch(self):
        """(style, triband, crop, geometry input, geometry truth) of the
        next batch; without geometry the last four are None."""
        cfg = self.cfg
        res = cfg.gen_cfg.img_resolution
        style_u8 = next(self.style_iter)
        style = style_batch_to_float(style_u8)
        if not self.geometry:
            return style, None, None, None, None
        geom_u8 = next(self.geom_iter)
        tri = geom_batch_to_float(geom_u8)            # [B, H, W, 3]

        # Crop the triband image to training resolution.
        h, w = tri.shape[1:3]
        y = int(self.rng.integers(0, max(h - res, 0) + 1))
        x = int(self.rng.integers(0, max(w - res, 0) + 1))
        crop1 = (y, x, res, res)
        tri_crop = tri[:, y:y + res, x:x + res]

        # Triband channels: G = conditioning input, B = loss target
        # (reference train.py:625-626).
        geom_input = tri_crop[..., 1:2]
        geom_truth = tri_crop[..., 2:3]
        return style, tri, crop1, geom_input, geom_truth

    def _fused_call(self, warm: bool, ema_beta: float):
        """One call of the fused step: a batch, or a chunk of
        ``steps_per_dispatch`` batches.  The host draws the crops: crop1
        from the host stream, crop2 from the stitch stream (a chunk draws
        both from the host stream, ``device_dataset.gen_crops``)."""
        cfg, banks = self.cfg, self.device_banks
        common = dict(rng=self.device_rng, g_orig_params=self.g_orig_params)
        if self.steps_per_dispatch > 1:
            return self.fused_step(
                self.state, self.enc_params, self.enc_state, banks.style,
                banks.tri, self.batch_idx, self.cur_nimg, self.rng, **common)
        if banks is not None:
            crop1, _ = gen_crops(self.rng, banks.tri_hw,
                                 cfg.gen_cfg.img_resolution, False)
            crop2 = self.stitcher.gen_overlapping_square_crop(
                banks.tri_hw[0], crop1, self.stitch_rng) \
                if self.stitch_on else None
            return self.fused_step(
                self.state, self.enc_params, self.enc_state, banks.style,
                banks.tri, self.batch_idx, warm, ema_beta, crop1, crop2,
                host_rng=self.rng, **common)
        style, tri_full, crop1, geom_input, geom_truth = self._fetch_batch()
        stitch = {}
        if self.stitch_on:
            crop2 = self.stitcher.gen_overlapping_square_crop(
                tri_full.shape[1], crop1, self.stitch_rng)
            stitch = dict(
                geom_input2=self._data(
                    tri_full[:, crop2[0]:crop2[0] + crop2[2],
                             crop2[1]:crop2[1] + crop2[3], 1:2]),
                crop1=crop1, crop2=crop2)
        return self.fused_step(
            self.state, self.enc_params, self.enc_state, self._data(style),
            self._data(geom_input), self._data(geom_truth), self.batch_idx,
            warm, ema_beta, host_rng=self.rng, **common, **stitch)

    def _profile_window(self, done: bool):
        """Start the profiler at the first dispatch from
        ``profile_batches[0]`` on; stop it and write the trace at the first
        dispatch boundary from ``profile_batches[1]`` on, or when the run
        ends."""
        if self.profile_dir is None or self._profiled or self.rank != 0:
            return
        start, stop = self.profile_batches
        if self._profiler is not None:
            if done or self.batch_idx >= stop:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._profiler.stop()
                os.makedirs(self.profile_dir, exist_ok=True)
                path = os.path.join(
                    self.profile_dir, f"batches_{self._profile_from}-"
                    f"{self.batch_idx}.pt.trace.json")
                self._profiler.export_chrome_trace(path)
                self._profiler, self._profiled = None, True
                logger.info("Wrote the profiler trace to %s", path)
        elif not done and self.batch_idx >= start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.start()
            self._profile_from = self.batch_idx

    def run(self, total_kimg: Optional[float] = None,
            exit_after_warmstart: bool = False,
            progress_fn: Optional[Callable] = None,
            abort_fn: Optional[Callable] = None):
        """Train until total_kimg.  ``progress_fn(cur_nimg, total_kimg*1000)``
        is called per tick and ``abort_fn() -> bool`` is polled per tick."""
        cfg = self.cfg
        total_kimg = total_kimg if total_kimg is not None else cfg.total_kimg
        tick_start_nimg = self.cur_nimg
        tick_start_time = time.time()
        if progress_fn is not None:
            progress_fn(self.cur_nimg, total_kimg * 1000)
        rng = self.device_rng
        loss_draws = {"loss_rng": self.rng}

        while True:
            self._profile_window(done=False)
            warm = self.in_warmstart()
            stats: Dict = {}
            phase_t0 = [time.time()]

            def note(s, phase=None):
                stats.update(s)
                if self.profile_phases and phase is not None:
                    # Wait for the phase so wall-clock deltas approximate
                    # per-phase time.
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    now = time.time()
                    stats[f"Timing/{phase}"] = now - phase_t0[0]
                    self.phase_seconds.setdefault(phase, []).append(
                        now - phase_t0[0])
                    phase_t0[0] = now

            ema_beta = self._ema_beta()
            bs, zd = cfg.batch_size, cfg.gen_cfg.z_dim

            # Every phase of the batch runs over the group's ranks (the
            # fused step enters the same context itself).
            with rank_context(self._ranks):
                if self.fused_step is None:
                    with span("bse.train.data"):
                        style, tri_full, crop1, geom_input, geom_truth = \
                            self._fetch_batch()
                    feats, geom_truth_t = [], None
                    if self.geometry:
                        feats = train_steps.encode_geometry(
                            cfg, self.enc_params, self.enc_state,
                            self._data(geom_input))
                        geom_truth_t = self._data(geom_truth)
                    phase_t0[0] = time.time()
                if self.fused_step is not None:
                    with span("bse.train.fused"):
                        self.state, s = self._fused_call(warm, ema_beta)
                    note(s, "fused")
                elif warm:
                    z = self._host_normal(bs, zd)
                    with span("bse.train.Ggeom-warm"):
                        self.state, s = self.warm_step(
                            self.state, feats, geom_truth_t, z, rng,
                            ema_beta, g_orig_params=self.g_orig_params,
                            draws=loss_draws)
                    note(s, "Ggeom-warm")
                else:
                    style_t = self._data(style)
                    z = self._host_normal(bs, zd)
                    with span("bse.train.Dmain"):
                        self.state, s = train_steps.d_main_step(
                            cfg, self.state, style_t, feats, z, rng)
                    note(s, "Dmain")
                    if cfg.d_reg_interval > 0 and \
                            self.batch_idx % cfg.d_reg_interval == 0:
                        with span("bse.train.Dr1"):
                            self.state, s = train_steps.d_reg_step(
                                cfg, self.state, style_t, rng)
                        note(s, "Dreg")
                    z = self._host_normal(bs, zd)
                    with span("bse.train.Gmain"):
                        self.state, s = train_steps.g_main_step(
                            cfg, self.state, feats, geom_truth_t, z, rng,
                            ema_beta, draws=None
                            if train_steps._num_rounds(cfg, z.shape[0]) > 1
                            else loss_draws)
                    note(s, "Gmain")
                    if cfg.g_reg_interval > 0 and \
                            self.batch_idx % cfg.g_reg_interval == 0:
                        z = self._host_normal(bs, zd)
                        with span("bse.train.Gpl"):
                            self.state, s = train_steps.g_reg_step(
                                cfg, self.state, feats, z, rng, ema_beta)
                        note(s, "Greg")
                    if self.stitch_on and \
                            self.batch_idx % cfg.stitch_interval == 0:
                        crop2 = self.stitcher.gen_overlapping_square_crop(
                            tri_full.shape[1], crop1, self.stitch_rng)
                        g2 = tri_full[:, crop2[0]:crop2[0] + crop2[2],
                                      crop2[1]:crop2[1] + crop2[3], 1:2]
                        z = self._host_normal(bs, zd)
                        with span("bse.train.Gstitch"):
                            feats2 = train_steps.encode_geometry(
                                cfg, self.enc_params, self.enc_state,
                                self._data(g2))
                            self.state, s = train_steps.g_stitch_step(
                                cfg, self.state, feats, feats2, z, crop1,
                                crop2, rng, ema_beta, stitcher=self.stitcher)
                        note(s, "Gstitch")
                    if self.geom_step is not None and \
                            self.batch_idx % cfg.geom_interval == 0:
                        z = self._host_normal(bs, zd)
                        with span("bse.train.Ggeom"):
                            self.state, s = self.geom_step(
                                self.state, feats, geom_truth_t, z, rng,
                                ema_beta, g_orig_params=self.g_orig_params,
                                draws=loss_draws)
                        note(s, "Ggeom")
                    if cfg.augment is not None and \
                            self.batch_idx % cfg.ada_interval == 0 and \
                            self.batch_idx > 0:
                        with span("bse.train.ada"):
                            self.state = train_steps.ada_update(
                                cfg, self.state,
                                float(cfg.batch_size * cfg.ada_interval))
                        note({}, "ada")

            self.cur_nimg += cfg.batch_size * self.steps_per_dispatch
            self.batch_idx += self.steps_per_dispatch
            self._last_stats = stats

            finishing_warm = warm and not self.in_warmstart()
            done = self.cur_nimg >= total_kimg * 1000 or \
                (finishing_warm and exit_after_warmstart)
            if not done and self.cur_nimg < tick_start_nimg + \
                    cfg.kimg_per_tick * 1000:
                continue

            # ---- tick maintenance ----
            tick_time = time.time() - tick_start_time
            # One readback per tick: each key keeps its most recent finite
            # value (the fused step reports NaN for the phases it skipped,
            # and a chunk's stats are [K]).
            if self.fused_step is None:
                with rank_context(self._ranks):
                    stats = mean_stats(stats)
            stats = _fetch_stats(stats)
            stats["Progress/tick"] = self.cur_tick
            stats["Progress/kimg"] = self.cur_nimg / 1e3
            stats["Progress/ada_p"] = float(self.state["ada_p"])
            stats["Timing/sec_per_tick"] = tick_time
            stats["Timing/sec_per_kimg"] = tick_time / max(
                (self.cur_nimg - tick_start_nimg) / 1000.0, 1e-8)
            if self._last_snapshot_sec is not None:
                # The previous persisting tick's cost (it runs after the
                # stats are written, so it is reported one tick late).
                stats["Timing/snapshot_sec"] = self._last_snapshot_sec
                self._last_snapshot_sec = None
            for name, cnt in self.hook_failure_counts.items():
                stats[f"Eval/{name}_failures"] = cnt
            if self.rank == 0:
                with open(self.stats_path, "a") as f:
                    f.write(json.dumps(stats) + "\n")
            if self.tb_writer is not None:
                for k, v in stats.items():
                    self.tb_writer.add_scalar(k, v, self.cur_nimg)
                self.tb_writer.flush()
            logger.info("tick %d kimg %.1f %s", self.cur_tick,
                        self.cur_nimg / 1e3,
                        {k: round(v, 4) for k, v in list(stats.items())[:6]})
            if self.hooks.on_tick is not None and self.rank == 0:
                self.hooks.on_tick(self, stats)
            if progress_fn is not None:
                progress_fn(self.cur_nimg, total_kimg * 1000)
            if abort_fn is not None and abort_fn():
                logger.info("Aborting at user request (abort_fn)")
                done = True

            # Rank 0 persists (the state is replicated); the others wait
            # for the files.
            if done or self.cur_tick % self.snapshot_ticks == 0:
                if self.rank == 0:
                    t_snap = time.time()
                    snap_path = self.save_snapshot()
                    # A resumed run starts at the next tick, so that it does
                    # not repeat this tick's number.
                    self._write_train_state(None, self.cur_tick + 1)
                    self._last_snapshot_sec = time.time() - t_snap
                    if self.hooks.on_snapshot is not None:
                        self.hooks.on_snapshot(self, snap_path)
                self._barrier()

            self.cur_tick += 1
            tick_start_nimg = self.cur_nimg
            tick_start_time = time.time()
            if done:
                self._profile_window(done=True)
                if self.tb_writer is not None:
                    # Ends the writer's thread; a later run() reopens it.
                    self.tb_writer.close()
                return self.state
