"""Where a training batch's time goes on the GPU.

Traces the canonical training configuration (``flagship_train_config``:
128 px, batch 64, strict f32, ADA 'bgc', random weights from a seed,
synthetic data) with ``torch.profiler`` (CPU and CUDA activities) over a few
steady batches of ``TrainingLoop.run``, and prints the wall time per batch,
the device's busy time and idle share, and the kernels that take the most
device time; the hand-written kernels are listed apart.  The full table goes
to ``<out_dir>/profile_train[_shapes][_cudnn_benchmark].txt`` (default
``build/profile``).

    python3 -m brushstroke_engine_torch.tools.profile_train [--batches N]
        [--out_dir DIR] [--shapes] [--cudnn_benchmark]

``--shapes`` also lists the convolution calls that take the most device time
by input shape (recording shapes adds host time, so the wall time and idle
share of such a run read higher).  ``--cudnn_benchmark`` lets cuDNN time its
algorithms per shape (``torch.backends.cudnn.benchmark``), as a diagnostic
reading beside the default heuristics; the trainer itself does not set it.

The traced window starts at batch 16, so with ``--batches 4`` it holds one
Dr1, one Gpl, one Ggeom (interval 8 here) and four Dmain and Gmain phases.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from brushstroke_engine_torch.flagship import (
    flagship_train_config, flagship_train_setup, synthetic_data_iters,
)
from brushstroke_engine_torch.ops.precision import set_precision_mode
from brushstroke_engine_torch.train.loop import TrainingLoop

RES, BATCH, WARMUP_BATCHES = 128, 64, 16
OWN_KERNELS = ("fir4_epilogue", "resample_gather", "warp_fused")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--out_dir", default="build/profile")
    p.add_argument("--shapes", action="store_true")
    p.add_argument("--cudnn_benchmark", action="store_true")
    args = p.parse_args(argv)
    tag = "train" + ("_shapes" if args.shapes else "") \
        + ("_cudnn_benchmark" if args.cudnn_benchmark else "")
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    set_precision_mode("strict")
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    cfg = flagship_train_config(RES, BATCH, geom_warmstart_kimg=0,
                                geom_interval=8,
                                kimg_per_tick=BATCH / 1000.0)
    state, enc_p, enc_s = flagship_train_setup(cfg, 0, 0.1, "cuda")
    state["ada_p"] = torch.full((), 0.5, device="cuda")
    style_iter, geom_iter = synthetic_data_iters(RES, BATCH, 0)
    run_dir = tempfile.mkdtemp(prefix="profile_train_")
    try:
        loop = TrainingLoop(cfg, enc_p, enc_s, style_iter, geom_iter, run_dir,
                            seed=0, resume_state=state, device="cuda")
        loop.run(total_kimg=(WARMUP_BATCHES * BATCH - 0.5) / 1000.0)
        torch.cuda.synchronize()
        n = args.batches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=args.shapes) as prof:
            t0 = time.perf_counter()
            loop.run(total_kimg=((WARMUP_BATCHES + n) * BATCH - 0.5) / 1000.0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, cnt = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), cnt + 1)
    busy_ms = sum(us for us, _ in per_name.values()) / 1e3 / n
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")

    def rows(items):
        return [{"name": k[:100], "ms_per_batch": us / 1e3 / n,
                 "share": us / 1e3 / n / busy_ms, "launches_per_batch": c / n}
                for k, (us, c) in items]

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    convs = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                    if "convolution" in e.key and device_us(e) > 0),
                   key=lambda e: -device_us(e))[:10] if args.shapes else []
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    result = {"config": "train_128px_b64_f32", "card": card, "batches": n,
              "cudnn_benchmark": args.cudnn_benchmark,
              "record_shapes": args.shapes,
              "first_batch": WARMUP_BATCHES, "wall_ms_per_batch": wall_ms,
              "device_busy_ms_per_batch": busy_ms,
              "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
              "top_kernels": rows(ranked[:15]),
              "own_kernels": rows([kv for kv in ranked if any(
                  o in kv[0] for o in OWN_KERNELS)]),
              "top_convolutions": [
                  {"op": e.key, "input_shapes": str(e.input_shapes)[:160],
                   "ms_per_batch": device_us(e) / 1e3 / n,
                   "calls_per_batch": e.count / n} for e in convs]}
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, f"profile_{tag}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=80))
    with open(os.path.join(args.out_dir, f"profile_{tag}.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
