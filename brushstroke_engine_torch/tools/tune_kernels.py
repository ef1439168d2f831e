"""Tile and band sweeps of the hand-written kernels and a quick check of
each, on the GPU.

Builds the kernels (printing ``ptxas``'s register and spill counts), holds
the FIR-epilogue kernel, the warp W (with every column band) and its
transpose against their plain versions at a few awkward shapes, and times
W and W^T at the trainer's shapes: call time, and device time per launch
from the profiler.  Without ``--check_only`` it then sweeps W's column band
at ``[64,128,128,3]`` and ``[8,64,64,3]`` (device time per band beside the
band ``fused_band`` in ``csrc/warp_twopass.cu`` picks, which was set from
this table), and times the FIR-epilogue kernel at the shapes the render
(B = 16 and B = 1, f32 and bf16) and the trainer (B = 64, f32) launch, for
every ``(xw, strip)`` tile the kernel has -- columns per thread, output
rows per strip -- beside the tile it picks itself and the byte bound.  The
kernel's own choice (``dispatch`` in ``csrc/fir4_epilogue.cu``) was set
from that table.

    python3 -m brushstroke_engine_torch.tools.tune_kernels [--check_only]
        [--out_dir DIR]

Needs a CUDA device.  Results go to ``<out_dir>/tune_kernels.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from brushstroke_engine_torch.ops import cuda_build
from brushstroke_engine_torch.ops import fir_epilogue as fe
from brushstroke_engine_torch.ops import warp as tw
from brushstroke_engine_torch.ops.filters import setup_filter

HBM_BYTES_PER_S = 3.35e12
F = setup_filter([1, 3, 3, 1])
GAIN, CLAMP = 2 ** 0.5, 256.0


def cuda_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fir_inputs(b, h, w, c, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((b, h + 3, w + 3, c), generator=gen, device="cuda")
         * 2).to(dtype)
    d = torch.rand((b, c), generator=gen, device="cuda") * 0.5 + 0.7
    noise = torch.randn((b, h, w, 1), generator=gen, device="cuda")
    bias = torch.randn((c,), generator=gen, device="cuda")
    return x, d, noise, bias


def check_fir():
    taps = fe.cached_taps(F)
    worst = 0.0
    for shape in ((2, 13, 9, 20), (3, 5, 7, 5), (2, 1, 1, 8), (1, 8, 8, 128),
                  (2, 37, 66, 64), (16, 64, 64, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            x, d, noise, bias = fir_inputs(*shape, dtype)
            want = fe.fir4_epilogue_plain(x, taps, d, noise, bias, GAIN,
                                          CLAMP)
            tiles = [(0, 0)] + [(xw, st) for xw in (1, 2)
                                for st in (1, 3, 8, 64)]
            for tile in tiles:
                got = fe._launch_kernel(x, taps, d, noise, bias, GAIN, CLAMP,
                                        0.2, dtype, tile=tile)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs()
                rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
                if bool((err > rtol * want.float().abs() + 1e-5).any()):
                    raise RuntimeError(f"fir4 {shape} {dtype} tile {tile}: "
                                       f"max err {err.max().item():.3e}")
                if dtype == torch.float32:
                    worst = max(worst, err.max().item())
    print(f"[check] fir4_epilogue: every shape, dtype and tile within "
          f"tolerance (f32 max abs err {worst:.3e})", flush=True)


def stress_pack(rng, n):
    """Twelve scalar packs whose pass slopes are steep, flat, exactly 0 or
    next to 0, with random cross terms and far offsets."""
    b = 12
    sc = np.zeros((b, 8), np.float32)
    slopes = [1.0, -1.0, 1e-7, 0.013, 0.4, 3.7, -2.2, 1.3, 0.0, 40.0,
              -0.7, 1.0]
    for i in range(b):
        a1 = slopes[i]
        e2 = slopes[(i + 5) % b] or 1e-6
        sc[i] = (a1, rng.uniform(-1, 1), rng.uniform(-2 * n, 2 * n),
                 max(abs(a1), 1.0), rng.uniform(-1, 1), e2,
                 rng.uniform(-2 * n, 2 * n), max(abs(e2), 1.0))
    return torch.from_numpy(sc).cuda()


def check_warp():
    """W with its own band and every forced band (ragged last bands, one
    band wider than N) at awkward N and C, twice for equal bits."""
    rng = np.random.RandomState(1)
    worst = 0.0
    for n, c in ((67, 5), (128, 3), (8, 1), (33, 11)):
        sc_t = stress_pack(rng, n)
        x = torch.from_numpy(rng.randn(len(sc_t), n, n, c)
                             .astype(np.float32)).cuda()
        want = tw.warp_twopass_plain(x, sc_t)
        for band in (0, 1, 2, 3, 5, 8, 16, 32, 64, 128):
            got = tw._launch(x, sc_t, False, band=band)
            torch.cuda.synchronize()
            err = (got - want).abs()
            if bool((err > 2e-5 * want.abs() + 2e-5).any()):
                bad = err.amax(dim=(1, 2, 3)).tolist()
                raise RuntimeError(f"W n={n} c={c} band={band}: max err per "
                                   f"sample {bad}")
            if not torch.equal(got, tw._launch(x, sc_t, False, band=band)):
                raise RuntimeError(f"W n={n} c={c} band={band}: two calls "
                                   f"differ")
            worst = max(worst, err.max().item())
    print(f"[check] warp_twopass: every band within tolerance and bit-stable "
          f"(max abs err {worst:.3e})", flush=True)


def check_warp_t():
    rng = np.random.RandomState(0)
    worst = 0.0
    for n, c in ((67, 5), (128, 3), (8, 1)):
        sc_t = stress_pack(rng, n)
        b = len(sc_t)
        g = torch.from_numpy(rng.randn(b, n, n, c).astype(np.float32)).cuda()
        got = tw.warp_twopass_t(g, sc_t)
        torch.cuda.synchronize()
        want = tw.warp_twopass_t_plain(g, sc_t)
        err = (got - want).abs()
        if bool((err > 2e-4 * want.abs() + 2e-4).any()):
            bad = err.amax(dim=(1, 2, 3)).tolist()
            raise RuntimeError(f"W^T n={n} c={c}: max err per sample {bad}")
        if not torch.equal(got, tw.warp_twopass_t(g, sc_t)):
            raise RuntimeError(f"W^T n={n}: two calls differ")
        worst = max(worst, err.max().item())
    print(f"[check] warp_twopass_t: within tolerance and bit-stable (max abs "
          f"err {worst:.3e})", flush=True)


def sweep_fir():
    taps = fe.cached_taps(F)
    rows = []
    shapes = [(16, 256, 64), (16, 128, 128), (16, 64, 128), (16, 32, 128),
              (64, 128, 128), (64, 64, 128), (64, 32, 128), (64, 8, 128),
              (1, 256, 64), (1, 64, 128), (1, 8, 128)]
    for b, res, c in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            if b == 64 and dtype == torch.bfloat16:
                continue
            x, d, noise, bias = fir_inputs(b, res, res, c, dtype)
            n_out = b * res * res * c
            nbytes = (x.numel() + n_out) * x.element_size() \
                + 4 * (noise.numel() + d.numel() + bias.numel())
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            iters = 30 if n_out > 2 ** 24 else 100
            times = {}
            for xw in (1, 2):
                for strip in (1, 2, 4, 8, 16, 32, 64, 128, 256):
                    if strip > res:
                        continue
                    times[f"{xw}x{strip}"] = cuda_ms(
                        lambda: fe._launch_kernel(
                            x, taps, d, noise, bias, GAIN, CLAMP, 0.2, dtype,
                            tile=(xw, strip)), iters)
            auto = cuda_ms(lambda: fe._launch_kernel(
                x, taps, d, noise, bias, GAIN, CLAMP, 0.2, dtype), iters)
            best = min(times, key=times.get)
            row = {"shape": [b, res, res, c],
                   "dtype": str(dtype).replace("torch.", ""),
                   "bound_ms": bound, "auto_ms": auto,
                   "auto_over_bound": auto / bound, "best_tile": best,
                   "best_ms": times[best], "tiles_ms": times}
            rows.append(row)
            print("[sweep] " + json.dumps(row), flush=True)
    return rows


def device_us(fn, reps=20):
    """Mean device time (us) of each warp kernel that ``reps`` calls of
    ``fn`` launch, by kernel name, from the profiler (event times include
    the wrapper's host cost where the kernels are short)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for mark in ("warp_fused", "resample_gather"):
            if mark in e.name:
                key = e.name[e.name.index(mark):][:40]
                per_kernel.setdefault(key, []).append(
                    e.time_range.elapsed_us())
    return {k: sum(v) / len(v) for k, v in per_kernel.items()}


def ada_case(b, n, seed=2):
    """``[b, n, n, 3]`` images and the scalar packs of the ADA 'bgc'
    matrices at p = 1, antialias, as the trainer warps them."""
    from brushstroke_engine_torch.train import augment as taug
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cfg = taug.AugmentConfig.from_spec("bgc")
    draws = taug.draw_augment(cfg, gen, b, (n, n, 3), "cuda")
    mat = torch.linalg.inv_ex(taug.geometric_matrix(
        cfg, draws, b, n, n, torch.tensor(1.0, device="cuda"))).inverse
    x = torch.randn((b, n, n, 3), generator=gen, device="cuda")
    imgs, sc = taug._twopass_prep(x, mat, True)
    return imgs.contiguous(), sc.contiguous()


def warp_bound_ms(imgs, sc):
    return (2 * imgs.numel() + sc.numel()) * 4 / HBM_BYTES_PER_S * 1e3


def time_warp():
    rows = []
    for b, n in ((64, 128), (8, 64)):
        imgs, sc = ada_case(b, n)
        row = {"shape": [b, n, n, 3], "band": tw.warp_band(b, n, 3),
               "w_ms": cuda_ms(lambda: tw.warp_twopass(imgs, sc), 50),
               "wt_ms": cuda_ms(lambda: tw.warp_twopass_t(imgs, sc), 50),
               "bound_ms": warp_bound_ms(imgs, sc),
               "device_us": {**device_us(lambda: tw.warp_twopass(imgs, sc)),
                             **device_us(
                                 lambda: tw.warp_twopass_t(imgs, sc))}}
        rows.append(row)
        print("[warp] " + json.dumps(row), flush=True)
    return rows


def sweep_warp():
    """W's device time per column band at the trainer's shape and the small
    one, beside the band the kernel picks."""
    rows = []
    for b, n in ((64, 128), (8, 64)):
        imgs, sc = ada_case(b, n)
        times = {}
        for band in (1, 2, 4, 8, 16, 32, 64, 128):
            if band <= n:
                us = device_us(lambda: tw._launch(imgs, sc, False, band=band))
                times[band] = sum(us.values())
        auto = tw.warp_band(b, n, 3)
        best = min(times, key=times.get)
        row = {"shape": [b, n, n, 3],
               "bound_us": warp_bound_ms(imgs, sc) * 1e3, "auto_band": auto, "auto_us": times.get(auto),
               "best_band": best, "best_us": times[best], "bands_us": times}
        rows.append(row)
        print("[warp-sweep] " + json.dumps(row), flush=True)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--check_only", action="store_true")
    p.add_argument("--out_dir", default="build/tune")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_kernels needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for name, rep in cuda_build.build_all().items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line \
                    or "Compiling entry" in line:
                print(f"[build] {name}: {line.strip()[:160]}")
    check_fir()
    check_warp()
    check_warp_t()
    warp_rows = time_warp()
    band_rows = [] if args.check_only else sweep_warp()
    rows = [] if args.check_only else sweep_fir()
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "tune_kernels.json"), "w") as f:
        json.dump({"card": card, "warp": warp_rows, "warp_bands": band_rows,
                   "fir4_epilogue": rows}, f, indent=1)


if __name__ == "__main__":
    main()
