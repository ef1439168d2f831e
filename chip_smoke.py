#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``brushstroke_engine_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. The card: needs CUDA; prints ``nvidia-smi``'s name and power limit.
2. Builds every hand-written kernel from ``brushstroke_engine_torch/csrc``.
3. Kernel vs plain version on the card: the FIR-epilogue kernel at the six
   ``conv0`` shapes of the 256-px flagship at B=16, f32 and bf16, without
   noise, with per-sample noise and with one noise plane for the batch, with
   and without clamp, against ``fir4_epilogue_plain``; then the
   kernel's, the plain version's and a library yardstick's times beside the
   memory bound.
4. The main path: the 256-px flagship (random weights from a seed, through
   ``init_native_params`` -> ``params_from_jax``) renders through
   ``TriadGanPaintEngine.render_stroke`` (z style, canvas position, UVS
   mapping, clear and full modes, color override) and ``render_batch``
   (B=16, strict f32 and bf16 blocks); checks shapes, finiteness, range and
   the kernel's launch count, and the f32 render against the same request
   rendered on the CPU.
5. Prints the kernel table as JSON, then the final JSON line.

It imports nothing of JAX and nothing of ``brushstroke_engine_tpu``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
BATCH = 16
RES = 256
SEED = 0
NOISE_STRENGTH = 0.1           # init leaves it 0; non-zero so noise counts

# Kernel vs plain tolerances (stated before any run):
#   f32: |k - p| <= 1e-5 * |p| + 1e-5 -- the same f32 math, only the order
#        of the 16-term FIR sum differs (1e-5 abs floor for outputs near 0).
#   bf16: |k - p| <= 2^-7 * |p| + 1e-5 -- both round one f32 value to bf16
#        once; a reordered sum can move it across one rounding boundary,
#        i.e. one bf16 ulp (<= 2^-7 relative).
F32_RTOL, BF16_RTOL, ATOL = 1e-5, 2.0 ** -7, 1e-5
# CUDA (TF32 off) vs CPU render of the same request, RGBA in [0, 1]: 1e-3
# abs -- cuDNN's f32 conv algorithms sum in other orders than the CPU's
# through the encoder and 13 synthesis layers; uint8 within 1 LSB.
RENDER_ATOL = 1e-3


def fail(msg):
    raise RuntimeError(msg)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
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


def phase_card():
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available: the port's smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def phase_build():
    from brushstroke_engine_torch.ops import cuda_build
    t0 = time.time()
    reports = cuda_build.build_all()
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {sorted(cuda_build.SOURCES)} in {time.time() - t0:.1f} s",
          flush=True)


def _fir_inputs(res, channels, dtype, noise_batch, gen):
    """``noise_batch``: None (no noise), BATCH (one plane per sample) or 1
    (one plane for the whole batch, as the sfactor pass sends it)."""
    import torch
    dev = "cuda"
    x = (torch.randn((BATCH, res + 3, res + 3, channels), generator=gen,
                     device=dev) * 2).to(dtype)
    d = torch.rand((BATCH, channels), generator=gen, device=dev) * 0.5 + 0.7
    noise = None if noise_batch is None else torch.randn(
        (noise_batch, res, res, 1), generator=gen, device=dev)
    bias = torch.randn((channels,), generator=gen, device=dev)
    return x, d, noise, bias


def _library_fir(x, taps_w, d, noise, bias, act_gain, clamp):
    """Yardstick only (the port never calls it): cuDNN depthwise conv on the
    channels_last view in the input's dtype, then torch elementwise ops."""
    import torch.nn.functional as F
    y = F.conv2d(x.permute(0, 3, 1, 2), taps_w, groups=x.shape[-1])
    y = y * d.to(y.dtype)[:, :, None, None]
    if noise is not None:
        y = y + noise.permute(0, 3, 1, 2).to(y.dtype)
    y = F.leaky_relu(y + bias.to(y.dtype)[None, :, None, None], 0.2)
    y = y * act_gain
    return y.clamp_(-clamp, clamp) if clamp is not None else y


def phase_kernel_vs_plain():
    import torch
    from brushstroke_engine_torch.flagship import flagship_generator_config
    from brushstroke_engine_torch.ops import fir_epilogue as fe
    from brushstroke_engine_torch.ops.filters import setup_filter

    syn = flagship_generator_config(RES).synthesis
    f = setup_filter([1, 3, 3, 1])
    taps = fe.correlation_taps(f)
    act_gain = 2 ** 0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rows = []
    for res in syn.block_resolutions[1:]:
        c = syn.channels(res)
        for dtype in (torch.float32, torch.bfloat16):
            rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
            for noise_batch in (None, BATCH, 1):
                for clamp in (256.0, None):
                    x, d, noise, bias = _fir_inputs(res, c, dtype,
                                                    noise_batch, gen)
                    got = fe.fir4_epilogue(x, f, d, noise, bias, act_gain,
                                           clamp, out_dtype=dtype)
                    want = fe.fir4_epilogue_plain(x, taps, d, noise, bias,
                                                  act_gain, clamp,
                                                  out_dtype=dtype)
                    torch.cuda.synchronize()
                    check(got.shape == (BATCH, res, res, c),
                          f"kernel shape {tuple(got.shape)}")
                    err = (got.float() - want.float()).abs()
                    bad = err > rtol * want.float().abs() + ATOL
                    check(not bool(bad.any()),
                          f"kernel != plain at res {res} {dtype} noise "
                          f"batch {noise_batch} clamp={clamp}: max err "
                          f"{err.max().item():.3e}")
                    max_err[dtype] = max(max_err[dtype], err.max().item())
            # Timing in the render's configuration: noise and clamp on.
            x, d, noise, bias = _fir_inputs(res, c, dtype, BATCH, gen)
            taps_w = torch.as_tensor(taps, device="cuda").to(dtype)[
                None, None].expand(c, 1, 4, 4)
            iters = 200 if res <= 64 else 50
            k_ms = cuda_ms(lambda: fe.fir4_epilogue(
                x, f, d, noise, bias, act_gain, 256.0, out_dtype=dtype),
                iters)
            p_ms = cuda_ms(lambda: fe.fir4_epilogue_plain(
                x, taps, d, noise, bias, act_gain, 256.0, out_dtype=dtype),
                iters)
            l_ms = cuda_ms(lambda: _library_fir(
                x, taps_w, d, noise, bias, act_gain, 256.0), iters)
            n_out = BATCH * res * res * c
            nbytes = (x.numel() * x.element_size() + n_out * x.element_size()
                      + noise.numel() * 4 + d.numel() * 4 + bias.numel() * 4)
            flops = n_out * (16 * 2 + 6)   # FIR FMAs + scale/noise/bias/act
            b_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
            row = {"res": res, "channels": c, "batch": BATCH,
                   "dtype": str(dtype).replace("torch.", ""),
                   "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                   "bound_ms": b_ms, "bytes": nbytes, "flops": flops,
                   "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                   >= flops / F32_FLOPS_PER_S else "operations"}
            rows.append(row)
            print("[fir4] " + json.dumps(row), flush=True)
    print(f"[fir4] all 72 kernel-vs-plain cases within tolerance; max abs "
          f"err f32 {max_err[torch.float32]:.3e}, bf16 "
          f"{max_err[torch.bfloat16]:.3e}", flush=True)
    return rows, max_err


def _stroke_patch(width):
    import numpy as np
    from brushstroke_engine_torch.data.curated_geometry import \
        curated_geometry_patch
    geom = curated_geometry_patch("curve", 9, width)     # 1 = background
    patch = np.zeros((width, width, 4), np.uint8)
    patch[..., 3] = np.round((1.0 - geom) * 255).astype(np.uint8)
    return patch


def _engine(num_bf16_res, device, trees):
    from brushstroke_engine_torch.flagship import flagship_engine
    return flagship_engine(trees, RES, num_bf16_res, device)


def _stroke_opts(engine):
    import numpy as np
    from brushstroke_engine_torch.engine.brush import GanBrushOptions
    opts = GanBrushOptions(
        primary_color=np.array([220, 40, 60], np.uint8))
    opts.set_style(engine.random_style(7), style_id=7)
    opts.set_position(x=1000, y=333)
    opts.enable_uvs_mapping = True
    return opts


def _batch_opts(engine, n):
    import numpy as np
    from brushstroke_engine_torch.engine.brush import GanBrushOptions
    out = []
    for i in range(n):
        o = GanBrushOptions(secondary_color=np.array([0, 90, 200], np.uint8)
                            if i % 2 else None)
        o.set_style(engine.random_style(100 + i))
        o.set_position(x=37 * i, y=1000 - 11 * i)
        out.append(o)
    return out


def phase_main_path():
    import numpy as np
    import torch
    from brushstroke_engine_torch.flagship import flagship_trees
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    from brushstroke_engine_torch.ops.precision import set_precision_mode

    set_precision_mode("strict")
    trees = flagship_trees(RES, SEED, NOISE_STRENGTH)
    engine = _engine(0, "cuda", trees)
    patch = _stroke_patch(RES)
    n_up = len(engine.gen_cfg.synthesis.block_resolutions) - 1   # 6
    geoms = np.stack([engine.prepare_geom_input(np.roll(patch, 8 * i, 1))[0]
                      for i in range(BATCH)])

    fir4_epilogue.launches = 0            # main path starts here
    passes = 0

    out = {}
    for mode in ("clear", "full"):
        engine.set_render_mode(mode)
        opts = _stroke_opts(engine)
        before = fir4_epilogue.launches
        rgba_u8, _ = engine.render_stroke(patch, None, opts)
        torch.cuda.synchronize()
        # clear: the sfactor pass of a new style, then the render.
        new = 2 if mode == "clear" else 1
        passes += new
        check(fir4_epilogue.launches - before == n_up * new,
              f"{mode}: {fir4_epilogue.launches - before} kernel launches "
              f"for {new} generator pass(es), want {n_up * new}")
        check(rgba_u8.shape == (RES, RES, 4) and rgba_u8.dtype == np.uint8,
              f"render_stroke output {rgba_u8.shape} {rgba_u8.dtype}")
        rgba = engine._run_core(engine.prepare_geom_input(patch), opts)["rgba"]
        passes += 1
        rgba = rgba[0].float().cpu().numpy()
        check(np.isfinite(rgba).all(), f"{mode}: non-finite RGBA")
        check(rgba.min() >= -1e-6 and rgba.max() <= 1 + 1e-6,
              f"{mode}: RGBA outside [0, 1]: [{rgba.min()}, {rgba.max()}]")
        out[mode] = (rgba_u8, rgba)
    sfactor = engine.uvs_mapper.sfactors[7]
    print(f"[main] render_stroke clear+full ok, sfactor {sfactor:.6f}, "
          f"alpha mean {out['clear'][1][..., 3].mean():.4f}", flush=True)

    engine.set_render_mode("clear")
    bopts = _batch_opts(engine, BATCH)
    rb = engine.render_batch(geoms, bopts)["rgba"].float()
    passes += 1
    check(tuple(rb.shape) == (BATCH, RES, RES, 4), f"batch {tuple(rb.shape)}")
    check(bool(torch.isfinite(rb).all()), "render_batch: non-finite RGBA")
    check(rb.min().item() >= -1e-6 and rb.max().item() <= 1 + 1e-6,
          "render_batch: RGBA outside [0, 1]")

    # Timing: render_stroke on the host clock (the uint8 copy-out syncs),
    # 3 warm-up calls then 60 timed; the spread shows how far the shared host
    # cores move one call.
    opts = _stroke_opts(engine)
    times = []
    for _ in range(63):
        t0 = time.perf_counter()
        engine.render_stroke(patch, None, opts)
        times.append((time.perf_counter() - t0) * 1e3)
        passes += 1
    times = times[3:]
    deciles = statistics.quantiles(times, n=10)
    stroke = {"p10": deciles[0], "p50": statistics.median(times),
              "p90": deciles[-1], "min": min(times), "max": max(times)}

    def batch_rate(eng, iters=8):
        nonlocal passes
        ts = []
        for i in range(iters + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.render_batch(geoms, _batch_opts(eng, BATCH))
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
            passes += 1
        return BATCH / statistics.median(ts[2:])

    f32_rate = batch_rate(engine)
    # bf16 blocks at every res >= 8 (num_bf16_res=6) in 'fast' mode.
    set_precision_mode("fast")
    try:
        engine16 = _engine(6, "cuda", trees)
        rb16 = engine16.render_batch(geoms, _batch_opts(engine16, BATCH))
        rb16 = rb16["rgba"].float()
        passes += 1
        check(bool(torch.isfinite(rb16).all()), "bf16 render_batch non-finite")
        check(rb16.min().item() >= -1e-3 and rb16.max().item() <= 1 + 1e-3,
              "bf16 render_batch: RGBA outside [0, 1]")
        bf16_rate = batch_rate(engine16)
        bf16_vs_f32 = (rb16 - rb).abs().max().item()
    finally:
        set_precision_mode("strict")
    launches = fir4_epilogue.launches     # main path ends here
    check(launches == n_up * passes,
          f"{launches} kernel launches for {passes} generator passes, want "
          f"{n_up * passes}")
    print(f"[main] {passes} generator passes, {launches} fir4_epilogue "
          f"launches ({n_up} per pass)", flush=True)
    print(f"[main] render_stroke ms (f32, clear, UVS, 60 calls): p10 "
          f"{stroke['p10']:.3f} p50 {stroke['p50']:.3f} p90 "
          f"{stroke['p90']:.3f} min {stroke['min']:.3f} max "
          f"{stroke['max']:.3f}; "
          f"render_batch B={BATCH}: f32 {f32_rate:.1f} patches/s, bf16 "
          f"{bf16_rate:.1f} patches/s (max |bf16 - f32| RGBA "
          f"{bf16_vs_f32:.4f})", flush=True)

    # The same requests on the CPU (plain FIR version, strict f32).
    t0 = time.time()
    cpu_engine = _engine(0, "cpu", trees)
    for mode in ("clear", "full"):
        cpu_engine.set_render_mode(mode)
        opts = _stroke_opts(cpu_engine)
        u8, _ = cpu_engine.render_stroke(patch, None, opts)
        rgba = cpu_engine._run_core(cpu_engine.prepare_geom_input(patch),
                                    opts)["rgba"][0].numpy()
        err = float(np.abs(rgba - out[mode][1]).max())
        u8_err = int(np.abs(u8.astype(int) - out[mode][0].astype(int)).max())
        print(f"[main] {mode}: CUDA vs CPU max |RGBA| err {err:.3e}, uint8 "
              f"{u8_err} LSB", flush=True)
        check(err <= RENDER_ATOL, f"{mode}: CUDA vs CPU RGBA err {err}")
        check(u8_err <= 1, f"{mode}: CUDA vs CPU uint8 err {u8_err}")
    cpu_sf = cpu_engine.uvs_mapper.sfactors[7]
    check(abs(cpu_sf - sfactor) <= 1e-3 * abs(cpu_sf),
          f"sfactor CUDA {sfactor} vs CPU {cpu_sf}")
    print(f"[main] CPU reference renders in {time.time() - t0:.1f} s, "
          f"sfactor CPU {cpu_sf:.6f}", flush=True)
    return {"launches": launches, "passes": passes,
            "render_stroke_ms": stroke,
            "render_batch_f32_patches_per_s": f32_rate,
            "render_batch_bf16_patches_per_s": bf16_rate}


def main():
    t_start = time.time()
    phase_card()
    import torch
    sys.path.insert(0, REPO)
    phase_build()
    rows, max_err = phase_kernel_vs_plain()
    main_stats = phase_main_path()

    top = next(r for r in rows if r["res"] == RES and r["dtype"] == "float32")
    kernels = [{
        "name": "fir4_epilogue",
        "route": "cuda",
        "source": "brushstroke_engine_torch/csrc/fir4_epilogue.cu",
        "replaces": "brushstroke_engine_tpu/ops/pallas_fir.py:85",
        "launches": main_stats["launches"],
        "max_abs_err": max_err[torch.float32],
        "max_abs_err_bf16": max_err[torch.bfloat16],
        "ms": top["kernel_ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "shape": f"B={BATCH} res={RES} C={top['channels']} float32, "
                 f"noise+clamp",
    }]
    print(json.dumps({"main_path": main_stats,
                      "seconds": time.time() - t_start}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
