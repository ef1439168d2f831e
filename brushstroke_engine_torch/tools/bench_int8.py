"""Time the int8 serving path on the card: the int8 conv kernel at the
flagship's site geometries and, end to end, the flagship engine in int8
beside float.

    python3 -m brushstroke_engine_torch.tools.bench_int8 --out_dir out
    python3 brushstroke_engine_torch/tools/bench_int8.py --root OTHER_CHECKOUT

``--root`` times another checkout's package (run the file by its path, so
that the package is imported from there): two trees compared in one process
each, on one card, in turns.  Only the API the checkouts share is used:
``ops.int8_conv.int8_conv`` and, where the checkout has it,
``int8_conv_quantizing``; ``ops.quant``; ``flagship``; the engine's
``enable_int8_serving``.

Kernel part, per site geometry ``(Hp, Wp, I, O, kh, kw)`` at B = 16: ms per
call (CUDA events, mean of 20 back to back after 3) and device µs
per launch (profiler) of the int8 entry (f32 output, per-sample scales) and
of the quantizing entry on f32 and bf16 activations (static scale, the
output in x's dtype), each beside
its bound (the larger of bytes over 3.35 TB/s and int8 operations over 1979
TOP/s, the H100 SXM's data-sheet rates); the library route (the int8
window copy, ``torch._int_mm``, the scale product); cuDNN's conv of the
same shape in f32 with TF32 off and on and in bf16; one static site's whole
``quant.quantized_conv`` call (host and device, all its launches) and the
device kernels it launches (profiler).  Engine part (256-px flagship, seeded
random weights): ``render_stroke`` p50 (30 after 3) and ``render_batch``
B = 16 patches/s (8 after 2) in float and in static int8, strict and fast,
and the device kernels one ``render_stroke`` launches.  Each line is
printed as ``[bench_int8] {json}`` with the card's name and power limit;
``--out_dir`` also keeps them as JSON.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

# The flagship's stride-1 dense conv sites (Hp, Wp, I, O, kh, kw): conv1 of
# its 7 blocks and toRGB (what chip_smoke.py phase 17 launches).
SITE_GEOMETRIES = ((6, 6, 128, 128, 3, 3), (10, 10, 128, 128, 3, 3),
                   (18, 18, 128, 128, 3, 3), (34, 34, 128, 128, 3, 3),
                   (66, 66, 128, 128, 3, 3), (130, 130, 128, 128, 3, 3),
                   (258, 258, 64, 64, 3, 3), (256, 256, 64, 3, 1, 1))
BATCH = 16
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
RES, SEED, NOISE_STRENGTH = 256, 0, 0.1
STROKES, BATCHES = 30, 8
ITERS = 20                          # calls timed per kernel figure


def card():
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


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


def device_kernels(fn):
    """How many device kernels one call of ``fn`` launches (profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from brushstroke_engine_torch.utils.util import device_activity
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in device_activity(prof.events())
               if "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower())


def kernel_us(fn, name="int8_conv_kernel", calls=10):
    """Mean device µs per launch of the kernels whose name holds ``name``
    over ``calls`` calls of ``fn`` (profiler), host time left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ks = [e.device_time_total for e in prof.events() if name in e.name]
    return sum(ks) / len(ks) if ks else None


def _bound(nbytes, ops):
    b = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
         "operations": ops / INT8_OPS_PER_S * 1e3}
    by = max(b, key=b.get)
    return b[by], by


def kernel_rows(iters, geometries=SITE_GEOMETRIES, batch=BATCH):
    import torch
    import torch.nn.functional as F
    from brushstroke_engine_torch.ops import int8_conv as ic
    from brushstroke_engine_torch.ops import quant
    fused = hasattr(ic, "int8_conv_quantizing")
    takes_source = "source" in inspect.signature(
        quant.quantized_conv).parameters
    gen = torch.Generator(device="cuda").manual_seed(170)
    rows = []
    for hp, wp, i, o, kh, kw in geometries:
        b = batch
        ho, wo = hp - kh + 1, wp - kw + 1
        pad = ((kh // 2,) * 2, (kw // 2,) * 2)
        h, w = hp - 2 * (kh // 2), wp - 2 * (kw // 2)
        xq = torch.randint(-127, 128, (b, hp, wp, i), device="cuda",
                           generator=gen, dtype=torch.int8)
        wq = torch.randint(-127, 128, (o, i, kh, kw), device="cuda",
                           generator=gen, dtype=torch.int8)
        s_x = torch.rand(b, device="cuda", generator=gen) * 1e-2 + 1e-5
        s_w = torch.rand(o, device="cuda", generator=gen) * 1e-2 + 1e-5
        ops = 2 * b * ho * wo * o * kh * kw * i
        out_elems = b * ho * wo * o
        row = {"shape": [b, hp, wp, i, o, kh, kw], "ops": ops}
        row["int8_ms"] = cuda_ms(
            lambda: ic.int8_conv(xq, wq, s_x, s_w, torch.float32), iters)
        row["int8_us"] = kernel_us(
            lambda: ic.int8_conv(xq, wq, s_x, s_w, torch.float32))
        row["int8_bound_ms"], row["int8_bound_by"] = _bound(
            xq.numel() + wq.numel() + 4 * (b + o) + 4 * out_elems, ops)
        k = kh * kw * i
        wm = wq.permute(0, 2, 3, 1).reshape(o, k).t().contiguous()

        def library():
            a = xq.unfold(1, kh, 1).unfold(2, kw, 1).permute(
                0, 1, 2, 4, 5, 3).reshape(b * ho * wo, k)
            acc = torch._int_mm(a, wm).reshape(b, ho, wo, o)
            return acc.float() * (s_x[:, None, None, None] * s_w)
        # torch._int_mm takes K and N multiples of 8, M above 16.
        row["library_ms"] = cuda_ms(library, iters) \
            if k % 8 == 0 and o % 8 == 0 else None
        xf = torch.randn(b, h, w, i, device="cuda", generator=gen)
        wf = torch.randn(o, i, kh, kw, device="cuda", generator=gen) * 0.1
        xc = xf.permute(0, 3, 1, 2)          # NCHW view, channels-last
        old = torch.backends.cudnn.allow_tf32
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            row[f"cudnn_f32_tf32_{'on' if tf32 else 'off'}_ms"] = cuda_ms(
                lambda: F.conv2d(xc, wf, padding=(kh // 2, kw // 2)), iters)
        torch.backends.cudnn.allow_tf32 = old
        xcb, wfb = xc.bfloat16(), wf.bfloat16()
        row["cudnn_bf16_ms"] = cuda_ms(
            lambda: F.conv2d(xcb, wfb, padding=(kh // 2, kw // 2)), iters)
        s1 = s_x[:1].contiguous()
        if fused:
            wpk = ic.quantize_weight(wf)
            for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                x = xf.to(dt)
                row[f"fused_{name}_ms"] = cuda_ms(
                    lambda: ic.int8_conv_quantizing(x, s1, wpk, pad), iters)
                row[f"fused_{name}_us"] = kernel_us(
                    lambda: ic.int8_conv_quantizing(x, s1, wpk, pad))
                size = x.element_size()
                row[f"fused_{name}_bound_ms"], row[f"fused_{name}_bound_by"] \
                    = _bound(size * x.numel() + wpk.data.numel() + 4 * (1 + o)
                             + size * out_elems, ops)
        source = (wf, "bench") if takes_source else None

        def site():
            with quant.static_scales([float(s1)]):
                if source is None:
                    return quant.quantized_conv(xf, wf, pad)
                return quant.quantized_conv(xf, wf, pad, source=source)
        row["site_ms"] = cuda_ms(site, iters)
        row["site_kernels"] = device_kernels(site)
        rows.append(row)
        print("[bench_int8] kernel " + json.dumps(row), flush=True)
        del xq, xf, xc, xcb
        torch.cuda.empty_cache()
    return rows


def engine_rows():
    import numpy as np
    import torch
    from brushstroke_engine_torch.data.curated_geometry import \
        curated_geometry_patch
    from brushstroke_engine_torch.engine.brush import GanBrushOptions
    from brushstroke_engine_torch.flagship import (
        flagship_engine, flagship_trees,
    )
    from brushstroke_engine_torch.ops.precision import (
        precision_mode, set_precision_mode,
    )
    set_precision_mode("strict")
    engine = flagship_engine(flagship_trees(RES, SEED, NOISE_STRENGTH), RES,
                             0, "cuda")
    t0 = time.perf_counter()
    scales = engine.enable_int8_serving()
    calib_s = time.perf_counter() - t0
    geom = curated_geometry_patch("curve", 9, RES)
    patch = np.zeros((RES, RES, 4), np.uint8)
    patch[..., 3] = np.round((1.0 - geom) * 255).astype(np.uint8)
    geoms = np.stack([engine.prepare_geom_input(np.roll(patch, 8 * i, 1))[0]
                      for i in range(BATCH)])

    def stroke():
        opts = GanBrushOptions(primary_color=np.array([220, 40, 60],
                                                      np.uint8))
        opts.set_style(engine.random_style(7), style_id=7)
        opts.set_position(x=1000, y=333)
        opts.enable_uvs_mapping = True
        return engine.render_stroke(patch, None, opts)[0]

    def batch():
        opts = []
        for i in range(BATCH):
            o = GanBrushOptions(secondary_color=np.array(
                [0, 90, 200], np.uint8) if i % 2 else None)
            o.set_style(engine.random_style(100 + i))
            o.set_position(x=37 * i, y=1000 - 11 * i)
            opts.append(o)
        return engine.render_batch(geoms, opts)["rgba"]

    out = {"sites": len(scales), "calibration_s": calib_s}
    for mode in ("strict", "fast"):
        with precision_mode(mode):
            for name in ("float", "int8"):
                engine._int8_scales = scales if name == "int8" else None
                ts = []
                for _ in range(3 + STROKES):
                    t0 = time.perf_counter()
                    stroke()
                    ts.append((time.perf_counter() - t0) * 1e3)
                bt = []
                for _ in range(2 + BATCHES):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    batch()
                    torch.cuda.synchronize()
                    bt.append(time.perf_counter() - t0)
                out[f"{mode}_{name}"] = {
                    "render_stroke_p50_ms": statistics.median(ts[3:]),
                    "render_batch_patches_per_s":
                    BATCH / statistics.median(bt[2:]),
                    "stroke_kernels": device_kernels(stroke)}
    engine._int8_scales = scales
    print("[bench_int8] engine " + json.dumps(out), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="checkout whose package is timed")
    p.add_argument("--tag", default="", help="suffix of the JSON's name")
    p.add_argument("--out_dir", default=None)
    a = p.parse_args(argv)
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_int8: needs a CUDA device")
    import brushstroke_engine_torch
    pkg = os.path.dirname(os.path.abspath(brushstroke_engine_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"bench_int8: imported {pkg}, not {root}'s package "
                         "(run this file by its path)")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"root": root, "tag": a.tag, "card": card(),
           "device": torch.cuda.get_device_name(0)}
    res["kernel"] = kernel_rows(ITERS)
    res["engine"] = engine_rows()
    print("[bench_int8] " + json.dumps({"root": root, "tag": a.tag,
                                        "card": res["card"]}), flush=True)
    if a.out_dir:
        os.makedirs(a.out_dir, exist_ok=True)
        with open(os.path.join(a.out_dir, f"bench_int8{a.tag}.json"),
                  "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
