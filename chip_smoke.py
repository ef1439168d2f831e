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
   memory bound.  Then shapes off the kernel's vector path (a channel count
   that is no multiple of the 16-byte vector, H != W, ragged strips, W
   narrower than a thread's column walk), every tile forced as well as the
   kernel's own choice; then the paint and serving paths' batches (B = 1
   to 8 and 32 at the same six shapes, f32); then the trainer's shapes
   (B = 64, f32), checked and timed.
4. The FIR-epilogue kernel's backward: gradients of x, dcoefs, noise and
   bias through the kernel path against autograd through the plain version
   at the 64-px and 128-px training shapes, and one double backward.
5. The ADA two-pass warp kernels W and W^T against their plain versions:
   the five transform classes and 64 matrices of the ADA pipe at p = 1, at
   [64,128,128,3] and [8,64,64,3], antialias on and off, values, two calls
   bit-equal, the second-order (R1) pattern and the adjoint identity, with
   times.  Then both under stress: pass slopes of 0 and near 0, a quarter
   turn, a translation, flips, a strong zoom-out and zoom-in, a
   near-singular shear, at N = 67 (C = 5; no multiple of W's column band),
   N = 128 and N = 33 (C = 11: two channel chunks).  Prints the column band
   W picks at each shape.
6. The render path: the 256-px flagship (random weights from a seed, through
   ``init_native_params`` -> ``params_from_jax``) renders through
   ``TriadGanPaintEngine.render_stroke`` (z style, canvas position, UVS
   mapping, clear and full modes, color override) and ``render_batch``
   (B=16, strict f32 and bf16 blocks); checks shapes, finiteness, range and
   the kernel's launch count, and the f32 render against the same request
   rendered on the CPU.
7. The training path: the canonical 128-px / batch-64 configuration
   (``flagship_train_config``) takes 33 batches through ``TrainingLoop``
   with every phase (Dmain, Dr1, Gmain, Gpl, Ggeom, the ADA p update), then
   2 warm-start batches of a second loop; checks finite stats, moved
   parameters, the three kernels' launch counts against the schedule, and a
   non-zero gradient at every ``conv0``; then the first Dmain, Dr1, Gmain
   and Gpl batch at B = 8 with identical draws on the card and on the CPU.
8. The paint path: the same flagship (strict f32) paints a 1024 x 1024 canvas
   through ``PaintingHelper`` with feature blending at level 2 (12
   overlapping full strokes and 4 partial patches, crop margin 10, then 30
   timed strokes), through ``DevicePaintSession`` (30 timed strokes after
   warm-up, the canvas on the card throughout), stylizes a 2048 x 2048
   synthetic line drawing (81 tiles) with each of the three stylizers, and
   renders ``CanvasPaintEngine`` (the flagship with the canvas head) in its
   four modes and one blended stroke; checks shapes, metadata, the mask's
   growth, finiteness and K1's launches (6 per generator pass); then the
   same requests at a smaller size on the card and on the CPU: strokes on a
   512 x 512 canvas, each stylizer on a 472 x 472 drawing (4 tiles; the
   card at the default batches of 16 and 32, the CPU at 2), the canvas
   engine's modes.
9. The serve path: the flagship (strict f32) is written with the port's
   ``save_native`` and served by ``ui.core.create_core(gan_checkpoint=...)``
   (no transport: ``tools/bench_serve.py`` drives closed-loop painter
   sessions on the core) through each image path -- helper, device canvas,
   ``RenderBatcher`` (4 ms window), the pool (both) -- with 1 session and
   with 8, whole 256-px patches at seeded positions on 1024 x 1024 canvases
   at level 2, crop margin 10; every reply arrives, no fallback and no error
   is counted, K1 launches 6 times per generator pass, the batched paths
   render more than one row per pass at 8 sessions, every flush's batch
   is one that phase 3 held K1 at, each served image
   equals the same strokes replayed one by one on the card (every session
   of the batched paths, session 0 of the others) within 1 LSB, and a
   4-stroke session on a 512 x 512 canvas through each serial path equals
   the same core on the CPU within 1 LSB.
10. Prints the kernel table as JSON, then the final JSON line.

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
# FIR-epilogue gradients, kernel path vs plain: 1e-4 of the largest entry of
# each gradient (the backward re-runs the plain chain on the saved inputs;
# only rounding of the f32 sums differs).
FIR_GRAD_RTOL = 1e-4
# Two-pass warp, kernel vs plain: 2e-5 forward (the same f32 weights, taps
# summed in another order), 2e-4 for W^T and the second-order gradient
# (relative to the largest entry), 1e-4 relative for <Wx, g> = <x, W^T g>.
WARP_FWD_TOL, WARP_GRAD_TOL, WARP_ADJ_RTOL = 2e-5, 2e-4, 1e-4
# The same training phases on the card and on the CPU, identical draws:
# losses within 1e-4 relative (f32 sums in another order through G and D).
TRAIN_RTOL = 1e-4
TRAIN_RES, TRAIN_BATCH, TRAIN_BATCHES, WARM_BATCHES = 128, 64, 33, 2
# The paint path: a 1024-px canvas blended at level 2 (res/2 = 128 px,
# 128 channels: a 128 MiB feature canvas), crop margin 10, a 2048-px drawing
# (padded to 2144 px: 9 x 9 tiles at stride 236); the CPU comparison at 512 px
# and on a 472-px drawing (2 x 2 tiles), where the card runs the wave
# stylizers at their default batches (16 and 32) and the CPU at CMP_BATCH
# (a chunk's padding repeats its last tile, so the batch does not change the
# image).
PAINT_CANVAS, PAINT_LEVEL, PAINT_CROP, PAINT_TIMED = 1024, 2, 10, 30
STYLIZE_SIZE, STYLIZE_STROKES, STYLIZE_OVERLAP = 2048, 64, 10
CMP_CANVAS, CMP_DRAWING, CMP_BATCH = 512, 472, 2
# The serve path: the client's defaults (positions on, render mode 'clear',
# level 2, crop margin 10) on 1024-px canvases (512^2 x 128 f32 features,
# 128 MiB per session), a 4 ms flush window; per path (sessions, timed
# strokes, warm-up strokes) per session, then SERVE_TRACE strokes under the
# profiler for the idle share.  The CPU comparison: 4 strokes at 512 px.
SERVE_CANVAS, SERVE_WINDOW_MS = 1024, 4.0
SERVE_RUNS = ((1, 24, 4), (8, 8, 2))
SERVE_TRACE, SERVE_CMP_STROKES = 2, 4
# K1 against its plain version at the 256-px shapes for every batch these
# paths launch: B = 1 (a helper or session stroke), 2-8 (a cross-session
# flush of that many of the at most 8 painters; the port pads no flush to a
# bucket) and 32 (an on-device stylize chunk; the batched stylizer's B = 16
# is the timing table).  The serve phase checks that no flush left this set.
K1_PATH_BATCHES = (*range(1, 9), 32)


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

    # Off the vector path: C = 20 (a multiple of 4, not of 8), C = 5
    # (neither), H != W with H no multiple of any strip, W narrower than a
    # thread's walk of 2 columns; the kernel's own tile and every forced
    # (columns, rows) tile.  Same tolerances.
    n_off = 0
    for b, h, w, c in ((2, 13, 9, 20), (3, 5, 7, 5), (2, 6, 3, 24),
                       (1, 1, 1, 8), (2, 37, 66, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
            x = (torch.randn((b, h + 3, w + 3, c), generator=gen,
                             device="cuda") * 2).to(dtype)
            d = torch.rand((b, c), generator=gen, device="cuda") * 0.5 + 0.7
            noise = torch.randn((b, h, w, 1), generator=gen, device="cuda")
            bias = torch.randn((c,), generator=gen, device="cuda")
            want = fe.fir4_epilogue_plain(x, taps, d, noise, bias, act_gain,
                                          256.0, out_dtype=dtype).float()
            tiles = [(xw, strip) for xw in (1, 2) for strip in (1, 3, 8)]
            for tile in [None] + tiles:
                if tile is None:
                    got = fe.fir4_epilogue(x, f, d, noise, bias, act_gain,
                                           256.0, out_dtype=dtype)
                else:
                    got = fe._launch_kernel(x, taps, d, noise, bias,
                                            act_gain, 256.0, 0.2, dtype,
                                            tile=tile)
                torch.cuda.synchronize()
                err = (got.float() - want).abs()
                check(got.shape == (b, h, w, c) and not bool(
                    (err > rtol * want.abs() + ATOL).any()),
                    f"kernel != plain at [{b},{h},{w},{c}] {dtype} tile "
                    f"{tile}: max err {err.max().item():.3e}")
                max_err[dtype] = max(max_err[dtype], err.max().item())
                n_off += 1
    print(f"[fir4] {n_off} off-vector-path cases within tolerance",
          flush=True)

    # The paint and serve paths' batches (K1_PATH_BATCHES) at the 256-px
    # shapes, f32 with one noise plane per sample and the clamp, as the
    # render sends them.  ``dispatch`` picks the strip and block per shape,
    # so each batch is checked on its own.
    n_paint = 0
    for b in K1_PATH_BATCHES:
        for res in syn.block_resolutions[1:]:
            c = syn.channels(res)
            x = torch.randn((b, res + 3, res + 3, c), generator=gen,
                            device="cuda") * 2
            d = torch.rand((b, c), generator=gen, device="cuda") * 0.5 + 0.7
            noise = torch.randn((b, res, res, 1), generator=gen,
                                device="cuda")
            bias = torch.randn((c,), generator=gen, device="cuda")
            got = fe.fir4_epilogue(x, f, d, noise, bias, act_gain, 256.0)
            want = fe.fir4_epilogue_plain(x, taps, d, noise, bias, act_gain,
                                          256.0)
            torch.cuda.synchronize()
            err = (got - want).abs()
            check(got.shape == (b, res, res, c) and not bool(
                (err > F32_RTOL * want.abs() + ATOL).any()),
                f"kernel != plain at [{b},{res},{res},{c}] f32: max err "
                f"{err.max().item():.3e}")
            max_err[torch.float32] = max(max_err[torch.float32],
                                         err.max().item())
            n_paint += 1
    print(f"[fir4] {n_paint} paint- and serve-path cases (B = "
          f"{', '.join(map(str, K1_PATH_BATCHES))}) within tolerance",
          flush=True)

    # The trainer's shapes (B = 64, C = 128, f32, noise and clamp): checked
    # against the plain version, then timed.
    train_rows = []
    for res in flagship_generator_config(TRAIN_RES).synthesis \
            .block_resolutions[1:]:
        c = flagship_generator_config(TRAIN_RES).synthesis.channels(res)
        x = torch.randn((TRAIN_BATCH, res + 3, res + 3, c), generator=gen,
                        device="cuda") * 2
        d = torch.rand((TRAIN_BATCH, c), generator=gen, device="cuda") + 0.5
        noise = torch.randn((TRAIN_BATCH, res, res, 1), generator=gen,
                            device="cuda")
        bias = torch.randn((c,), generator=gen, device="cuda")
        got = fe.fir4_epilogue(x, f, d, noise, bias, act_gain, 256.0)
        want = fe.fir4_epilogue_plain(x, taps, d, noise, bias, act_gain,
                                      256.0)
        torch.cuda.synchronize()
        err = (got - want).abs()
        check(not bool((err > F32_RTOL * want.abs() + ATOL).any()),
              f"kernel != plain at [{TRAIN_BATCH},{res},{res},{c}] f32: max "
              f"err {err.max().item():.3e}")
        max_err[torch.float32] = max(max_err[torch.float32], err.max().item())
        del got, want, err
        iters = 200 if res <= 32 else 30
        k_ms = cuda_ms(lambda: fe.fir4_epilogue(
            x, f, d, noise, bias, act_gain, 256.0), iters)
        p_ms = cuda_ms(lambda: fe.fir4_epilogue_plain(
            x, taps, d, noise, bias, act_gain, 256.0), iters)
        nbytes = 4 * (x.numel() + TRAIN_BATCH * res * res * c
                      + noise.numel() + d.numel() + bias.numel())
        row = {"shape": [TRAIN_BATCH, res, res, c], "dtype": "float32",
               "kernel_ms": k_ms, "plain_ms": p_ms,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
        train_rows.append(row)
        print("[fir4-train] " + json.dumps(row), flush=True)
    return rows, max_err


def _rel_err(got, want):
    """max |got - want| relative to max(|want|, 1)."""
    return ((got - want).abs().max() /
            want.abs().max().clamp_min(1.0)).item()


def phase_fir_backward():
    import torch
    from brushstroke_engine_torch.ops import fir_epilogue as fe
    from brushstroke_engine_torch.ops.filters import setup_filter

    f = setup_filter([1, 3, 3, 1])
    taps = fe.correlation_taps(f)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    b, c, gain, clamp = 4, 128, 2 ** 0.5, 256.0
    worst = 0.0

    def grads(use_kernel, leaves, cot, second):
        x, d, noise, bias = [t.detach().clone().requires_grad_(True)
                             for t in leaves]
        xin = torch.tanh(x) * 3      # so that d2/dx2 is not identically 0
        if use_kernel:
            y = fe.fir4_epilogue(xin, f, d, noise, bias, gain, clamp)
            check(y.grad_fn is not None, "kernel output has no grad_fn")
        else:
            y = fe.fir4_epilogue_plain(xin, taps, d, noise, bias, gain, clamp)
        g1 = torch.autograd.grad((y * cot).sum(), [x, d, noise, bias],
                                 create_graph=second)
        if not second:
            return g1
        return torch.autograd.grad(sum(g.square().sum() for g in g1),
                                   [x, d, noise, bias], allow_unused=True)

    for res, second in ((64, False), (128, False), (64, True)):
        x = torch.randn((b, res + 3, res + 3, c), generator=gen,
                        device="cuda")
        d = torch.rand((b, c), generator=gen, device="cuda") * 0.5 + 0.7
        noise = torch.randn((b, res, res, 1), generator=gen, device="cuda")
        bias = torch.randn((c,), generator=gen, device="cuda")
        cot = torch.randn((b, res, res, c), generator=gen, device="cuda")
        before = fe.fir4_epilogue.launches
        got = grads(True, (x, d, noise, bias), cot, second)
        check(fe.fir4_epilogue.launches == before + 1,
              "the gradient case did not launch the kernel once")
        want = grads(False, (x, d, noise, bias), cot, second)
        torch.cuda.synchronize()
        for name, a, w in zip(("x", "dcoefs", "noise", "bias"), got, want):
            check((a is None) == (w is None), f"{name}: gradient missing")
            if a is None:
                continue
            check(w.abs().max().item() > 0, f"{name}: plain gradient is 0")
            err = ((a - w).abs().max() / w.abs().max()).item()
            worst = max(worst, err)
            check(err <= FIR_GRAD_RTOL,
                  f"fir4_epilogue d/d{name} res {res} "
                  f"{'second' if second else 'first'} order: rel err {err:.3e}")
    print(f"[fir4-bwd] first-order at 64 and 128 px and one double backward "
          f"(B={b}, C={c}, f32) within {FIR_GRAD_RTOL:g} of the largest "
          f"gradient; worst {worst:.3e}", flush=True)

    # The kernel's time at the training shape (B=64, 128 px, C=128, f32).
    x = torch.randn((TRAIN_BATCH, 131, 131, c), generator=gen, device="cuda")
    d = torch.rand((TRAIN_BATCH, c), generator=gen, device="cuda") + 0.5
    noise = torch.randn((TRAIN_BATCH, 128, 128, 1), generator=gen,
                        device="cuda")
    bias = torch.randn((c,), generator=gen, device="cuda")
    k_ms = cuda_ms(lambda: fe.fir4_epilogue(x, f, d, noise, bias, gain,
                                            clamp), 20)
    p_ms = cuda_ms(lambda: fe.fir4_epilogue_plain(x, taps, d, noise, bias,
                                                  gain, clamp), 20)
    nbytes = 4 * (x.numel() + TRAIN_BATCH * 128 * 128 * c + noise.numel()
                  + d.numel() + bias.numel())
    row = {"shape": [TRAIN_BATCH, 128, 128, c], "dtype": "float32",
           "kernel_ms": k_ms, "plain_ms": p_ms,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
    print("[fir4-train] " + json.dumps(row), flush=True)
    return {"worst_rel_err": worst, "train_shape": row}


def _class_mats(batch):
    """The five transform classes (identity, translate, scale, rotate,
    near-90 rotation) cycled over the batch, each sample with a translation
    jitter of its own."""
    import numpy as np
    ms = []
    for i in range(batch):
        kind = i % 5
        m = np.eye(3)
        if kind == 1:
            m[0, 2], m[1, 2] = 7.35, -3.6
        elif kind == 2:
            m = np.diag([1.7, 0.55, 1.0])
        elif kind in (3, 4):
            t, tx, ty = (0.5, 2.0, -1.0) if kind == 3 else \
                (np.pi / 2 - 0.07, 0.5, 0.0)
            m = np.array([[np.cos(t), -np.sin(t), tx],
                          [np.sin(t), np.cos(t), ty], [0, 0, 1.0]])
        m[0, 2] += 0.37 * (i // 5)
        m[1, 2] -= 0.21 * (i // 5)
        ms.append(m)
    return np.stack(ms).astype(np.float32)


def _stress_mats():
    """Inverse affines that stress W^T's source walk: a pure quarter turn
    (factored out by the prep), a pure translation, flips, a strong zoom-out
    (wide triangles, many sources per tap), a zoom-in (no source for many
    taps), a near-singular shear (pass-1 slope near 0)."""
    import numpy as np
    ms = {
        "quarter": [[0, -1, 0.0], [1, 0, 0.0]],
        "translate": [[1, 0, 13.25], [0, 1, -40.5]],
        "flip_x": [[-1, 0, 0.5], [0, 1, 0.0]],
        "flip_y": [[1, 0, 0.0], [0, -1, -0.25]],
        "zoom_out": [[4.3, 0.2, 1.0], [-0.3, 3.1, 2.0]],
        "zoom_in": [[0.3, 0.05, -2.0], [0.02, 0.22, 3.0]],
        "shear_flat": [[0.81 + 1e-5, 0.9, 0.0], [0.9, 1.0, 0.0]],
        "rotate_far": [[0.8, -0.6, 300.0], [0.6, 0.8, -500.0]],
    }
    return list(ms), np.stack([np.array(m + [[0, 0, 1.0]], np.float32)
                               for m in ms.values()])


# Stress shapes (N, C) of the warp kernels at B = 8: N = 67 is no multiple
# of the column band W picks there, C = 11 takes two channel chunks.
WARP_STRESS_SHAPES = ((67, 5), (128, 3), (33, 11))


def _warp_stress(tw, taug, gen, worst):
    """W and W^T against their plain versions, each twice for equal bits,
    and against each other by the adjoint identity, on the stress matrices
    and on scalar packs whose pass slopes are exactly 0 and next to 0 (which
    no matrix reaches through the prep).  Returns the number of cases."""
    import torch
    names, mats = _stress_mats()
    mats = torch.from_numpy(mats).to("cuda")
    n_cases = 0
    b = len(names)
    check(any(n % tw.warp_band(b, n, c) for n, c in WARP_STRESS_SHAPES),
          "no stress shape leaves W a ragged last column band")
    for n, c in WARP_STRESS_SHAPES:
        for antialias in (True, False):
            x = torch.randn((b, n, n, c), generator=gen, device="cuda")
            g = torch.randn((b, n, n, c), generator=gen, device="cuda")
            imgs, sc = taug._twopass_prep(x, mats, antialias)
            packs = [("matrices", imgs.contiguous(), sc.contiguous())]
            flat = sc.clone()
            flat[:, 0] = torch.tensor([0.0, 1e-7, -1e-7, 3e-3, 0.0, 1e-7,
                                       -3e-3, 0.0], device="cuda")
            flat[:, 5] = torch.tensor([1e-6, -1e-6, 2e-3, 1e-6, -2e-3, 1.0,
                                       1e-6, -1.0], device="cuda")
            if antialias:
                flat[:, 3], flat[:, 7] = 1.0, 1.0
            packs.append(("flat slopes", imgs.contiguous(), flat))
            for what, im, scal in packs:
                wtg = tw.warp_twopass_t(g, scal)
                torch.cuda.synchronize()
                ptg = tw.warp_twopass_t_plain(g, scal)
                err = (wtg - ptg).abs()
                bad = err > WARP_GRAD_TOL * ptg.abs() + WARP_GRAD_TOL
                tag = f"{what} [{b},{n},{n},{c}] antialias={antialias}"
                check(not bool(bad.any()),
                      f"W^T != plain, {tag}: max err per sample "
                      f"{dict(zip(names, err.amax(dim=(1, 2, 3)).tolist()))}")
                check(torch.equal(wtg, tw.warp_twopass_t(g, scal)),
                      f"W^T is not deterministic, {tag}")
                wx = tw.warp_twopass(im, scal)
                torch.cuda.synchronize()
                px = tw.warp_twopass_plain(im, scal)
                err_w = (wx - px).abs()
                per_sample = err_w.amax(dim=(1, 2, 3)).tolist()
                check(not bool((err_w > WARP_FWD_TOL * px.abs()
                                + WARP_FWD_TOL).any()),
                      f"W != plain, {tag}: max err per sample "
                      f"{dict(zip(names, per_sample))}")
                check(torch.equal(wx, tw.warp_twopass(im, scal)),
                      f"W is not deterministic, {tag}")
                lhs, rhs = (wx * g).sum().item(), (im * wtg).sum().item()
                adj = abs(lhs - rhs) / max(abs(lhs), 1.0)
                check(adj <= WARP_ADJ_RTOL,
                      f"<Wx,g> {lhs} != <x,W^T g> {rhs}, {tag}")
                worst["w_stress"] = max(worst["w_stress"],
                                        err_w.max().item())
                worst["wt_stress"] = max(worst["wt_stress"], err.max().item())
                worst["adjoint"] = max(worst["adjoint"], adj)
                n_cases += b
    return n_cases


def phase_warp_vs_plain():
    import torch
    from brushstroke_engine_torch.ops import warp as tw
    from brushstroke_engine_torch.train import augment as taug

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cfg = taug.AugmentConfig.from_spec("bgc")
    one = torch.tensor(1.0, device="cuda")
    rows = []
    worst = {"w": 0.0, "wt": 0.0, "w_stress": 0.0, "wt_stress": 0.0,
             "second": 0.0, "adjoint": 0.0}

    def second_order(fn, x, g):
        xr = x.clone().requires_grad_(True)
        (g1,) = torch.autograd.grad((torch.sin(fn(xr)) * g).sum(), xr,
                                    create_graph=True)
        (g2,) = torch.autograd.grad(g1.square().sum(), xr)
        return g2

    for b, n in ((TRAIN_BATCH, TRAIN_RES), (8, 64)):
        c = 3
        ada_draws = taug.draw_augment(cfg, gen, b, (n, n, c), "cuda")
        ada = torch.linalg.inv_ex(taug.geometric_matrix(
            cfg, ada_draws, b, n, n, one)).inverse
        classes = torch.from_numpy(_class_mats(b)).to("cuda")
        for mats_name, mat in (("classes", classes), ("ada_p1", ada)):
            for antialias in (True, False):
                x = torch.randn((b, n, n, c), generator=gen, device="cuda")
                g = torch.randn((b, n, n, c), generator=gen, device="cuda")
                imgs, sc = taug._twopass_prep(x, mat, antialias)
                imgs, sc = imgs.contiguous(), sc.contiguous()
                n_w, n_t = tw.warp_twopass.launches, tw.warp_twopass_t.launches
                wx = tw.warp_twopass(imgs, sc)
                wtg = tw.warp_twopass_t(g, sc)
                torch.cuda.synchronize()
                check((tw.warp_twopass.launches, tw.warp_twopass_t.launches)
                      == (n_w + 1, n_t + 1), "warp launch counters")
                px = tw.warp_twopass_plain(imgs, sc)
                ptg = tw.warp_twopass_t_plain(g, sc)
                tag = f"{mats_name} [{b},{n},{n},{c}] antialias={antialias}"
                err_w = (wx - px).abs()
                check(not bool((err_w > WARP_FWD_TOL * px.abs()
                                + WARP_FWD_TOL).any()),
                      f"W != plain, {tag}: max err {err_w.max().item():.3e}")
                err_t = (wtg - ptg).abs()
                check(not bool((err_t > WARP_GRAD_TOL * ptg.abs()
                                + WARP_GRAD_TOL).any()),
                      f"W^T != plain, {tag}: max err "
                      f"{err_t.max().item():.3e}")
                check(torch.equal(wx, tw.warp_twopass(imgs, sc)),
                      f"W is not deterministic, {tag}")
                check(torch.equal(wtg, tw.warp_twopass_t(g, sc)),
                      f"W^T is not deterministic, {tag}")
                lhs, rhs = (wx * g).sum().item(), (imgs * wtg).sum().item()
                adj = abs(lhs - rhs) / max(abs(lhs), 1.0)
                check(adj <= WARP_ADJ_RTOL,
                      f"<Wx,g> {lhs} != <x,W^T g> {rhs}, {tag}")
                so = _rel_err(
                    second_order(lambda v: tw.warp_twopass(v, sc), imgs, g),
                    second_order(lambda v: tw.warp_twopass_plain(v, sc),
                                 imgs, g))
                check(so <= WARP_GRAD_TOL,
                      f"second-order gradient, {tag}: rel err {so:.3e}")
                # The whole entry (prep + kernel) against the plain entry.
                full = tw.affine_warp_twopass(x, mat, antialias)
                full_p = taug._affine_warp_twopass(x, mat, antialias)
                check(not bool(((full - full_p).abs() > WARP_FWD_TOL
                                * full_p.abs() + WARP_FWD_TOL).any()),
                      f"affine_warp_twopass != plain entry, {tag}")
                worst["w"] = max(worst["w"], err_w.max().item())
                worst["wt"] = max(worst["wt"], err_t.max().item())
                worst["second"] = max(worst["second"], so)
                worst["adjoint"] = max(worst["adjoint"], adj)

                # Times.  The library yardstick is the two einsums alone on
                # dense weights built beforehand (cuBLAS batched products).
                w1, w2 = tw.dense_weights(sc, n)
                iters = 20
                t = {
                    "w_ms": cuda_ms(lambda: tw.warp_twopass(imgs, sc), iters),
                    "wt_ms": cuda_ms(lambda: tw.warp_twopass_t(g, sc), iters),
                    "w_plain_ms": cuda_ms(
                        lambda: tw.warp_twopass_plain(imgs, sc), iters),
                    "wt_plain_ms": cuda_ms(
                        lambda: tw.warp_twopass_t_plain(g, sc), iters),
                    "w_library_ms": cuda_ms(lambda: torch.einsum(
                        "bijr,brjc->bijc", w2, torch.einsum(
                            "brjk,brkc->brjc", w1, imgs)), iters),
                    "wt_library_ms": cuda_ms(lambda: torch.einsum(
                        "brjk,brjc->brkc", w1, torch.einsum(
                            "bijr,bijc->brjc", w2, g)), iters),
                }
                del w1, w2
                # Bound: one image batch read, one written, the scalars; the
                # operations this data needs: per output pixel and pass the
                # taps under its triangle (2 s + 1), each a weight (4 ops)
                # and C multiply-adds.
                nbytes = 2 * imgs.numel() * 4 + sc.numel() * 4
                taps = (2 * sc[:, 3] + 1) + (2 * sc[:, 7] + 1)
                flops = float(taps.sum().item()) * n * n * (4 + 2 * c)
                by_bytes = nbytes / HBM_BYTES_PER_S
                by_ops = flops / F32_FLOPS_PER_S
                row = {"mats": mats_name, "shape": [b, n, n, c],
                       "antialias": antialias, **t,
                       "bound_ms": max(by_bytes, by_ops) * 1e3,
                       "bound_by": "bytes" if by_bytes >= by_ops
                       else "operations", "bytes": nbytes, "flops": flops,
                       "max_abs_err_w": err_w.max().item(),
                       "max_abs_err_wt": err_t.max().item()}
                rows.append(row)
                print("[warp] " + json.dumps(row), flush=True)
    n_stress = _warp_stress(tw, taug, gen, worst)
    print(f"[warp] {n_stress} W and W^T stress cases within tolerance and "
          f"bit-stable, max abs err W {worst['w_stress']:.3e}, W^T "
          f"{worst['wt_stress']:.3e}", flush=True)
    shapes = [(TRAIN_BATCH, TRAIN_RES, 3), (8, TRAIN_RES, 3), (8, 64, 3)] \
        + [(len(_stress_mats()[0]), n, c) for n, c in WARP_STRESS_SHAPES]
    print("[warp] W column band per shape: " + json.dumps(
        {f"[{b},{n},{n},{c}]": tw.warp_band(b, n, c) for b, n, c in shapes}),
        flush=True)
    print(f"[warp] all {len(rows)} cases within tolerance: W max abs err "
          f"{worst['w']:.3e}, W^T {worst['wt']:.3e}, second-order rel "
          f"{worst['second']:.3e}, adjoint rel {worst['adjoint']:.3e}",
          flush=True)
    return rows, worst


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


def _phase_draws(cfg, b, seed):
    """Explicit draws (CPU tensors) for one Dmain, Dr1, Gmain and Gpl batch
    of size ``b``: noise planes, style mixing, augment draws, PL noise."""
    import torch
    from brushstroke_engine_torch.models.generator import draw_style_mixing
    from brushstroke_engine_torch.train.augment import draw_augment
    gen = torch.Generator().manual_seed(seed)
    syn = cfg.gen_cfg.synthesis
    res = cfg.gen_cfg.img_resolution

    def g_draws(bb):
        noise = {}
        for r in syn.block_resolutions:
            for name in ("conv1",) if r == 4 else ("conv0", "conv1"):
                noise[f"b{r}.{name}"] = torch.randn((bb, r, r, 1),
                                                    generator=gen)
        return {"noise": noise, "mixing": draw_style_mixing(
            gen, (bb, cfg.gen_cfg.z_dim), "cpu")}

    def aug():
        return draw_augment(cfg.augment, gen, b, (res, res, 3), "cpu")

    return {"z": [torch.randn((b, cfg.gen_cfg.z_dim), generator=gen)
                  for _ in range(3)],
            "Dmain": {"g": g_draws(b), "aug_fake": aug(), "aug_real": aug()},
            "Dr1": {"aug": aug()},
            "Gmain": {"g": g_draws(b), "aug": aug()},
            "Gpl": {"g": g_draws(b // 2), "pl_noise": torch.randn(
                (b // 2, res, res, 3), generator=gen)}}


def _four_phases(cfg, device, draws, real_u8, tri_u8):
    """The first Dmain, Dr1, Gmain and Gpl batch from seed-0 weights on
    ``device`` with the given draws; returns ({stat: float}, conv0 weight
    gradient maxima of the Gmain loss)."""
    import torch
    import torch.nn.functional as F
    from brushstroke_engine_torch.flagship import flagship_train_setup
    from brushstroke_engine_torch.train import steps
    from brushstroke_engine_torch.train.dataset import (
        geom_batch_to_float, style_batch_to_float,
    )
    from brushstroke_engine_torch.utils.util import tree_to
    state, enc_p, enc_s = flagship_train_setup(cfg, SEED, NOISE_STRENGTH,
                                               device)
    dev = state["ada_p"].device
    state["ada_p"] = torch.full((), 0.5, device=dev)
    d = tree_to(draws, dev)
    res = cfg.gen_cfg.img_resolution
    real = torch.from_numpy(style_batch_to_float(real_u8)).to(dev)
    tri = torch.from_numpy(geom_batch_to_float(tri_u8)[:, :res, :res]).to(dev)
    enc_p, enc_s = tree_to(enc_p, dev), tree_to(enc_s, dev)
    feats = steps.encode_geometry(cfg, enc_p, enc_s, tri[..., 1:2])
    truth = tri[..., 2:3]
    stats = {}

    # Gradient of the Gmain GAN loss at every conv0 weight (the up-sampling
    # layers, whose epilogue is the FIR kernel on the card).
    gp = steps._trainable(state["g_params"])
    img, _ = steps._run_g(cfg, gp, state, d["z"][1], feats, None,
                          d["Gmain"]["g"])
    logits = steps._run_d(cfg, state["d_params"], img, None, state["ada_p"],
                          d["Gmain"]["aug"])
    grads = steps._grads(F.softplus(-logits).mean(), gp)
    conv0 = {k: float(v["conv0"]["weight"].abs().max())
             for k, v in grads["synthesis"].items() if "conv0" in v}
    del gp, img, logits, grads

    state, s = steps.d_main_step(cfg, state, real, feats, d["z"][0],
                                 draws=d["Dmain"])
    stats.update(s)
    state, s = steps.d_reg_step(cfg, state, real, draws=d["Dr1"])
    stats.update(s)
    state, s = steps.g_main_step(cfg, state, feats, truth, d["z"][1],
                                 ema_beta=0.5, draws=d["Gmain"])
    stats.update(s)
    state, s = steps.g_reg_step(cfg, state, feats, d["z"][2], ema_beta=0.5,
                                draws=d["Gpl"])
    stats.update(s)
    return {k: float(v) for k, v in stats.items()}, conv0


def phase_train(style_iter, geom_iter, card):
    import shutil
    import tempfile
    import numpy as np
    import torch
    from brushstroke_engine_torch.flagship import (
        flagship_train_config, flagship_train_setup,
    )
    from brushstroke_engine_torch.ops import warp as tw
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    from brushstroke_engine_torch.ops.precision import set_precision_mode
    from brushstroke_engine_torch.train.loop import LoopHooks, TrainingLoop
    from brushstroke_engine_torch.utils.util import tree_leaves

    set_precision_mode("strict")
    per_tick = dict(geom_interval=8, kimg_per_tick=TRAIN_BATCH / 1000.0)
    cfg = flagship_train_config(TRAIN_RES, TRAIN_BATCH,
                                geom_warmstart_kimg=0, **per_tick)
    state, enc_p, enc_s = flagship_train_setup(cfg, SEED, NOISE_STRENGTH,
                                               "cuda")
    # A mid-training ADA strength, so the warp does more than identity.
    state["ada_p"] = torch.full((), 0.5, device="cuda")
    g0, d0 = tree_leaves(state["g_params"]), tree_leaves(state["d_params"])
    rows = []
    hooks = LoopHooks(on_tick=lambda loop, st: rows.append(dict(st)))
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    n = TRAIN_BATCHES
    try:
        loop = TrainingLoop(cfg, enc_p, enc_s, style_iter, geom_iter,
                            run_dir, seed=SEED, hooks=hooks,
                            resume_state=state, profile_phases=True,
                            device="cuda")
        fir4_epilogue.launches = 0        # the training path starts here
        tw.warp_twopass.launches = 0
        tw.warp_twopass_t.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loop.run(total_kimg=(n * TRAIN_BATCH - 0.5) / 1000.0)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        check(loop.batch_idx == n, f"{loop.batch_idx} batches, want {n}")

        warm_cfg = flagship_train_config(TRAIN_RES, TRAIN_BATCH, **per_tick)
        warm_rows = []
        warm = TrainingLoop(
            warm_cfg, enc_p, enc_s, style_iter, geom_iter, run_dir,
            seed=SEED + 1, resume_state=loop.state, profile_phases=True,
            hooks=LoopHooks(on_tick=lambda lp, st: warm_rows.append(dict(st))),
            device="cuda")
        check(warm.in_warmstart(), "the second loop is not in warm start")
        warm.run(total_kimg=(WARM_BATCHES * TRAIN_BATCH - 0.5) / 1000.0)
        torch.cuda.synchronize()
        launches = {"fir4_epilogue": fir4_epilogue.launches,
                    "warp_twopass": tw.warp_twopass.launches,
                    "warp_twopass_t": tw.warp_twopass_t.launches}
        # the training path ends here
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    check(len(rows) == n and len(warm_rows) == WARM_BATCHES,
          f"{len(rows)} + {len(warm_rows)} ticks")
    for i, row in enumerate(rows + warm_rows):
        bad = [k for k, v in row.items() if not np.isfinite(v)]
        check(not bad, f"batch {i}: non-finite stats {bad}")
    for key in ("Loss/D/loss", "Loss/D/reg", "Loss/r1_penalty", "Loss/G/loss",
                "Loss/G/reg", "Loss/pl_penalty", "Loss/forger/Ggeom/total"):
        check(key in rows[0], f"batch 0 ran no phase that reports {key}")
    check(all("Loss/forger/Ggeom-warm/total" in r for r in warm_rows),
          "warm-start batches report no Ggeom-warm loss")
    ada_ps = [r["Progress/ada_p"] for r in rows]
    ada_p = ada_ps[-1]
    check(min(ada_ps) >= 0 and any(p != 0.5 for p in ada_ps),
          f"ada_p never moved from 0.5, or went negative: {ada_ps}")
    for name, before, tree in (("g_params", g0, loop.state["g_params"]),
                               ("d_params", d0, loop.state["d_params"])):
        moved = sum(not torch.equal(a, b)
                    for a, b in zip(before, tree_leaves(tree)))
        check(moved == len(before), f"{name}: {moved}/{len(before)} tensors "
              f"changed")

    # Launch counts against the schedule.  Generator passes: Dmain, Gmain,
    # Gpl, Ggeom and each warm batch, n_up FIR launches each.  W: two
    # discriminator passes in Dmain, one in Dr1 plus one when its penalty is
    # differentiated through W^T, one in Gmain.  W^T: the backward of Dr1's
    # and Gmain's warp.
    sched = {"Dmain": n, "Gmain": n,
             "Dr1": len(range(0, n, cfg.d_reg_interval)),
             "Gpl": len(range(0, n, cfg.g_reg_interval)),
             "Ggeom": len(range(0, n, cfg.geom_interval))}
    n_up = len(cfg.gen_cfg.synthesis.block_resolutions) - 1
    want = {"fir4_epilogue": n_up * (sched["Dmain"] + sched["Gmain"]
                                     + sched["Gpl"] + sched["Ggeom"]
                                     + WARM_BATCHES),
            "warp_twopass": 2 * sched["Dmain"] + 2 * sched["Dr1"]
            + sched["Gmain"],
            "warp_twopass_t": sched["Dr1"] + sched["Gmain"]}
    print(f"[train] launches {json.dumps(launches)} over {n} batches "
          f"{json.dumps(sched)} + {WARM_BATCHES} warm-start batches",
          flush=True)
    check(launches == want, f"kernel launches {launches}, schedule says "
          f"{want}")

    def median(key, rs):
        vals = [r[key] for r in rs if key in r]
        return statistics.median(vals), len(vals)

    phases = {}
    for phase in ("Dmain", "Dreg", "Gmain", "Greg", "Ggeom"):
        # Batch 0 warms up cuDNN's algorithm choice; every phase runs again
        # after it.
        rs = rows[1:]
        sec, cnt = median(f"Timing/{phase}", rs)
        batch = TRAIN_BATCH // 2 if phase == "Greg" else TRAIN_BATCH
        phases[phase] = {"median_s": sec, "timed_batches": cnt,
                         "images_per_s": batch / sec}
    sec, cnt = median("Timing/Ggeom-warm", warm_rows)
    phases["Ggeom-warm"] = {"median_s": sec, "timed_batches": cnt,
                            "images_per_s": TRAIN_BATCH / sec}
    plain = [r["Timing/sec_per_tick"] for r in rows[1:]
             if "Timing/Dreg" not in r and "Timing/Greg" not in r]
    train = {"card": card, "batches": n, "warm_batches": WARM_BATCHES,
             "wall_s": main_s, "images_per_s_overall": n * TRAIN_BATCH / main_s,
             "sec_per_batch_median": statistics.median(
                 r["Timing/sec_per_tick"] for r in rows[1:]),
             "sec_per_batch_dmain_gmain_only": statistics.median(plain),
             "phases": phases, "peak_memory_gib": peak_gb, "ada_p": ada_p,
             "launches": launches, "schedule": sched}
    print("[train] " + json.dumps(train), flush=True)
    for phase, v in phases.items():
        print(f"[train] {phase}: {v['median_s'] * 1e3:.1f} ms median of "
              f"{v['timed_batches']} synchronised batches, "
              f"{v['images_per_s']:.1f} images/s ({card})", flush=True)

    # The card against the CPU: the first Dmain, Dr1, Gmain, Gpl batch at
    # B = 8, same weights, same data, same draws.
    b = 8
    cfg8 = flagship_train_config(TRAIN_RES, b, geom_warmstart_kimg=0)
    draws = _phase_draws(cfg8, b, SEED + 3)
    real_u8 = next(style_iter)[:b]
    tri_u8 = next(geom_iter)[:b]
    fir4_before = fir4_epilogue.launches
    gpu, conv0 = _four_phases(cfg8, "cuda", draws, real_u8, tri_u8)
    check(fir4_epilogue.launches > fir4_before, "B=8 phases: no FIR launch")
    for k, v in conv0.items():
        check(np.isfinite(v) and v > 0,
              f"Gmain passes no gradient to {k}.conv0.weight ({v})")
    print(f"[train] Gmain d loss / d conv0.weight, max abs: "
          f"{json.dumps(conv0)}", flush=True)
    t0 = time.time()
    cpu, conv0_cpu = _four_phases(cfg8, "cpu", draws, real_u8, tri_u8)
    errs = {k: abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-3) for k in cpu}
    print("[train] CUDA vs CPU per stat (cuda, cpu, rel err): " + json.dumps(
        {k: [gpu[k], cpu[k], errs[k]] for k in cpu}), flush=True)
    worst = max(errs.values())
    for k, err in errs.items():
        check(err <= TRAIN_RTOL, f"CUDA vs CPU {k}: {gpu[k]} vs {cpu[k]} "
              f"(rel {err:.3e})")
    for k in conv0:
        err = abs(conv0[k] - conv0_cpu[k]) / conv0_cpu[k]
        check(err <= 1e-3, f"CUDA vs CPU conv0 gradient {k}: {conv0[k]} vs "
              f"{conv0_cpu[k]}")
    print(f"[train] CUDA vs CPU, B={b}, Dmain+Dr1+Gmain+Gpl, "
          f"{len(cpu)} stats: worst rel err {worst:.3e} (CPU side "
          f"{time.time() - t0:.1f} s)", flush=True)
    train["cuda_vs_cpu_worst_rel_err"] = worst
    return train


def _quantiles(times):
    deciles = statistics.quantiles(times, n=10)
    return {"p10": deciles[0], "p50": statistics.median(times),
            "p90": deciles[-1], "n": len(times)}


def _full_strokes(n, canvas):
    """``n`` overlapping full-patch origins (x, y) along a diagonal, each
    reaching canvas the earlier ones did not; even, as level 2 aligns."""
    step, drop = RES * 3 // 16, RES * 5 // 32
    return [((i * step) % (canvas - RES) // 2 * 2,
             (RES // 16 + i * drop) % (canvas - RES) // 2 * 2)
            for i in range(n)]


def _partial_strokes(canvas):
    """(x, y, rows, cols) of smaller-than-patch strokes in corners the full
    strokes leave blank, the last against the right edge."""
    return [(int(fx * canvas), int(fy * canvas), int(fh * RES),
             int(fw * RES)) for fx, fy, fh, fw in (
                 (0.04, 0.76, 0.375, 0.5), (0.2, 0.88, 0.25, 0.25),
                 (0.78, 0.04, 0.47, 0.625), (1 - 0.25 * RES / canvas, 0.3,
                                             0.31, 0.25))]


def _paint_helper_run(engine, strokes, canvas, checked):
    """Paint ``strokes`` ((x, y, rows, cols)) through a PaintingHelper at
    level 2 with crop margin 10; if ``checked``, hold each stroke's shape,
    metadata, K1 launches and mask growth.  Returns (helper, images,
    seconds per stroke)."""
    import numpy as np
    from brushstroke_engine_torch.engine.canvas import PaintingHelper
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    n_up = len(engine.gen_cfg.synthesis.block_resolutions) - 1
    helper = PaintingHelper(engine, style_seed=SEED)
    helper.make_new_canvas(canvas, canvas, feature_blending=PAINT_LEVEL)
    opts = helper.default_brush_options()
    patch = _stroke_patch(RES)
    cm = PAINT_CROP
    images, times, covered = [], [], 0
    for i, (x, y, h, w) in enumerate(strokes):
        before = fir4_epilogue.launches
        opts.set_position(x, y)
        t0 = time.perf_counter()
        img, _, meta = helper.render_stroke(
            np.roll(patch, 8 * i, 1)[:h, :w], None, opts,
            meta={"x": x, "y": y, "crop_margin": cm})
        times.append(time.perf_counter() - t0)
        images.append((img, meta))
        if not checked:
            continue
        tag = f"stroke {i} at ({x}, {y}) {h}x{w}"
        check(img.shape == (RES - 2 * cm, RES - 2 * cm, 4)
              and img.dtype == np.uint8, f"{tag}: image {img.shape}")
        gx, gy = meta["x"] - cm, meta["y"] - cm
        if (h, w) == (RES, RES):
            check((gx, gy) == (x, y), f"{tag}: meta {meta}")
        check(0 <= gx <= canvas - RES and 0 <= gy <= canvas - RES
              and gx <= x and gx + RES >= x + w and gy <= y
              and gy + RES >= y + h, f"{tag}: window {meta} misses it")
        check(fir4_epilogue.launches - before == n_up,
              f"{tag}: {fir4_epilogue.launches - before} K1 launches")
        now = int(helper.feature_canvas.mask.sum())
        check(now > covered, f"{tag}: the feature mask did not grow")
        covered = now
    return helper, images, times


def _session_run(engine, positions, canvas, checked):
    """DevicePaintSession strokes at ``positions``; if ``checked``, hold
    shapes, metadata, K1 launches and that the canvas stays the same CUDA
    tensors.  Returns (session, images, seconds per stroke)."""
    import numpy as np
    from brushstroke_engine_torch.engine.brush import GanBrushOptions
    from brushstroke_engine_torch.engine.device_canvas import \
        DevicePaintSession
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    n_up = len(engine.gen_cfg.synthesis.block_resolutions) - 1
    session = DevicePaintSession(engine, canvas, canvas,
                                 feature_blending_level=PAINT_LEVEL,
                                 crop_margin=PAINT_CROP)
    ptrs = (session.canvas.features.data_ptr(),
            session.canvas.mask.data_ptr())
    opts = GanBrushOptions()
    opts.set_style(engine.random_style(11), style_id=11)
    patch = _stroke_patch(RES)
    images, times = [], []
    for i, (x, y) in enumerate(positions):
        before = fir4_epilogue.launches
        t0 = time.perf_counter()
        img, meta = session.render_stroke(np.roll(patch, 8 * i, 0), opts,
                                          x=x, y=y)
        times.append(time.perf_counter() - t0)
        images.append((img, meta))
        if not checked:
            continue
        c = session.canvas
        check(img.shape == (RES - 2 * PAINT_CROP,) * 2 + (4,)
              and meta == {"x": x + PAINT_CROP, "y": y + PAINT_CROP},
              f"session stroke {i}: {img.shape} {meta}")
        check(fir4_epilogue.launches - before == n_up,
              f"session stroke {i}: {fir4_epilogue.launches - before} K1 "
              f"launches")
        check(c.features.is_cuda and c.mask.is_cuda and
              (c.features.data_ptr(), c.mask.data_ptr()) == ptrs,
              f"session stroke {i}: the canvas left the card or was "
              f"reallocated")
    return session, images, times


def _stylizers(engine, geom, batch):
    """name -> a call of that stylizer on ``geom`` with the paint phase's
    margins and blending; ``batch`` None = each one's default."""
    from brushstroke_engine_torch.engine.canvas import PaintingHelper
    from brushstroke_engine_torch.engine import stylize as st
    kw = dict(overlap_margin=STYLIZE_OVERLAP, crop_margin=PAINT_CROP,
              feature_blending_level=PAINT_LEVEL)
    bkw = {} if batch is None else {"batch_size": batch}
    return {
        "sequential": lambda o: st.stylize_image(
            PaintingHelper(engine, style_seed=SEED), geom, o, **kw),
        "batched": lambda o: st.stylize_image_batched(engine, geom, o,
                                                      **kw, **bkw),
        "ondevice": lambda o: st.stylize_image_ondevice(engine, geom, o,
                                                        **kw, **bkw),
    }


def _style_opts(engine, seed):
    from brushstroke_engine_torch.engine.brush import GanBrushOptions
    opts = GanBrushOptions()
    opts.set_style(engine.random_style(seed), style_id=seed)
    return opts


def _u8_err(a, b):
    return int(abs(a.astype(int) - b.astype(int)).max())


def phase_paint(card):
    import numpy as np
    import torch
    from brushstroke_engine_torch.data.curves import line_drawing
    from brushstroke_engine_torch.engine import stylize as st
    from brushstroke_engine_torch.flagship import (
        flagship_engine, flagship_trees,
    )
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    from brushstroke_engine_torch.ops.precision import set_precision_mode

    set_precision_mode("strict")
    t_phase = time.time()
    trees = flagship_trees(RES, SEED, NOISE_STRENGTH)
    trees_c = flagship_trees(RES, SEED, NOISE_STRENGTH, "canvas")
    engine = _engine(0, "cuda", trees)
    cengine = flagship_engine(trees_c, RES, 0, "cuda", "canvas")
    n_up = len(engine.gen_cfg.synthesis.block_resolutions) - 1
    t0 = time.perf_counter()
    drawing = line_drawing(STYLIZE_SIZE, STYLIZE_STROKES, SEED)
    print(f"[paint] {STYLIZE_SIZE}^2 line drawing ({STYLIZE_STROKES} strokes) "
          f"drawn on the host in {time.perf_counter() - t0:.2f} s", flush=True)
    padded, stride = st.pad_geometry(drawing, RES, STYLIZE_OVERLAP)
    crops = st.generate_stitching_crops(padded.shape, RES, STYLIZE_OVERLAP,
                                        geom=padded)
    # Generator passes per image: one per tile, or one per chunk of the
    # wave renderers' default batches (16 and 32).
    chunks = {"sequential": len(crops),
              "batched": len(st._prepare_wave_chunks(crops, stride, 16)[0]),
              "ondevice": len(st._prepare_wave_chunks(crops, stride, 32)[0])}
    out = {"card": card}

    fir4_epilogue.launches = 0            # the paint path starts here
    passes = 0
    # PaintingHelper: 12 overlapping full strokes and 4 partial patches,
    # each checked, then PAINT_TIMED strokes on a new canvas of the same
    # size; the first of those has nothing stored to blend, so its time is
    # left out of the quantiles.
    full = [(x, y, RES, RES) for x, y in _full_strokes(12, PAINT_CANVAS)]
    helper, _, _ = _paint_helper_run(
        engine, full + _partial_strokes(PAINT_CANVAS), PAINT_CANVAS, True)
    passes += 16
    feats = helper.feature_canvas.features
    check(feats.is_cuda and tuple(feats.shape) == (
        1, PAINT_CANVAS // 2, PAINT_CANVAS // 2,
        engine.gen_cfg.synthesis.channels(RES // 2)),
        f"feature canvas {tuple(feats.shape)} on {feats.device}")
    check(bool(torch.isfinite(feats).all()), "non-finite feature canvas")
    timed = [(x, y, RES, RES) for x, y in
             _full_strokes(PAINT_TIMED, PAINT_CANVAS)]
    _, _, times = _paint_helper_run(engine, timed, PAINT_CANVAS, False)
    passes += PAINT_TIMED
    out["helper_stroke_ms"] = _quantiles([t * 1e3 for t in times[1:]])
    out["feature_canvas_mib"] = feats.numel() * feats.element_size() / 2 ** 20
    print(f"[paint] PaintingHelper {PAINT_CANVAS}^2 level {PAINT_LEVEL}: 16 "
          f"strokes checked (shapes, meta, mask growth, {n_up} K1 launches "
          f"each); feature canvas {out['feature_canvas_mib']:.0f} MiB on "
          f"the card; blended stroke ms p10/p50/p90 "
          f"{out['helper_stroke_ms']['p10']:.3f} / "
          f"{out['helper_stroke_ms']['p50']:.3f} / "
          f"{out['helper_stroke_ms']['p90']:.3f} ({card})", flush=True)

    # DevicePaintSession: 3 warm-up strokes, then PAINT_TIMED.
    positions = [(x, y) for x, y, _, _ in timed[:3] + timed]
    session, _, times = _session_run(engine, positions, PAINT_CANVAS, True)
    passes += len(positions)
    check(bool(torch.isfinite(session.canvas.features).all())
          and session.canvas.mask.sum().item() > 0, "session canvas")
    out["session_stroke_ms"] = _quantiles([t * 1e3 for t in times[3:]])
    print(f"[paint] DevicePaintSession {PAINT_CANVAS}^2: {len(positions)} "
          f"strokes checked, canvas on the card throughout; stroke ms "
          f"p10/p50/p90 {out['session_stroke_ms']['p10']:.3f} / "
          f"{out['session_stroke_ms']['p50']:.3f} / "
          f"{out['session_stroke_ms']['p90']:.3f} ({card})", flush=True)
    del helper, session

    # The three stylizers on the 2048-px drawing: one warm-up call each,
    # then one timed call.
    out["stylize"] = {"size": STYLIZE_SIZE, "padded": list(padded.shape),
                      "tiles": len(crops), "chunks": chunks}
    results = {}
    for name, fn in _stylizers(engine, drawing, None).items():
        for rep in range(2):
            before = fir4_epilogue.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            canvas = fn(_style_opts(engine, 7))
            sec = time.perf_counter() - t0
            passes += chunks[name]
            check(fir4_epilogue.launches - before == n_up * chunks[name],
                  f"{name}: {fir4_epilogue.launches - before} K1 launches "
                  f"for {chunks[name]} generator passes")
        check(canvas.shape == padded.shape + (4,) and canvas.dtype == np.uint8
              and canvas[..., 3].max() > 0, f"{name}: canvas {canvas.shape}")
        results[name] = canvas
        out["stylize"][name] = {"seconds": sec, "tiles_per_s": len(crops) / sec}
        print(f"[paint] {name} stylize {STYLIZE_SIZE}^2 ({len(crops)} tiles, "
              f"{chunks[name]} generator passes): {sec:.3f} s, "
              f"{len(crops) / sec:.1f} tiles/s ({card})", flush=True)
    wave_err = _u8_err(results["batched"], results["ondevice"])
    check(wave_err <= 1, f"batched vs ondevice waves: {wave_err} LSB")

    # The canvas-format engine: its four modes, then one blended stroke.
    cpatch = _stroke_patch(RES)
    modes = {}
    for mode in ("clear", "stroke", "canvas", "full"):
        cengine.set_render_mode(mode)
        opts = _stroke_opts(cengine)
        opts.enable_uvs_mapping = False
        before = fir4_epilogue.launches
        u8, _ = cengine.render_stroke(cpatch, None, opts)
        rgba = cengine._run_core(cengine.prepare_geom_input(cpatch),
                                 opts)["rgba"][0].cpu().numpy()
        passes += 2
        check(fir4_epilogue.launches - before == 2 * n_up,
              f"canvas engine {mode}: K1 launches")
        check(u8.shape == (RES, RES, 4) and np.isfinite(rgba).all(),
              f"canvas engine {mode}: output {u8.shape}")
        # The generated canvas color is the head's raw output (no tanh), so
        # only the stroke modes stay inside [0, 1] before the uint8 clip.
        if mode in ("clear", "stroke"):
            check(rgba.min() >= -1e-6 and rgba.max() <= 1 + 1e-6,
                  f"canvas engine {mode}: RGBA outside [0, 1]")
        if mode != "clear":
            check(bool((rgba[..., 3] == 1).all()), f"{mode}: alpha != 1")
        modes[mode] = (u8, rgba)
    cengine.set_render_mode("clear")
    chelper, cimgs, _ = _paint_helper_run(
        cengine, [(0, 0, RES, RES), (RES // 4, RES // 8, RES, RES)],
        CMP_CANVAS, True)
    passes += 2
    launches = fir4_epilogue.launches     # the paint path ends here
    check(launches == n_up * passes,
          f"{launches} K1 launches for {passes} generator passes")
    out.update(launches=launches, passes=passes)
    print(f"[paint] canvas engine: 4 modes + 2 blended strokes ok; paint "
          f"path {passes} generator passes, {launches} fir4_epilogue "
          f"launches ({n_up} per pass)", flush=True)

    # CUDA against the CPU on smaller requests.
    t_cpu = 0.0
    cmp = {}
    cpu_engine = _engine(0, "cpu", trees)
    cpu_cengine = flagship_engine(trees_c, RES, 0, "cpu", "canvas")
    strokes = [(0, 0, RES, RES), (RES * 3 // 8, RES // 4, RES, RES),
               (CMP_CANVAS - RES * 3 // 4, CMP_CANVAS * 5 // 8,
                RES * 3 // 8, RES * 5 // 16)]
    pos = [(x, y) for x, y, _, _ in strokes[:2]] + [(CMP_CANVAS - RES,) * 2]
    runs = {}
    for dev, eng in (("cuda", engine), ("cpu", cpu_engine)):
        t0 = time.time()
        h, imgs, _ = _paint_helper_run(eng, strokes, CMP_CANVAS, False)
        s, simgs, _ = _session_run(eng, pos, CMP_CANVAS, False)
        runs[dev] = (h.feature_canvas, imgs, s.canvas, simgs)
        if dev == "cpu":
            t_cpu += time.time() - t0
    (hc, ic, sc, sic), (hp, ip, sp, sip) = runs["cuda"], runs["cpu"]
    cmp["helper_u8"] = max(_u8_err(a[0], b[0]) for a, b in zip(ic, ip))
    check(all(a[1] == b[1] for a, b in zip(ic, ip)), "helper meta CUDA/CPU")
    check(bool((hc.mask == hp.mask).all()), "helper mask CUDA vs CPU")
    cmp["helper_features"] = (hc.features.cpu() - hp.features).abs().max() \
        .item()
    cmp["session_u8"] = max(_u8_err(a[0], b[0]) for a, b in zip(sic, sip))
    check(torch.equal(sc.mask.cpu(), sp.mask), "session mask CUDA vs CPU")
    cmp["session_features"] = (sc.features.cpu() - sp.features).abs().max() \
        .item()
    small = line_drawing(CMP_DRAWING, 6, SEED + 1, span=CMP_DRAWING // 2)
    for name in ("sequential", "batched", "ondevice"):
        a = _stylizers(engine, small, None)[name](_style_opts(engine, 7))
        t0 = time.time()
        b = _stylizers(cpu_engine, small, CMP_BATCH)[name](
            _style_opts(cpu_engine, 7))
        t_cpu += time.time() - t0
        cmp[f"stylize_{name}_u8"] = _u8_err(a, b)
    t0 = time.time()
    cmode_err = 0.0
    for mode, (u8, rgba) in modes.items():
        cpu_cengine.set_render_mode(mode)
        opts = _stroke_opts(cpu_cengine)
        opts.enable_uvs_mapping = False
        ref = cpu_cengine._run_core(cpu_cengine.prepare_geom_input(cpatch),
                                    opts)["rgba"][0].numpy()
        cmode_err = max(cmode_err, float(abs(ref - rgba).max()))
        ref_u8 = np.clip(ref * 255.0, 0, 255).astype(np.uint8)
        cmp[f"canvas_{mode}_u8"] = _u8_err(u8, ref_u8)
    cpu_cengine.set_render_mode("clear")
    _, cpu_cimgs, _ = _paint_helper_run(
        cpu_cengine, [(0, 0, RES, RES), (RES // 4, RES // 8, RES, RES)],
        CMP_CANVAS, False)
    cmp["canvas_blended_u8"] = max(_u8_err(a[0], b[0])
                                   for a, b in zip(cimgs, cpu_cimgs))
    t_cpu += time.time() - t0
    cmp["canvas_rgba"] = cmode_err
    print("[paint] CUDA vs CPU (uint8 LSB, f32 max abs): " + json.dumps(cmp),
          flush=True)
    for k, v in cmp.items():
        lim = 1 if k.endswith("_u8") else RENDER_ATOL
        check(v <= lim, f"paint CUDA vs CPU {k}: {v} > {lim}")
    out["cuda_vs_cpu"] = cmp
    out["cpu_seconds"] = t_cpu
    out["seconds"] = time.time() - t_phase
    print(f"[paint] phase {out['seconds']:.1f} s (CPU references "
          f"{t_cpu:.1f} s)", flush=True)
    print("[paint] " + json.dumps(out), flush=True)
    return out


def phase_serve(card):
    """The drawing server's core on the card through its four image paths
    (see the module doc, phase 9)."""
    import numpy as np
    from brushstroke_engine_torch.flagship import (
        flagship_encoder_config, flagship_generator_config, flagship_trees,
    )
    from brushstroke_engine_torch.ops.cuda_build import BUILD_DIR
    from brushstroke_engine_torch.ops.fir_epilogue import fir4_epilogue
    from brushstroke_engine_torch.ops.precision import set_precision_mode
    from brushstroke_engine_torch.tools import bench_serve as bs
    from brushstroke_engine_torch.ui.core import (
        WARM_BATCHES, create_core, warmup_engine,
    )
    from brushstroke_engine_torch.utils.checkpoint import (
        EngineBundle, params_from_jax, save_native,
    )

    set_precision_mode("strict")
    t_phase = time.time()
    trees = {k: params_from_jax(v) for k, v in
             flagship_trees(RES, SEED, NOISE_STRENGTH).items()}
    os.makedirs(BUILD_DIR, exist_ok=True)
    bundle_path = os.path.join(BUILD_DIR, "serve_flagship.pkl")
    save_native(bundle_path, EngineBundle(
        flagship_generator_config(RES, (0, 1)), trees["gen_params"],
        trees["gen_state"], flagship_encoder_config(), trees["enc_params"],
        trees["enc_state"], geom_inject_resolutions=(0, 1)))
    core = create_core(gan_checkpoint=bundle_path, device="cuda")
    engine = core.engine
    check(engine.device.type == "cuda" and engine.patch_width == RES,
          f"served engine {engine.device} {engine.patch_width} px")
    warmup_engine(engine)
    n_up = len(engine.gen_cfg.synthesis.block_resolutions) - 1
    kw = dict(canvas=SERVE_CANVAS, level=PAINT_LEVEL, crop=PAINT_CROP,
              seed=SEED)
    want_path = {"helper": "helper", "device_canvas": "device_canvas",
                 "batched": "batched", "pooled": "device_batched"}
    runs, launches, served, passes, worst = [], 0, 0, 0, 0
    flush_batches = set()
    for path in bs.PATHS:
        for sessions, strokes, warm in SERVE_RUNS:
            tag = f"{path} x{sessions}"
            serving = bs.make_core(engine, path, SERVE_WINDOW_MS,
                                   SERVE_CANVAS, PAINT_LEVEL, PAINT_CROP)
            fir4_epilogue.launches = 0    # this serve run starts here
            stats, painters = bs.serve(
                serving, path, sessions, strokes, warm,
                trace_strokes=SERVE_TRACE, keep_images=True, **kw)
            n = fir4_epilogue.launches    # and ends here
            serving.close()
            # Every batch a flush of this run launched K1 at (warm-up
            # included) was held against the plain version in phase 3.
            flushed = {b for bt in (serving.batcher, serving.dev_batcher)
                       if bt is not None for b in bt.batch_sizes}
            check(flushed <= set(K1_PATH_BATCHES)
                  and set(WARM_BATCHES) <= set(K1_PATH_BATCHES),
                  f"{tag}: K1 launched at batches {sorted(flushed)}, "
                  f"checked at {K1_PATH_BATCHES}")
            flush_batches.update(flushed)
            check(stats["k1_launches"] == n and n == n_up
                  * stats["generator_passes"],
                  f"{tag}: {n} K1 launches for "
                  f"{stats['generator_passes']} generator passes")
            check(stats["fallbacks"] == 0 and stats["errors"] == 0,
                  f"{tag}: {stats['fallbacks']} fallbacks, "
                  f"{stats['errors']} errors")
            total = sessions * (warm + strokes + SERVE_TRACE)
            check(stats["strokes_served"] == total
                  and all(len(p.records) == warm + strokes + SERVE_TRACE
                          for p in painters), f"{tag}: replies missing")
            check(stats["timed_paths"] == [want_path[path]],
                  f"{tag}: served by {stats['timed_paths']}")
            batched = path in ("batched", "pooled")
            if batched and sessions > 1:
                check(stats["rows_per_pass"]["mean"] > 1,
                      f"{tag}: {stats['rows_per_pass']} rows per pass")
            run_worst = 0
            for p in (painters if batched else painters[:1]):
                replay = bs.serial_replay(engine, path, p, SERVE_CANVAS,
                                          PAINT_LEVEL, PAINT_CROP)
                for i, (r, (img, meta)) in enumerate(zip(p.records,
                                                         replay)):
                    err = _u8_err(r["image"], img)
                    run_worst = max(run_worst, err)
                    check(r["meta"] == meta and err <= 1,
                          f"{tag}: stroke {i} served {r['meta']} vs serial "
                          f"{meta}, {err} LSB")
            for p in painters:
                p.records = None          # the images are checked
            launches += n
            served += total
            passes += stats["generator_passes"]
            worst = max(worst, run_worst)
            stats["replay_max_lsb"] = run_worst
            runs.append(stats)
            check(stats["device"] is not None, f"{tag}: no device trace")
            idle = stats["device"]["idle_share"]
            rows = stats["rows_per_pass"]
            print(f"[serve] {tag}: client ms p50/p99 "
                  f"{stats['client_ms']['p50']:.2f} / "
                  f"{stats['client_ms']['p99']:.2f}, server_ms p50 "
                  f"{stats['server_ms']['p50']:.2f}, render_ms p50 "
                  f"{stats['render_ms']['p50']:.2f}, "
                  f"{stats['strokes_per_s']:.1f} strokes/s, rows per pass "
                  f"{rows['mean'] if rows else 1:.2f}, idle {idle:.3f}, "
                  f"{n} K1 launches ({card})", flush=True)
    core.close()

    # Each serial path against the same core on the CPU.
    t0 = time.time()
    cpu_core = create_core(gan_checkpoint=bundle_path, device="cpu")
    cmp = {}
    for path in ("helper", "device_canvas"):
        out = []
        for eng in (engine, cpu_core.engine):
            _, painters = bs.run_path(
                eng, path, 1, SERVE_CMP_STROKES, 0, canvas=CMP_CANVAS,
                level=PAINT_LEVEL, crop=PAINT_CROP, seed=SEED + 1,
                trace_strokes=0, keep_images=True, warm_core=False)
            out.append(painters[0].records)
        check(len(out[0]) == len(out[1]) == SERVE_CMP_STROKES
              and all(a["meta"] == b["meta"] for a, b in zip(*out)),
              f"{path}: CUDA vs CPU replies")
        cmp[f"{path}_u8"] = max(_u8_err(a["image"], b["image"])
                                for a, b in zip(*out))
        check(cmp[f"{path}_u8"] <= 1,
              f"{path}: CUDA vs CPU {cmp[f'{path}_u8']} LSB")
    cpu_core.close()
    out = {"runs": runs, "launches": launches, "strokes_served": served,
           "generator_passes": passes, "replay_max_lsb": worst,
           "flush_batches": sorted(flush_batches),
           "cuda_vs_cpu_u8": cmp, "cpu_seconds": time.time() - t0,
           "seconds": time.time() - t_phase, "card": card}
    print(f"[serve] {served} strokes served in {passes} generator passes, "
          f"{launches} K1 launches ({n_up} per pass; flushes of "
          f"{sorted(flush_batches)} rows); served vs serial "
          f"replay max {worst} LSB; CUDA vs CPU {json.dumps(cmp)} (CPU "
          f"{out['cpu_seconds']:.1f} s); phase {out['seconds']:.1f} s",
          flush=True)
    return out


def main():
    t_start = time.time()
    card = phase_card()
    import torch
    sys.path.insert(0, REPO)
    # The training data starts prefetching now: rasterizing the synthetic
    # geometry on the host takes about as long as the kernel phases.
    from brushstroke_engine_torch.flagship import synthetic_data_iters
    style_iter, geom_iter = synthetic_data_iters(TRAIN_RES, TRAIN_BATCH, SEED)
    phase_build()
    rows, max_err = phase_kernel_vs_plain()
    fir_bwd = phase_fir_backward()
    warp_rows, warp_err = phase_warp_vs_plain()
    main_stats = phase_main_path()
    train = phase_train(style_iter, geom_iter, card)
    paint = phase_paint(card)
    serve = phase_serve(card)

    top = next(r for r in rows if r["res"] == RES and r["dtype"] == "float32")
    warp = next(r for r in warp_rows if r["mats"] == "ada_p1"
                and r["shape"][0] == TRAIN_BATCH and r["antialias"])
    kernels = [{
        "name": "fir4_epilogue",
        "route": "cuda",
        "source": "brushstroke_engine_torch/csrc/fir4_epilogue.cu",
        "replaces": "brushstroke_engine_tpu/ops/pallas_fir.py:85",
        "launches": main_stats["launches"]
        + train["launches"]["fir4_epilogue"] + paint["launches"]
        + serve["launches"],
        "launches_render_path": main_stats["launches"],
        "launches_training_path": train["launches"]["fir4_epilogue"],
        "launches_paint_path": paint["launches"],
        "launches_serve_path": serve["launches"],
        "max_abs_err": max_err[torch.float32],
        "max_abs_err_bf16": max_err[torch.bfloat16],
        "backward_max_rel_err": fir_bwd["worst_rel_err"],
        "ms": top["kernel_ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "shape": f"B={BATCH} res={RES} C={top['channels']} float32, "
                 f"noise+clamp",
    }]
    for name, fn, key, err in (
            ("warp_twopass", "_fwd_kernel", "w", "max_abs_err_w"),
            ("warp_twopass_t", "_bwd_kernel", "wt", "max_abs_err_wt")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "brushstroke_engine_torch/csrc/warp_twopass.cu",
            "replaces": "brushstroke_engine_tpu/ops/pallas_warp.py:"
                        + ("125" if fn == "_fwd_kernel" else "156"),
            "launches": train["launches"][name],
            "max_abs_err": warp_err[key],
            "ms": warp[f"{key}_ms"],
            "plain_ms": warp[f"{key}_plain_ms"],
            "bound_ms": warp["bound_ms"],
            "bound_by": warp["bound_by"],
            "library_ms": warp[f"{key}_library_ms"],
            "shape": f"{warp['shape']} float32, ADA 'bgc' matrices at p=1, "
                     f"antialias",
        })
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was never launched")
    print(json.dumps({"main_path": main_stats, "training_path": train,
                      "paint_path": paint, "serve_path": serve,
                      "seconds": time.time() - t_start}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
