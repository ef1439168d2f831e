"""Fused 4x4 FIR + modulated-conv epilogue of the up-sampling synthesis layers.

Counterpart of ``brushstroke_engine_tpu/ops/pallas_fir.py``.  After the
dilated (transposed) conv of every ``conv0`` at res >= 8 the chain is

    FIR smooth (4x4, gain 4, VALID) -> * dcoefs[b, c] -> + noise[b, y, x]
    -> + bias[c] -> leaky_relu(alpha) * act_gain -> clamp(+-clamp)

:func:`fir4_epilogue` runs it as ONE pass of the hand-written CUDA kernel in
``csrc/fir4_epilogue.cu`` for a CUDA tensor, and as the plain torch version
:func:`fir4_epilogue_plain` (depthwise ``F.conv2d`` + elementwise tail) for a
CPU tensor.  There is no flag and no fallback: a CUDA input the kernel does
not take raises.

The kernel's result carries gradient: where an input requires it, the launch
sits in an ``autograd.Function`` whose backward differentiates the plain
chain on the saved inputs with torch ops (the JAX package has no backward
kernel for this chain either; its training differentiates the XLA ops),
built with a graph of its own when gradients are being recorded, so the
path-length phase can differentiate through it a second time.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from brushstroke_engine_torch.ops import cuda_build
from brushstroke_engine_torch.ops.upfirdn import nchw

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SUPPORTED = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)}


def correlation_taps(f, fir_gain: float = 4.0) -> np.ndarray:
    """Convolution taps ``f [4, 4]`` -> the correlation taps the kernel
    applies (flipped and scaled by ``fir_gain``)."""
    f = np.asarray(f, np.float32)
    if f.shape != (4, 4):
        raise ValueError(f"fir4_epilogue takes a 4x4 filter, got {f.shape}")
    return np.ascontiguousarray(f[::-1, ::-1] * np.float32(fir_gain),
                                np.float32)


@functools.lru_cache(maxsize=64)
def _taps_from_bytes(f_bytes: bytes, shape, fir_gain: float) -> np.ndarray:
    taps = correlation_taps(
        np.frombuffer(f_bytes, np.float32).reshape(shape), fir_gain)
    taps.setflags(write=False)
    return taps


def cached_taps(f, fir_gain: float = 4.0) -> np.ndarray:
    """:func:`correlation_taps` of the filter ``f``, built once per filter
    content and gain and read-only (every layer of a model passes the same
    filter on every call)."""
    if isinstance(f, torch.Tensor):
        f = f.detach().cpu().numpy()
    f = np.asarray(f, np.float32)
    return _taps_from_bytes(f.tobytes(), f.shape, float(fir_gain))


@functools.lru_cache(maxsize=64)
def _taps16(taps_bytes: bytes):
    """The 16 taps as the ``ctypes`` array the kernel's entry point reads."""
    return (ctypes.c_float * 16).from_buffer_copy(taps_bytes)


def fir4_epilogue_plain(x, taps, dcoefs, noise, bias, act_gain: float,
                        clamp: Optional[float], alpha: float = 0.2,
                        out_dtype=None):
    """Plain torch version of the kernel (its spec).

    x: ``[B, H+3, W+3, C]``; taps: ``[4, 4]`` correlation taps; dcoefs
    ``[B, C]``; noise ``[B or 1, H, W, 1]`` or None; bias ``[C]``.  Computes
    in f32 and returns ``[B, H, W, C]`` in ``out_dtype`` (default: x's).
    """
    c = x.shape[-1]
    k = torch.as_tensor(np.array(taps, np.float32), device=x.device)
    y = F.conv2d(nchw(x.float()), k[None, None].expand(c, 1, 4, 4), groups=c)
    y = y.permute(0, 2, 3, 1)
    y = y * dcoefs.float()[:, None, None, :]
    if noise is not None:
        y = y + noise.float()
    y = y + bias.float()[None, None, None, :]
    y = torch.where(y >= 0, y, alpha * y) * act_gain
    if clamp is not None:
        y = torch.clamp(y, -clamp, clamp)
    return y.to(out_dtype or x.dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """The kernel's C entry points, typed once (builds the library first if
    it is missing or stale)."""
    lib = cuda_build.load("fir4_epilogue")
    fn = lib.fir4_epilogue_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                           ctypes.c_void_p, ctypes.c_void_p] \
        + [ctypes.c_int] * 6 + [ctypes.c_float] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    err_str = lib.fir4_epilogue_error_string
    err_str.restype = ctypes.c_char_p
    err_str.argtypes = [ctypes.c_int]
    return fn, err_str


def _takes(t, dtype, shape, device) -> bool:
    return (t.dtype == dtype and tuple(t.shape) == shape
            and t.device == device and t.is_contiguous())


def _launch_kernel(x, taps, dcoefs, noise, bias, act_gain, clamp, alpha,
                   out_dtype, tile=(0, 0)):
    """Validate once, launch, count.  ``taps``: ``[4, 4]`` f32 correlation
    taps.  ``tile = (xw, strip)`` overrides the kernel's own
    choice of columns per thread and rows per strip (0 = its choice); only
    the tuning tool and the checks pass it."""
    dev = x.device
    ok = x.dim() == 4 and (x.dtype, out_dtype) in _SUPPORTED \
        and x.is_contiguous() and x.shape[1] > 3 and x.shape[2] > 3
    if ok:
        b, hp, wp, c = x.shape
        h, w = hp - 3, wp - 3
        ok = _takes(dcoefs, torch.float32, (b, c), dev) \
            and _takes(bias, torch.float32, (c,), dev) \
            and (noise is None or (
                noise.shape[0] in (1, b)
                and _takes(noise, torch.float32, (noise.shape[0], h, w, 1),
                           dev)))
    if not ok:
        def said(t):
            return None if t is None else (
                f"{t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
        raise ValueError(
            "fir4_epilogue: x must be a contiguous f32 or bf16 "
            "[B, H+3, W+3, C] tensor with H, W >= 1 and out_dtype its dtype; "
            "dcoefs [B, C], bias [C] and noise [B or 1, H, W, 1] (or None) "
            "contiguous f32 tensors on x's device; got x "
            f"{said(x)} -> {out_dtype}, dcoefs {said(dcoefs)}, noise "
            f"{said(noise)}, bias {said(bias)}")
    taps = np.ascontiguousarray(taps, np.float32)
    if taps.shape != (4, 4):
        raise ValueError(f"fir4_epilogue: taps must be [4, 4], got "
                         f"{taps.shape}")
    taps16 = _taps16(taps.tobytes())
    noise_bstride = h * w if noise is not None and noise.shape[0] == b else 0
    out = torch.empty((b, h, w, c), dtype=out_dtype, device=dev)

    fn, err_str = _kernel_fns()
    rc = fn(x.data_ptr(), out.data_ptr(), dcoefs.data_ptr(),
            None if noise is None else noise.data_ptr(), noise_bstride,
            bias.data_ptr(), ctypes.addressof(taps16),
            b, h, w, c, _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
            float(alpha), float(act_gain),
            float("inf") if clamp is None else float(clamp), *tile,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fir4_epilogue kernel launch failed: "
                           f"{err_str(rc).decode()} ({rc})")
    cuda_build.count_launch(fir4_epilogue)
    return out


class _Fir4EpilogueFn(torch.autograd.Function):
    """The kernel launch with a backward.  Forward: the kernel, always.
    Backward: gradients of ``x``, ``dcoefs``, ``noise`` and ``bias`` from
    :func:`fir4_epilogue_plain` re-run on the saved inputs."""

    @staticmethod
    def forward(ctx, x, dcoefs, noise, bias, taps, act_gain, clamp, alpha,
                out_dtype):
        ctx.save_for_backward(x, dcoefs, noise, bias)
        ctx.consts = (taps, act_gain, clamp, alpha, out_dtype)
        return _launch_kernel(x, taps, dcoefs, noise, bias, act_gain, clamp,
                              alpha, out_dtype)

    @staticmethod
    def backward(ctx, g):
        # The saved tensors keep their history, so the gradients below are
        # functions of the original inputs and a second backward follows
        # them (create_graph only when this backward is itself recorded).
        ins = ctx.saved_tensors
        taps, act_gain, clamp, alpha, out_dtype = ctx.consts
        wanted = [i for i in range(4) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            y = fir4_epilogue_plain(ins[0], taps, ins[1], ins[2], ins[3],
                                    act_gain, clamp, alpha, out_dtype)
        grads = torch.autograd.grad(
            y, [ins[i] for i in wanted], g,
            create_graph=torch.is_grad_enabled())
        out = [None] * 9
        for i, gr in zip(wanted, grads):
            out[i] = gr
        return tuple(out)


def fir4_epilogue(x, f, dcoefs, noise, bias, act_gain: float,
                  clamp: Optional[float], alpha: float = 0.2,
                  fir_gain: float = 4.0, out_dtype=None):
    """Fused FIR + epilogue; same contract as the JAX ``fir4_epilogue``.

    x: ``[B, H+3, W+3, C]`` conv output (pre-FIR), f32 or bf16;
    f: ``[4, 4]`` filter (unflipped convolution taps); dcoefs ``[B, C]`` f32;
    noise ``[B or 1, H, W, 1]`` f32 or None; bias ``[C]`` f32; clamp None =
    no clamp.  Returns ``[B, H, W, C]`` in ``out_dtype`` (default: x's; the
    kernel writes only x's dtype).

    A CUDA tensor launches the kernel (and counts the launch in
    ``fir4_epilogue.launches``); a CPU tensor takes the plain version.  Both
    are differentiable to second order.
    """
    taps = cached_taps(f, fir_gain)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return fir4_epilogue_plain(x, taps, dcoefs, noise, bias, act_gain,
                                   clamp, alpha, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fir4_epilogue: unsupported device {x.device}")
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dcoefs, noise, bias))):
        # Nothing to record (the render): the launch alone, without the
        # autograd.Function's host cost.
        return _launch_kernel(x, taps, dcoefs, noise, bias, act_gain, clamp,
                              alpha, out_dtype)
    return _Fir4EpilogueFn.apply(x, dcoefs, noise, bias, taps, act_gain,
                                 clamp, alpha, out_dtype)


fir4_epilogue.launches = 0
