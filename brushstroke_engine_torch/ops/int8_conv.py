"""The int8 convolution of the static int8 serving path.

Two entries share one hand-written kernel (``csrc/int8_conv.cu``, an
implicit GEMM on the int8 tensor cores, built by ``ops/cuda_build.py``):

* :func:`int8_conv_quantizing` -- what every quantized site runs: the float
  activation (f32 or bf16, unpadded), its scale, the site's packed weight
  (:class:`PackedWeight`, made once by :func:`quantize_weight`) and the
  padding; the kernel quantizes the activation on its way in, pads, convolves
  and dequantizes.
* :func:`int8_conv` -- a VALID, stride-1 conv of NHWC int8 activations
  (already padded) by OIHW int8 weights, with an int32 accumulator or, with
  the scales given, the dequantizing epilogue ``acc * (s_x * s_w)``.

A CUDA tensor launches the kernel, always: there is no fallback.  A CPU
tensor takes the plain version (:func:`int8_conv_quantizing_plain`,
:func:`int8_conv_plain`, :func:`int8_epilogue_plain`), which the tests and
``chip_smoke.py`` hold the kernel to bit for bit: the accumulator is exact
in both.  Both entries count into ``int8_conv.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from brushstroke_engine_torch.ops import cuda_build

_OUT_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_IN_KIND = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
K_CHUNK = 32       # the kernel's input channels per chunk (I is padded to it)
N_ALIGN = 8        # the MMA's output channels per tile (O is padded to it)


class PackedWeight(NamedTuple):
    """A site's quantized weight in the kernel's layout: ``data`` int8
    ``[ceil8(O), kh * kw * ceil32(I)]`` (the taps outer, the input channels
    inner, zeros in the padding), ``s_w`` f32 ``[O]``, ``shape`` the
    ``(O, I, kh, kw)`` of the weight it packs."""
    data: torch.Tensor
    s_w: torch.Tensor
    shape: Tuple[int, int, int, int]


def _ceil(n, m):
    return -(-n // m) * m


def pack_weight(wq):
    """int8 ``wq`` ``[O, I, kh, kw]`` -> the kernel's ``[O8, kh*kw*I32]``."""
    o, i, kh, kw = wq.shape
    w = F.pad(wq.permute(0, 2, 3, 1), [0, _ceil(i, K_CHUNK) - i])
    w = w.reshape(o, -1)
    return F.pad(w, [0, 0, 0, _ceil(o, N_ALIGN) - o]).contiguous()


def unpack_weight(data, shape):
    """The inverse of :func:`pack_weight`: ``[O, I, kh, kw]`` int8."""
    o, i, kh, kw = shape
    w = data[:o].reshape(o, kh, kw, _ceil(i, K_CHUNK))[..., :i]
    return w.permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def quantize_weight(w) -> PackedWeight:
    """Symmetric per-output-channel quantization of ``w`` ``[O, I, kh, kw]``
    (f32 or bf16): ``s_w = max(amax / 127, 1e-12)`` over (I, kh, kw),
    ``wq = clamp(rint(w / s_w), -127, 127)``, packed (no autograd history:
    a site may keep it)."""
    wf = w.float()
    s_w = torch.clamp_min(wf.abs().amax(dim=(1, 2, 3)) / 127.0, 1e-12)
    wq = torch.clamp(torch.round(wf / s_w[:, None, None, None]), -127, 127)
    return PackedWeight(pack_weight(wq.to(torch.int8)), s_w,
                        tuple(int(d) for d in w.shape))


def quantize_activation_plain(x, s_x):
    """``clamp(rint(x / s_x), -127, 127)`` as int8, ``x`` ``[B, H, W, I]``
    f32 or bf16 (widened exactly), ``s_x`` ``[B]`` or ``[1]``."""
    q = torch.round(x.float() / s_x[:, None, None, None])
    return torch.clamp(q, -127, 127).to(torch.int8)


def int8_conv_plain(xq, wq):
    """``[B, H', W', O]`` int32: the VALID conv of int8 ``xq`` ``[B, Hp, Wp,
    I]`` by int8 ``wq`` ``[O, I, kh, kw]``, summed in float64 (every product
    and partial sum is an integer below 2^53, so exact)."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double().contiguous(),
                 wq.double().contiguous())
    return y.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def int8_epilogue_plain(acc, s_x, s_w, out_dtype):
    """``acc * (s_x * s_w)`` in f32, cast to ``out_dtype``; ``s_x`` is
    ``[B]`` or ``[1]``, ``s_w`` ``[O]``."""
    scale = s_x.float()[:, None, None, None] * s_w.float()[None, None, None]
    return (acc.float() * scale).to(out_dtype)


def int8_conv_quantizing_plain(x, s_x, wp: PackedWeight, padding,
                               out_dtype):
    """The plain version of :func:`int8_conv_quantizing`: quantize, pad
    (negative crops), the int8 conv, the epilogue."""
    (py0, py1), (px0, px1) = padding
    xq = F.pad(quantize_activation_plain(x, s_x), [0, 0, px0, px1, py0, py1])
    acc = int8_conv_plain(xq, unpack_weight(wp.data, wp.shape))
    return int8_epilogue_plain(acc, s_x, wp.s_w, out_dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """The kernel's C entry points, typed once (builds the library first if
    it is missing or stale)."""
    lib = cuda_build.load("int8_conv")
    fn = lib.int8_conv_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] \
        + [ctypes.c_int] * 11 \
        + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int, ctypes.c_void_p]
    err_str = lib.int8_conv_error_string
    err_str.restype = ctypes.c_char_p
    err_str.argtypes = [ctypes.c_int]
    check = lib.int8_conv_quant_check
    check.restype = ctypes.c_int
    check.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p]
    return fn, err_str, check


def _launch(x, wdata, o, kh, kw, pads, s_x, s_w, out_dtype):
    """Launch the kernel on ``x`` (int8, f32 or bf16 ``[B, H, W, I]``,
    contiguous) and the packed ``wdata``; returns the int32 accumulator
    without scales, else the output in ``out_dtype``."""
    dev = x.device
    b, h, w, i = x.shape
    py0, py1, px0, px1 = pads
    out_shape = (b, h + py0 + py1 - kh + 1, w + px0 + px1 - kw + 1, o)
    if s_x is None:
        out = torch.empty(out_shape, dtype=torch.int32, device=dev)
        acc_ptr, out_ptr = out.data_ptr(), None
    else:
        out = torch.empty(out_shape, dtype=out_dtype, device=dev)
        acc_ptr, out_ptr = None, out.data_ptr()
    fn, err_str, _ = _kernel_fns()
    with cuda_build.on_device(dev):
        rc = fn(x.data_ptr(), _IN_KIND[x.dtype], wdata.data_ptr(), b, h, w,
                i, o, kh, kw, py0, py1, px0, px1,
                None if s_x is None else s_x.data_ptr(),
                0 if s_x is None or s_x.shape[0] == 1 else 1,
                None if s_w is None else s_w.data_ptr(), acc_ptr, out_ptr,
                _OUT_BF16.get(out_dtype, 0),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: "
                           f"{err_str(rc).decode()} ({rc})")
    cuda_build.count_launch(int8_conv)
    return out


def quant_mismatches(scales):
    """For each f32 scale ``s`` of the CUDA tensor ``scales``, how many of
    the finite floats ``v`` the kernel quantizes to another int8 than
    ``clamp(rint(v / s), -127, 127)`` with an IEEE division: an int64 tensor
    on the card.  Each scale walks all 2^32 bit patterns (about 7 ms on an
    H100).  Not counted as a launch of the conv."""
    if scales.device.type != "cuda" or scales.dtype != torch.float32 \
            or scales.dim() != 1 or scales.numel() == 0:
        raise ValueError(f"quant_mismatches: a non-empty f32 CUDA vector, "
                         f"got {scales.dtype} {tuple(scales.shape)} on "
                         f"{scales.device}")
    scales = scales.contiguous()
    out = torch.zeros(scales.numel(), dtype=torch.int64,
                      device=scales.device)
    _, err_str, check = _kernel_fns()
    with cuda_build.on_device(scales.device):
        rc = check(scales.data_ptr(), scales.numel(), out.data_ptr(),
                   torch.cuda.current_stream(scales.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv quant check failed: "
                           f"{err_str(rc).decode()} ({rc})")
    return out


def _scales_ok(s_x, s_w, b, o, out_dtype, dev):
    return (out_dtype in _OUT_BF16 and s_x.dtype == torch.float32
            and s_w.dtype == torch.float32 and s_x.dim() == 1
            and s_x.shape[0] in (1, b) and tuple(s_w.shape) == (o,)
            and s_x.is_contiguous() and s_w.is_contiguous()
            and s_x.device == dev and s_w.device == dev)


def int8_conv(xq, wq, s_x=None, s_w=None, out_dtype=torch.float32):
    """The int8 conv of ``xq`` ``[B, Hp, Wp, I]`` (NHWC, padded) by ``wq``
    ``[O, I, kh, kw]``: ``[B, Hp-kh+1, Wp-kw+1, O]`` int32 without scales,
    else ``acc * (s_x * s_w)`` in ``out_dtype`` (f32 or bf16) with ``s_x``
    f32 ``[B]`` or ``[1]`` and ``s_w`` f32 ``[O]``.

    A CUDA tensor launches the kernel (packing ``wq`` first; counted in
    ``int8_conv.launches``, its ``(B, Hp, Wp, I, O, kh, kw, out)`` in
    ``int8_conv.shapes``); a CPU tensor takes the plain version."""
    if xq.device.type == "cpu":
        acc = int8_conv_plain(xq, wq)
        return acc if s_x is None else \
            int8_epilogue_plain(acc, s_x, s_w, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {xq.device}")
    b, hp, wp, c = xq.shape
    o, i, kh, kw = wq.shape
    dev = xq.device
    ok = (xq.dtype == torch.int8 and wq.dtype == torch.int8 and c == i
          and hp >= kh and wp >= kw and wq.device == dev
          and xq.is_contiguous())
    if ok and s_x is not None:
        ok = _scales_ok(s_x, s_w, b, o, out_dtype, dev)
    if not ok:
        raise ValueError(
            "int8_conv: xq must be contiguous int8 [B, Hp, Wp, I], wq int8 "
            "[O, I, kh, kw] with kh <= Hp, kw <= Wp on the same device, s_x "
            "f32 [B] or [1] and s_w f32 [O] there, out_dtype f32 or bf16; "
            f"got xq {xq.dtype} {tuple(xq.shape)} on {xq.device}, wq "
            f"{wq.dtype} {tuple(wq.shape)} on {wq.device}, s_x "
            f"{None if s_x is None else (s_x.dtype, tuple(s_x.shape))}, s_w "
            f"{None if s_w is None else (s_w.dtype, tuple(s_w.shape))}, "
            f"out_dtype {out_dtype}")
    out = _launch(xq, pack_weight(wq), o, kh, kw, (0, 0, 0, 0), s_x, s_w,
                  out_dtype)
    int8_conv.shapes.add((b, hp, wp, i, o, kh, kw,
                          "int32" if s_x is None else str(out_dtype)))
    return out


def int8_conv_quantizing(x, s_x, wp: PackedWeight, padding,
                         out_dtype=None):
    """One quantized site: ``x`` ``[B, H, W, I]`` (NHWC, f32 or bf16,
    unpadded) quantized by ``s_x`` (f32 ``[B]`` or ``[1]``) as
    ``clamp(rint(x / s_x), -127, 127)``, padded by ``padding`` ``((py0,
    py1), (px0, px1))`` (negative crops), convolved with the packed weight
    ``wp`` and dequantized: ``acc * (s_x * wp.s_w)`` in ``out_dtype`` (x's
    dtype by default).

    A CUDA tensor launches the kernel, which quantizes x on its way in
    (counted in ``int8_conv.launches``; its ``(B, H, W, I, O, kh, kw,
    padding, x dtype, per-sample scale, out)`` in
    ``int8_conv.quantizing_shapes``); a CPU tensor takes
    :func:`int8_conv_quantizing_plain`."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return int8_conv_quantizing_plain(x, s_x, wp, padding, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv_quantizing: unsupported device "
                         f"{x.device}")
    b, h, w, i = x.shape
    o, wi, kh, kw = wp.shape
    (py0, py1), (px0, px1) = padding
    dev = x.device
    ok = (x.dtype in (torch.float32, torch.bfloat16) and wi == i
          and x.is_contiguous() and wp.data.dtype == torch.int8
          and wp.data.is_contiguous() and wp.data.device == dev
          and tuple(wp.data.shape) == (_ceil(o, N_ALIGN),
                                       kh * kw * _ceil(i, K_CHUNK))
          and h + py0 + py1 >= kh and w + px0 + px1 >= kw
          and _scales_ok(s_x, wp.s_w, b, o, out_dtype, dev))
    if not ok:
        raise ValueError(
            "int8_conv_quantizing: x must be contiguous f32 or bf16 [B, H, "
            "W, I], wp a PackedWeight of [O, I, kh, kw] on its device with "
            "the padded image at least kh x kw, s_x f32 [B] or [1] and "
            f"out_dtype f32 or bf16; got x {x.dtype} {tuple(x.shape)} on "
            f"{x.device}, wp {wp.data.dtype} {tuple(wp.data.shape)} of "
            f"{wp.shape} on {wp.data.device}, padding {padding}, s_x "
            f"{(s_x.dtype, tuple(s_x.shape), s_x.device)}, out_dtype "
            f"{out_dtype}")
    out = _launch(x, wp.data, o, kh, kw, (py0, py1, px0, px1), s_x, wp.s_w,
                  out_dtype)
    int8_conv.quantizing_shapes.add(
        (b, h, w, i, o, kh, kw, ((py0, py1), (px0, px1)), str(x.dtype),
         s_x.shape[0] != 1, str(out_dtype)))
    return out


int8_conv.launches = 0
int8_conv.shapes = set()
int8_conv.quantizing_shapes = set()
