"""The int8 convolution of the static int8 serving path.

:func:`int8_conv` is a VALID, stride-1 conv of NHWC int8 activations
(already padded) by OIHW int8 weights with an int32 accumulator, and with
the scales given, the dequantizing epilogue ``acc * (s_x * s_w)`` in the
output dtype.  A CUDA tensor launches the hand-written kernel
(``csrc/int8_conv.cu``, built by ``ops/cuda_build.py``), always: there is
no fallback.  A CPU tensor takes the plain version (:func:`int8_conv_plain`
and :func:`int8_epilogue_plain`), which the tests and ``chip_smoke.py`` hold
the kernel to bit for bit: the accumulator is exact in both.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from brushstroke_engine_torch.ops import cuda_build

_OUT_BF16 = {torch.float32: 0, torch.bfloat16: 1}


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


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """The kernel's C entry points, typed once (builds the library first if
    it is missing or stale)."""
    lib = cuda_build.load("int8_conv")
    fn = lib.int8_conv_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    err_str = lib.int8_conv_error_string
    err_str.restype = ctypes.c_char_p
    err_str.argtypes = [ctypes.c_int]
    return fn, err_str


def _launch(xq, wq, s_x, s_w, out_dtype):
    dev = xq.device
    b, hp, wp, c = xq.shape
    o, i, kh, kw = wq.shape
    ok = (xq.dtype == torch.int8 and wq.dtype == torch.int8 and c == i
          and hp >= kh and wp >= kw and wq.device == dev)
    if ok and s_x is not None:
        ok = (out_dtype in _OUT_BF16 and s_x.dtype == torch.float32
              and s_w.dtype == torch.float32 and s_x.dim() == 1
              and s_x.shape[0] in (1, b) and tuple(s_w.shape) == (o,)
              and s_x.device == dev and s_w.device == dev)
    if not ok:
        raise ValueError(
            "int8_conv: xq must be int8 [B, Hp, Wp, I], wq int8 [O, I, kh, "
            "kw] with kh <= Hp, kw <= Wp on the same device, s_x f32 [B] or "
            "[1] and s_w f32 [O] there, out_dtype f32 or bf16; got xq "
            f"{xq.dtype} {tuple(xq.shape)} on {xq.device}, wq {wq.dtype} "
            f"{tuple(wq.shape)} on {wq.device}, s_x "
            f"{None if s_x is None else (s_x.dtype, tuple(s_x.shape))}, s_w "
            f"{None if s_w is None else (s_w.dtype, tuple(s_w.shape))}, "
            f"out_dtype {out_dtype}")
    # The kernel reads 4 channels per word: pad I to I4 with zeros (exact).
    i4 = -(-i // 4) * 4
    x4 = F.pad(xq, [0, i4 - i]) if i4 != i else xq
    w4 = F.pad(wq.permute(0, 2, 3, 1), [0, i4 - i])          # [O, kh, kw, I4]
    x4, w4 = x4.contiguous(), w4.contiguous()
    out_shape = (b, hp - kh + 1, wp - kw + 1, o)
    if s_x is None:
        out = torch.empty(out_shape, dtype=torch.int32, device=dev)
        acc_ptr, out_ptr = out.data_ptr(), None
    else:
        s_x, s_w = s_x.contiguous(), s_w.contiguous()
        out = torch.empty(out_shape, dtype=out_dtype, device=dev)
        acc_ptr, out_ptr = None, out.data_ptr()
    fn, err_str = _kernel_fns()
    with cuda_build.on_device(dev):
        rc = fn(x4.data_ptr(), w4.data_ptr(), b, hp, wp, i4, o, kh, kw,
                None if s_x is None else s_x.data_ptr(),
                0 if s_x is None or s_x.shape[0] == 1 else 1,
                None if s_w is None else s_w.data_ptr(), acc_ptr, out_ptr,
                _OUT_BF16.get(out_dtype, 0),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: "
                           f"{err_str(rc).decode()} ({rc})")
    cuda_build.count_launch(int8_conv)
    int8_conv.shapes.add((b, hp, wp, i, o, kh, kw,
                          "int32" if s_x is None else str(out_dtype)))
    return out


def int8_conv(xq, wq, s_x=None, s_w=None, out_dtype=torch.float32):
    """The int8 conv of ``xq`` ``[B, Hp, Wp, I]`` (NHWC, padded) by ``wq``
    ``[O, I, kh, kw]``: ``[B, Hp-kh+1, Wp-kw+1, O]`` int32 without scales,
    else ``acc * (s_x * s_w)`` in ``out_dtype`` (f32 or bf16) with ``s_x``
    f32 ``[B]`` or ``[1]`` and ``s_w`` f32 ``[O]``.

    A CUDA tensor launches the kernel (counted in ``int8_conv.launches``,
    its ``(B, Hp, Wp, I, O, kh, kw, out)`` in ``int8_conv.shapes``); a CPU
    tensor takes the plain version."""
    if xq.device.type == "cpu":
        acc = int8_conv_plain(xq, wq)
        return acc if s_x is None else \
            int8_epilogue_plain(acc, s_x, s_w, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {xq.device}")
    return _launch(xq, wq, s_x, s_w, out_dtype)


int8_conv.launches = 0
int8_conv.shapes = set()
