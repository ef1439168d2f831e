"""ADA two-pass affine warp: the hand-written CUDA kernel pair and its plain
version.

Counterpart of ``brushstroke_engine_tpu/ops/pallas_warp.py``.  Each sample's
inverse affine is reduced by ``train.augment._twopass_prep`` to eight pass
scalars ``(A1, B1, c1, s1, D2, E2, c2, s2)``; the warp is then a horizontal
and a vertical 1-D resampling pass with normalised triangle weights and
reflect-101 centres (formulas in ``csrc/warp_twopass.cu``).

The warp ``W`` is linear in the image, so ``W`` and ``W^T`` are each other's
backward: :class:`WarpTwoPass` and :class:`WarpTwoPassT` are a mutually
recursive pair of ``autograd.Function``s, differentiable to any order (the
R1 phase differentiates through the backward pass).  The scalar pack gets no
gradient: ADA matrices are functions of the random draws only.

For a CUDA tensor both directions launch the kernels of
``csrc/warp_twopass.cu`` (``W`` in one fused launch, ``W^T`` in two through
a scratch tensor); for a CPU tensor they take the plain version
(:func:`warp_twopass_plain`, :func:`warp_twopass_t_plain`: dense weight
matrices and two einsums).  There is no flag and no fallback: a CUDA input
the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from brushstroke_engine_torch.ops import cuda_build


def warp_eligible(images) -> bool:
    """What the kernel takes: ``[B, N, N, C]`` contiguous f32, ``N >= 2``."""
    return (images.dim() == 4 and images.shape[1] == images.shape[2]
            and images.shape[1] >= 2 and images.dtype == torch.float32
            and images.is_contiguous())


def _reflect(v, n: int):
    """Reflect-101 into ``[0, n-1]`` (floor-mod, as ``jnp.mod``)."""
    period = 2.0 * (n - 1)
    v = torch.remainder(v, period)
    return torch.where(v > (n - 1), period - v, v)


def _pass_weights(taps, pos, scale):
    """``[..., n]`` rows of a 1-D resampling matrix: a triangle centred at
    ``pos`` with half-width ``scale``, normalised to unit mass."""
    w = torch.clamp_min(1.0 - (taps - pos[..., None]).abs() / scale, 0.0)
    return w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-8)


def dense_weights(scalars, n: int):
    """The two dense weight tensors of the plain version:
    ``w1[b, r, j, k]`` (pass 1) and ``w2[b, i, j, r]`` (pass 2), f32."""
    sc = scalars.float()
    a1, b1, c1, s1, d2, e2, c2, s2 = (sc[:, i] for i in range(8))
    grid = torch.arange(n, dtype=torch.float32, device=sc.device)
    rows, cols = grid[None, :, None], grid[None, None, :]

    def col3(t):
        return t[:, None, None]

    u = col3(b1) * rows + col3(a1) * cols + col3(c1)          # [B, R, J]
    w1 = _pass_weights(grid, _reflect(u, n), s1[:, None, None, None])
    v = col3(e2) * rows + col3(d2) * cols + col3(c2)          # [B, I, J]
    w2 = _pass_weights(grid, _reflect(v, n), s2[:, None, None, None])
    return w1, w2


def warp_twopass_plain(imgs, scalars):
    """Plain torch version of ``W`` (the kernel's spec), f32."""
    w1, w2 = dense_weights(scalars, imgs.shape[1])
    i1 = torch.einsum("brjk,brkc->brjc", w1, imgs.float())
    return torch.einsum("bijr,brjc->bijc", w2, i1)


def warp_twopass_t_plain(g, scalars):
    """Plain torch version of ``W^T``, f32."""
    w1, w2 = dense_weights(scalars, g.shape[1])
    i1b = torch.einsum("bijr,bijc->brjc", w2, g.float())
    return torch.einsum("brjk,brjc->brkc", w1, i1b)


def source_intervals(slope: float, coef: float, line: int, c: float,
                     s: float, tap: int, n: int):
    """The source indices a transposed pass visits for output tap ``tap`` of
    one line, as ascending, disjoint, inclusive ``(lo, hi)`` intervals: the
    same enumeration as ``LineWalk`` / ``SourceWalk`` in
    ``csrc/warp_twopass.cu``, in Python floats (the kernel does it in
    double), so the CPU tests can hold it against the dense weights.

    Along the line the unreflected centre of source ``m`` is
    ``lin(m) = slope * m + coef * line + c`` (vertical pass: ``slope = E2``,
    ``coef = D2``, ``line`` = column, ``c = c2``; horizontal: ``A1``, ``B1``,
    row, ``c1``).  Its reflection equals ``tap`` where ``lin = +-tap + k *
    period``; the sources within ``s`` (plus a rounding margin) of such a
    target can have a non-zero weight, no other can.  A slope too flat to
    divide by, or more targets than half of the sources, gives the whole
    line.
    """
    nm1 = float(n - 1)
    base = coef * float(line) + c
    period = 2.0 * nm1
    inv_period = 1.0 / period
    mag = abs(slope) * nm1 + abs(base) + abs(c) + period + s
    reach = s + 1e-6 * mag + 1e-6
    if not abs(slope) * nm1 >= 1.0:
        return [(0, n - 1)]
    inv_slope = 1.0 / slope
    end = base + slope * nm1
    lin_lo, lin_hi = min(base, end) - reach, max(base, end) + reach
    # Targets within reach of the line: +tap + k * period as q = 2k + 1,
    # -tap + k * period as q = 2k; ascending in q.
    kp = (math.ceil((lin_lo - tap) * inv_period),
          math.floor((lin_hi - tap) * inv_period))
    km = (math.ceil((lin_lo + tap) * inv_period),
          math.floor((lin_hi + tap) * inv_period))
    q_ends = ([2 * k + 1 for k in kp] if kp[0] <= kp[1] else []) \
        + ([2 * k for k in km] if km[0] <= km[1] else [])
    if not q_ends:
        return []
    q_lo, q_hi = min(q_ends), max(q_ends)
    if q_hi - q_lo > 0.5 * n or abs(q_lo) > 1e8 or abs(q_hi) > 1e8:
        return [(0, n - 1)]
    qs = range(q_lo, q_hi + 1)
    out, nxt = [], 0
    for q in (qs if slope > 0.0 else reversed(qs)):
        if nxt >= n:
            break
        target = (q >> 1) * period + (tap if q & 1 else -tap) - base
        m0 = (target - reach) * inv_slope
        m1 = (target + reach) * inv_slope
        first = max(math.floor(min(m0, m1)) - 1.0, float(nxt))
        last = min(math.ceil(max(m0, m1)) + 1.0, float(n - 1))
        if first <= last:
            out.append((int(first), int(last)))
            nxt = int(last) + 1
    return out


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """The kernels' C entry points, typed once (builds the library first if
    it is missing or stale)."""
    lib = cuda_build.load("warp_twopass")
    fwd, bwd, band = (lib.warp_twopass_launch, lib.warp_twopass_t_launch,
                      lib.warp_twopass_band)
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    band.argtypes = [ctypes.c_int] * 3
    for fn in (fwd, bwd, band):
        fn.restype = ctypes.c_int
    err_str = lib.warp_twopass_error_string
    err_str.restype = ctypes.c_char_p
    err_str.argtypes = [ctypes.c_int]
    return fwd, bwd, band, err_str


def warp_band(b: int, n: int, c: int) -> int:
    """The column band ``W``'s kernel picks at ``[b, n, n, c]`` (0: the shape
    does not fit its shared memory)."""
    return _kernel_fns()[2](b, n, c)


def _launch(imgs, scalars, transposed: bool, band: int = 0):
    """Validate, launch, count.  ``band`` > 0 overrides ``W``'s column band
    (0 = the kernel's choice); only the tuning tool and the checks pass
    it."""
    b, n, _, c = imgs.shape
    if not warp_eligible(imgs):
        raise ValueError(
            f"warp_twopass: images must be a contiguous square f32 "
            f"[B, N, N, C] tensor; got {imgs.dtype} {tuple(imgs.shape)} "
            f"(contiguous={imgs.is_contiguous()})")
    if scalars.device != imgs.device or scalars.dtype != torch.float32 \
            or tuple(scalars.shape) != (b, 8) or not scalars.is_contiguous():
        raise ValueError(
            f"warp_twopass: scalars must be a contiguous f32 [{b}, 8] tensor "
            f"on {imgs.device}; got {scalars.dtype} {tuple(scalars.shape)} "
            f"on {scalars.device}")
    fwd, bwd, _, err_str = _kernel_fns()
    out = torch.empty_like(imgs)
    stream = torch.cuda.current_stream(imgs.device).cuda_stream
    if transposed:
        scratch = torch.empty_like(imgs)
        rc = bwd(imgs.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                 scalars.data_ptr(), b, n, c, stream)
    else:
        rc = fwd(imgs.data_ptr(), out.data_ptr(), scalars.data_ptr(), b, n, c,
                 band, stream)
    if rc != 0:
        raise RuntimeError(f"warp_twopass kernel launch failed: "
                           f"{err_str(rc).decode()} ({rc})")
    cuda_build.count_launch(warp_twopass_t if transposed else warp_twopass)
    return out


def _apply(imgs, scalars, transposed: bool):
    if imgs.device.type == "cpu":
        plain = warp_twopass_t_plain if transposed else warp_twopass_plain
        return plain(imgs, scalars)
    if imgs.device.type != "cuda":
        raise ValueError(f"warp_twopass: unsupported device {imgs.device}")
    return _launch(imgs, scalars, transposed)


class WarpTwoPass(torch.autograd.Function):
    """``W``: images ``[B, N, N, C]`` f32 (already quarter-turn factored) and
    the ``[B, 8]`` scalar pack -> the warped batch."""

    @staticmethod
    def forward(ctx, imgs, scalars):
        ctx.save_for_backward(scalars)
        return _apply(imgs, scalars, transposed=False)

    @staticmethod
    def backward(ctx, g):
        (scalars,) = ctx.saved_tensors
        return WarpTwoPassT.apply(g.float().contiguous(), scalars), None


class WarpTwoPassT(torch.autograd.Function):
    """``W^T`` applied to a cotangent batch ``[B, N, N, C]``."""

    @staticmethod
    def forward(ctx, g, scalars):
        ctx.save_for_backward(scalars)
        return _apply(g, scalars, transposed=True)

    @staticmethod
    def backward(ctx, h):
        (scalars,) = ctx.saved_tensors
        return WarpTwoPass.apply(h.float().contiguous(), scalars), None


def warp_twopass(imgs, scalars):
    """``W`` with gradient; counts its kernel launches in ``.launches``."""
    return WarpTwoPass.apply(imgs, scalars)


def warp_twopass_t(g, scalars):
    """``W^T`` with gradient; counts its kernel launches in ``.launches``."""
    return WarpTwoPassT.apply(g, scalars)


warp_twopass.launches = 0
warp_twopass_t.launches = 0


def affine_warp_twopass(images, mat, antialias: bool = True):
    """The two-pass warp of square ``images [B, N, N, C]`` by the per-sample
    inverse affines ``mat [B, 3, 3]``: ``_twopass_prep``, then the kernel for
    a CUDA tensor and the plain version for a CPU tensor.  Always computes in
    f32 and returns the images' dtype."""
    from brushstroke_engine_torch.train.augment import _twopass_prep
    imgs, sc = _twopass_prep(images, mat, antialias)
    out = warp_twopass(imgs.float().contiguous(), sc.float().contiguous())
    return out.to(images.dtype)
