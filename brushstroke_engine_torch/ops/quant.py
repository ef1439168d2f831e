"""Opt-in int8 quantized inference for the serving path.

Counterpart of ``brushstroke_engine_tpu/ops/quant.py``, with its names and
meaning.  Every stride-1, undilated, ungrouped dense conv of a render
(``ops/conv.py:conv2d_resample``'s plain branch; :func:`quantizable`) runs
as an int8 x int8 -> int32 conv (:func:`quantized_conv`): symmetric
quantization of the activation (per sample, or one calibrated scale per
call site) and of the weight (per output channel), the int32 accumulator
rescaled by the product of the two scales.  Up-sampling, strided and
grouped convs stay in float, as do the geometry encoder's and the
background-clarity pass (:func:`suspended`, entered by
``engine/render.py:sfactor_core``).  Inference only: nothing here has a
gradient.

Static calibration (what ``--int8 static`` serves): run the engine on
calibration inputs under :func:`calibration` (each quantizable call site
records its activation amax, in call order), then render under
:func:`static_scales`, which hands call site ``i`` the ``i``-th scale.
The JAX package bakes the scales into a trace; here every call consumes
them, so every render entry opens :func:`static_ctx` (which starts at site
0 again) around the convs it runs.

The state (the flags, the recorded amax, the scales and the site index) is
per thread: the server renders on worker threads, and a render in float on
one thread must not consume or see another thread's scales.

On a CUDA tensor a site is the hand-written kernel (``ops/int8_conv.py``
-> ``csrc/int8_conv.cu``), always: it quantizes the activation on its way
in.  On a CPU tensor it is the kernel's plain version.  A site's weight is
quantized and packed once (:func:`site_weight`, keyed on the parameter it
comes from) and served again until the parameter changes.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import weakref
from typing import Dict, List, Optional

import torch

from brushstroke_engine_torch.ops.int8_conv import (
    PackedWeight, int8_conv_quantizing, quantize_weight,
)


class _State(threading.local):
    def __init__(self):
        self.enabled = False
        self.calibrating = False
        self.amax: List[float] = []
        self.static: Optional[tuple] = None
        self.index = 0


_st = _State()


def set_int8_inference(on: bool):
    """Dynamic int8 (per-sample activation scales) for this thread."""
    _st.enabled = bool(on)


def int8_inference_enabled() -> bool:
    return _st.enabled


@contextlib.contextmanager
def int8_inference(on: bool = True):
    old = _st.enabled
    _st.enabled = bool(on)
    try:
        yield
    finally:
        _st.enabled = old


def quantizable(x, strides, lhs_dilation, groups) -> bool:
    """True when this conv takes the int8 path: int8 is on in this thread
    (dynamic, calibrating or static scales), and the conv is a stride-1,
    undilated, ungrouped conv of a 4-D f32 or bf16 activation."""
    return ((_st.enabled or _st.calibrating or _st.static is not None)
            and groups == 1
            and tuple(strides) == (1, 1)
            and tuple(lhs_dilation) == (1, 1)
            and x.dtype in (torch.float32, torch.bfloat16)
            and x.dim() == 4)


@contextlib.contextmanager
def calibration():
    """Calibration pass: each quantizable call site records the amax of its
    activation (the list is yielded), then quantizes dynamically."""
    old = _st.calibrating
    _st.calibrating = True
    _st.amax = []
    try:
        yield _st.amax
    finally:
        _st.calibrating = old


def calibrated_scales():
    """The amax list of this thread's last :func:`calibration` pass as
    per-site scales."""
    return [max(a / 127.0, 1e-12) for a in _st.amax]


@contextlib.contextmanager
def static_scales(scales):
    """Run with one constant activation scale per call site, handed out in
    call order from site 0."""
    old = _st.static
    _st.static = tuple(float(s) for s in scales)
    _st.index = 0
    try:
        yield
    finally:
        _st.static = old


def sites_consumed():
    """How many call sites this thread's last :func:`static_scales` run
    consumed (0: the int8 gate never engaged)."""
    return _st.index


@contextlib.contextmanager
def suspended():
    """Float convs for the enclosed code, whatever this thread's int8 state:
    no site is quantized, recorded or consumed."""
    old = (_st.enabled, _st.calibrating, _st.static)
    _st.enabled, _st.calibrating, _st.static = False, False, None
    try:
        yield
    finally:
        _st.enabled, _st.calibrating, _st.static = old


def eager_calibrate(fn, *args, **kwargs):
    """Run ``fn`` once under :func:`calibration` without autograd and return
    the per-site scales its quantizable convs recorded."""
    with torch.no_grad(), calibration():
        fn(*args, **kwargs)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    return calibrated_scales()


def static_ctx(scales):
    """``static_scales(scales)`` when scales are given, else a no-op: what a
    render entry opens around its convs."""
    if scales:
        return static_scales(scales)
    return contextlib.nullcontext()


@functools.lru_cache(maxsize=32)
def _scales_on(scales: tuple, device: torch.device) -> torch.Tensor:
    """The static scales as one f32 tensor on ``device`` (one copy per
    scales and device, not one per site)."""
    return torch.tensor(scales, dtype=torch.float32, device=device)


# Each site's quantized, packed weight, made once: (id of the source
# parameter, what else it was derived with, x's dtype, device) -> (a weak
# reference to the parameter, its (_version, data_ptr) when quantized, the
# PackedWeight).  An in-place change bumps _version, a new storage moves
# data_ptr: either quantizes again.
_WCACHE_MAX = 512
_wcache: Dict[tuple, tuple] = {}
_wlock = threading.Lock()


def site_weight(w, dtype, source=None) -> PackedWeight:
    """The quantized weight of a site whose conv weight is ``w`` (``[O, I,
    kh, kw]`` in ``dtype``, or a zero-argument callable returning it).

    ``source`` names what ``w`` is derived from: a tuple whose first entry
    is the parameter tensor and whose other entries are hashable (how it
    was derived: the low-precision guard, the flip).  With a source the
    packed weight is kept and served again while the parameter is the same
    object with the same ``_version`` and storage, for the same ``dtype``
    and device; without one it is quantized on every call.  A write through
    ``param.data`` would move neither ``_version`` nor the storage and so
    serve a stale weight: ``tests/test_torch_api.py`` keeps the port free of
    such writes.  Safe across threads: a CUDA weight is complete on its
    stream before another thread can see it."""
    if source is None:
        return quantize_weight(w() if callable(w) else w)
    param = source[0]
    key = (id(param), tuple(source[1:]), dtype, param.device)
    stamp = (param._version, param.data_ptr())
    with _wlock:
        hit = _wcache.get(key)
        if hit is not None and hit[0]() is param and hit[1] == stamp:
            return hit[2]
        packed = quantize_weight(w() if callable(w) else w)
        if packed.data.device.type == "cuda":
            torch.cuda.current_stream(packed.data.device).synchronize()
        if len(_wcache) >= _WCACHE_MAX:
            for k in [k for k, v in _wcache.items() if v[0]() is None]:
                del _wcache[k]
            if len(_wcache) >= _WCACHE_MAX:
                _wcache.clear()
        _wcache[key] = (weakref.ref(param), stamp, packed)
        return packed


def quantized_conv(x, w, padding, source=None):
    """int8 x int8 -> int32 conv with symmetric scales.

    x: ``[B, H, W, I]`` f32 or bf16 (NHWC); w: ``[O, I, kh, kw]`` (OIHW),
    already in x's dtype, or a zero-argument callable returning it (called
    only when the site's weight is quantized); padding: ``((py0, py1),
    (px0, px1))`` (negative crops); source: see :func:`site_weight`.
    Returns ``[B, H', W', O]`` in x's dtype.  The activation scale is amax
    / 127 over each sample, or this site's static scale under
    :func:`static_scales`; under :func:`calibration` the site first records
    its amax.  The weight scale is amax / 127 over (I, kh, kw) per output
    channel.  Both are quantized before padding, as the JAX function sees
    its operands.  On the card the quantization of x, the padding, the conv
    and the epilogue are one kernel launch
    (:func:`~brushstroke_engine_torch.ops.int8_conv.int8_conv_quantizing`).
    """
    if _st.calibrating:
        _st.amax.append(float(x.abs().max()))
    if _st.static is not None and not _st.calibrating:
        i = _st.index
        if i >= len(_st.static):
            raise RuntimeError(
                f"static int8 scales exhausted at call site {i}; re-run "
                "calibration() on this program shape")
        s_x = _scales_on(_st.static, x.device)[i:i + 1]          # [1]
        _st.index = i + 1
    else:
        s_x = torch.clamp_min(x.abs().amax(dim=(1, 2, 3)).float() / 127.0,
                              1e-12)
    wp = site_weight(w, x.dtype, source)
    return int8_conv_quantizing(x.contiguous(), s_x, wp, padding, x.dtype)
