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

On a CUDA tensor the conv is the hand-written kernel
(``ops/int8_conv.py`` -> ``csrc/int8_conv.cu``), always; on a CPU tensor
its plain version.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import List, Optional

import torch
import torch.nn.functional as F

from brushstroke_engine_torch.ops.int8_conv import int8_conv


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


def quantized_conv(x, w, padding):
    """int8 x int8 -> int32 conv with symmetric scales.

    x: ``[B, H, W, I]`` f32 or bf16 (NHWC); w: ``[O, I, kh, kw]`` (OIHW),
    already in x's dtype; padding: ``((py0, py1), (px0, px1))`` (negative
    crops).  Returns ``[B, H', W', O]`` in x's dtype.  The activation scale
    is amax / 127 over each sample, or this site's static scale under
    :func:`static_scales`; under :func:`calibration` the site first records
    its amax.  The weight scale is amax / 127 over (I, kh, kw) per output
    channel.  Both are quantized before padding, as the JAX function sees
    its operands.
    """
    xf = x.float()
    wf = w.float()
    if _st.calibrating:
        _st.amax.append(float(xf.abs().max()))
    if _st.static is not None and not _st.calibrating:
        i = _st.index
        if i >= len(_st.static):
            raise RuntimeError(
                f"static int8 scales exhausted at call site {i}; re-run "
                "calibration() on this program shape")
        s_x = _scales_on(_st.static, x.device)[i:i + 1]          # [1]
        _st.index = i + 1
    else:
        s_x = torch.clamp_min(xf.abs().amax(dim=(1, 2, 3)) / 127.0, 1e-12)
    s_w = torch.clamp_min(wf.abs().amax(dim=(1, 2, 3)) / 127.0, 1e-12)
    xq = torch.clamp(torch.round(xf / s_x[:, None, None, None]), -127, 127)
    wq = torch.clamp(torch.round(wf / s_w[:, None, None, None]), -127, 127)
    (py0, py1), (px0, px1) = padding
    xq = F.pad(xq.to(torch.int8), [0, 0, px0, px1, py0, py1])
    return int8_conv(xq.contiguous(), wq.to(torch.int8), s_x, s_w, x.dtype)
