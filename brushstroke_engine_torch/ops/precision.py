"""Global conv/matmul precision policy.

Two modes, as in the JAX package:

  * 'strict' (default): float32 convs and matmuls run in true f32 -- TF32 is
    off for both cuDNN and cuBLAS.  Used by tests and parity checks.
  * 'fast': TF32 allowed, and the frozen geometry encoder runs in bf16.  Used
    by benchmarks and serving.

The mode is process-wide because the torch flags it sets are; importing this
module applies 'strict', so the flags and the reported mode always agree.
"""

from __future__ import annotations

import contextlib

import torch

_MODE = "strict"


def set_precision_mode(mode: str):
    global _MODE
    assert mode in ("strict", "fast")
    _MODE = mode
    allow = mode == "fast"
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


def get_precision_mode() -> str:
    return _MODE


@contextlib.contextmanager
def precision_mode(mode: str):
    old = _MODE
    set_precision_mode(mode)
    try:
        yield
    finally:
        set_precision_mode(old)


set_precision_mode(_MODE)
