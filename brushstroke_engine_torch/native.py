"""ctypes bindings of the host-side stroke rasterizer.

The port's counterpart of ``brushstroke_engine_tpu/native.py``: the same
three entry points over the port's own copy of the C++ source
(``csrc/stroke_raster.cpp``), compiled by ``g++`` with the JAX build's flags
(no fast-math, no ``-march``), so both packages draw bit-identical strokes.
The library goes to ``build/libbse_stroke_raster.so`` at the root of the
checkout, is built on first use and rebuilt when the source is newer.

This is host code: it feeds the card, it does not run on it.  Where the
library cannot be built or loaded (no ``g++``), every entry point returns
``None``, the reason is logged once, :func:`available` is false and the
callers in ``data/curves.py`` draw with numpy.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_PATH = os.path.join(_PKG_DIR, "csrc", "stroke_raster.cpp")
SO_PATH = os.path.join(os.path.dirname(_PKG_DIR), "build",
                       "libbse_stroke_raster.so")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None

_F32P = ctypes.POINTER(ctypes.c_float)


def _stale() -> bool:
    return not os.path.isfile(SO_PATH) or \
        os.path.getmtime(SRC_PATH) > os.path.getmtime(SO_PATH)


def build() -> None:
    """Compile the library.  Each process writes its own temporary file and
    moves it into place with ``os.replace``, so processes that build at the
    same moment leave one whole library.  Raises on failure."""
    os.makedirs(os.path.dirname(SO_PATH), exist_ok=True)
    tmp = f"{SO_PATH}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, SRC_PATH, "-o", tmp],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, SO_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built first if stale), or None where it cannot
    be built or loaded; the first failure is logged and kept."""
    global _lib, _load_error
    with _lock:
        if _lib is None and _load_error is None:
            try:
                if _stale():
                    build()
                lib = ctypes.CDLL(SO_PATH)
            except subprocess.CalledProcessError as e:
                _load_error = f"g++ failed: {e.stderr.strip()}"
            except (OSError, subprocess.SubprocessError) as e:
                _load_error = f"{type(e).__name__}: {e}"
            else:
                lib.bse_draw_stroke.argtypes = [
                    _F32P, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                    ctypes.c_int, _F32P]
                lib.bse_gaussian_blur.argtypes = [
                    _F32P, ctypes.c_int, ctypes.c_int, ctypes.c_float, _F32P]
                lib.bse_triband.argtypes = [
                    _F32P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_float, ctypes.POINTER(ctypes.c_uint8)]
                for fn in (lib.bse_draw_stroke, lib.bse_gaussian_blur,
                           lib.bse_triband):
                    fn.restype = None
                _lib = lib
            if _load_error is not None:
                logger.warning("native stroke rasterizer unavailable (%s); "
                               "drawing with numpy", _load_error)
        return _lib


def available() -> bool:
    """Whether the library is loaded (else the numpy fallback draws)."""
    return get_lib() is not None


def load_error() -> Optional[str]:
    """Why the library is not loaded, or None."""
    get_lib()
    return _load_error


def _image_2d(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 2:
        raise ValueError(f"expected a [H, W] image, got {img.shape}")
    return img


def draw_stroke_native(width: int, pts: np.ndarray, radius: float,
                       soft_edge: float = 1.0) -> Optional[np.ndarray]:
    """``data/curves.py:draw_stroke`` in C++: ``[width, width]`` float32,
    1.0 = background; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"expected [N, 2] points, got {pts.shape}")
    out = np.empty((width, width), np.float32)
    lib.bse_draw_stroke(pts.ctypes.data_as(_F32P), pts.shape[0],
                        ctypes.c_float(radius), ctypes.c_float(soft_edge),
                        width, out.ctypes.data_as(_F32P))
    return out


def triband_native(gray: np.ndarray, blur_sigma: float = 2.0,
                   threshold: float = 0.5) -> Optional[np.ndarray]:
    """Triband uint8 ``[H, W, 3]`` of a ``[H, W]`` gray stroke (R = gray,
    G = binary, B = its blur); None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    gray = _image_2d(gray)
    h, w = gray.shape
    out = np.empty((h, w, 3), np.uint8)
    lib.bse_triband(gray.ctypes.data_as(_F32P), h, w,
                    ctypes.c_float(blur_sigma), ctypes.c_float(threshold),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def gaussian_blur_native(img: np.ndarray, sigma: float
                         ) -> Optional[np.ndarray]:
    """Separable edge-clamped gaussian blur of a ``[H, W]`` image; None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    img = _image_2d(img)
    h, w = img.shape
    out = np.empty((h, w), np.float32)
    lib.bse_gaussian_blur(img.ctypes.data_as(_F32P), h, w,
                          ctypes.c_float(sigma), out.ctypes.data_as(_F32P))
    return out
