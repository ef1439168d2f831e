"""Build and load the port's hand-written CUDA kernels.

Each source under ``brushstroke_engine_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, which the
kernel's wrapper loads with ``ctypes``.  Libraries go to ``build/`` at the
root of the checkout and are rebuilt when their source is newer.  Nothing is
built at import: the first launch (or :func:`build_all`) builds.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")

# Kernel library name -> source file under csrc/.
SOURCES = {
    "fir4_epilogue": "fir4_epilogue.cu",
    "warp_twopass": "warp_twopass.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.isfile("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _paths(name: str):
    src = os.path.join(CSRC_DIR, SOURCES[name])
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    return src, so


def _stale(name: str) -> bool:
    src, so = _paths(name)
    return not os.path.isfile(so) or os.path.getmtime(src) > os.path.getmtime(so)


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Compile every stale kernel library, one ``nvcc`` per source, all
    started together.  Returns {name: ptxas report}; raises on a failed
    build with the compiler's output."""
    names = list(SOURCES) if names is None else names
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        src, so = _paths(name)
        procs[name] = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", so + ".tmp", src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    reports = {}
    failed = []
    for name, proc in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
        else:
            _, so = _paths(name)
            os.replace(so + ".tmp", so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
        return lib
