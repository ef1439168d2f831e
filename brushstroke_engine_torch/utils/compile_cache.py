"""Persistent cache of the port's built kernel libraries.

Counterpart of ``brushstroke_engine_tpu/utils/compile_cache.py``, with its
names and meaning: build once per machine, reuse in every later process.
What the JAX package caches is XLA executables; what the port builds is its
hand-written kernels (``ops/cuda_build.py``: one ``nvcc`` per
``csrc/*.cu``) and the host stroke rasterizer (``native.py``: ``g++``).
Both build into the directory :func:`build_dir` names, ``<cache
dir>/<host fingerprint>/``, and rebuild a library only when its source is
newer (each process writes its own temporary file and moves it into place).

The cache dir is ``build/`` at the root of the checkout (git ignores it),
unless ``BSE_XLA_CACHE_DIR`` names another; ``BSE_XLA_CACHE_DIR=""`` turns
persistence off: the process builds into a temporary directory of its own,
which it removes at exit.  The host fingerprint keeps libraries built on
one CPU type from being loaded on another (the rasterizer is host code).
"""

import atexit
import hashlib
import logging
import os
import shutil
import tempfile
import threading
from typing import Optional

logger = logging.getLogger(__name__)

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build")

_lock = threading.Lock()
_dir: Optional[str] = None
_temp: Optional[str] = None


def _host_fingerprint() -> str:
    """Short hash of this host's CPU feature flags.

    A library compiled for one host's CPU features may not load or run on
    another's, so the cache is salted per host-CPU identity.  Cost: one cold
    build on a new machine type.
    """
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    return hashlib.sha1(flags.encode()).hexdigest()[:10]
    except OSError:
        pass
    import platform
    return hashlib.sha1(platform.processor().encode()).hexdigest()[:10]


def _temporary_dir() -> str:
    d = tempfile.mkdtemp(prefix="bse_kernels_")
    atexit.register(shutil.rmtree, d, True)
    return d


def enable_persistent_cache(cache_dir=None):
    """Choose where this process builds its libraries (idempotent).

    ``cache_dir``, else ``BSE_XLA_CACHE_DIR``, else ``build/`` of the
    checkout, salted by the host fingerprint.  Returns the directory in
    use, or None when ``BSE_XLA_CACHE_DIR`` is empty (a temporary directory
    removed at exit)."""
    global _dir, _temp
    env = os.environ.get("BSE_XLA_CACHE_DIR")
    with _lock:
        if env is not None and env == "":
            if _temp is None:
                _temp = _temporary_dir()
            _dir = _temp
            return None
        d = os.path.join(cache_dir or env or _DEFAULT_DIR,
                         _host_fingerprint())
        os.makedirs(d, exist_ok=True)
        _dir = d
        return d


def build_dir() -> str:
    """The directory the kernel builds use: the one chosen by
    :func:`enable_persistent_cache`, which the first call makes if no entry
    point has."""
    if _dir is None:
        enable_persistent_cache()
    return _dir
