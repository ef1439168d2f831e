"""Runtime helpers shared by the port's entry points.

The device and tree helpers (:func:`resolve_device`, :func:`tree_to`, ...)
are the port's own.  The rest is the port's copy of
``brushstroke_engine_tpu/utils/util.py`` (reference dnnlib/util, forger's
logging and timer helpers) in PyTorch's idiom: EasyDict, class construction
from config strings, tee'd logging, wall-clock timing, parameter summaries,
shape assertions, profiler scopes, local URL opening and tensor stat logging.
"""

from __future__ import annotations

import functools
import hashlib
import importlib
import logging
import os
import sys
import time
from typing import Any, Optional

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point.  Raises when CUDA is asked for
    and absent: only an explicit ``device="cpu"`` runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def tree_to(tree, device):
    """Move every tensor leaf of a nested dict (or list) to ``device``;
    leaves that are not tensors, such as an optimizer's step count, stay as
    they are."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def tree_leaves(tree):
    """Tensor leaves of a nested dict, in key insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """Nested dict shaped like ``like`` from ``leaves`` (an iterable in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


class EasyDict(dict):
    """Attribute-access dict (reference dnnlib.util.EasyDict)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        del self[name]


def get_obj_by_name(name: str) -> Any:
    """'pkg.module.attr' -> object (reference construct_class_by_name infra)."""
    module_name, _, attr = name.rpartition(".")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def construct_class_by_name(*args, class_name: str, **kwargs) -> Any:
    """String-based dependency injection (reference dnnlib util)."""
    return get_obj_by_name(class_name)(*args, **kwargs)


def format_time(seconds: float) -> str:
    s = int(round(seconds))
    if s < 60:
        return f"{s}s"
    if s < 3600:
        return f"{s // 60}m {s % 60:02d}s"
    if s < 86400:
        return f"{s // 3600}h {(s % 3600) // 60:02d}m"
    return f"{s // 86400}d {(s % 86400) // 3600:02d}h"


class Timer:
    """Simple wall-clock timer (reference forger/util/timer.py)."""

    def __init__(self):
        self.start_time = time.time()

    def tick(self) -> float:
        now = time.time()
        elapsed = now - self.start_time
        self.start_time = now
        return elapsed

    def peek(self) -> float:
        return time.time() - self.start_time


class Logger:
    """Tee stdout to a file (reference dnnlib.util.Logger); :meth:`close`
    puts back the ``sys.stdout`` it replaced."""

    def __init__(self, file_name: Optional[str] = None, mode: str = "w"):
        self.file = open(file_name, mode) if file_name else None
        self.stdout = sys.stdout
        sys.stdout = self

    def write(self, text):
        self.stdout.write(text)
        if self.file:
            self.file.write(text)

    def flush(self):
        self.stdout.flush()
        if self.file:
            self.file.flush()

    def close(self):
        sys.stdout = self.stdout
        if self.file:
            self.file.close()


def default_log_setup(level=logging.INFO):
    """Logging setup (reference forger/util/logging.py:19)."""
    logging.basicConfig(
        level=level,
        format="%(asctime)s|%(levelname)8s| %(message)s",
        handlers=[logging.StreamHandler(sys.stdout)])


def add_log_level_flag(parser):
    parser.add_argument("--log_level", type=int, default=logging.INFO,
                        help="Logging level (10 debug, 20 info, ...)")


def _named_leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict / list / tuple, dict keys sorted
    and list positions written ``[i]``, as JAX flattens a pytree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, path + (f"[{i}]",))
    elif tree is not None:
        yield "/".join(path), tree


def print_param_summary(params, name: str = "model", max_rows: int = 40):
    """Parameter-count summary table (reference misc.print_module_summary
    dry-forward analog) of a nested dict or list of tensors (or arrays), or
    of an ``nn.Module``'s ``named_parameters``.  Returns the total."""
    if isinstance(params, torch.nn.Module):
        named = list(params.named_parameters())
    else:
        named = list(_named_leaves(params))
    rows = []
    total = 0
    for path, leaf in named:
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") \
            else np.shape(leaf)
        n = int(np.prod(shape)) if shape else 1
        total += n
        rows.append((path, shape, n))
    print(f"{name} parameters: {total:,}")
    for r in rows[:max_rows]:
        print(f"  {r[0]:<60s} {str(r[1]):<20s} {r[2]:,}")
    if len(rows) > max_rows:
        print(f"  ... ({len(rows) - max_rows} more tensors)")
    return total


def assert_shape(tensor, ref_shape):
    """Shape assertion with None wildcards (reference torch_utils/misc.py:80).

    ``ref_shape`` entries of None match any extent.  Works on tensors and
    numpy arrays.
    """
    shape = tuple(tensor.shape)
    if len(shape) != len(ref_shape):
        raise AssertionError(
            f"Wrong number of dimensions: got {len(shape)}, "
            f"expected {len(ref_shape)}")
    for i, (size, ref) in enumerate(zip(shape, ref_shape)):
        if ref is not None and size != ref:
            raise AssertionError(
                f"Wrong size for dimension {i}: got {size}, expected {ref}")


def profiled_function(fn):
    """Annotate a function so profiles group its ops under its name
    (reference torch_utils/misc.py:98): a ``torch.profiler.record_function``
    scope around each call."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(fn.__name__):
            return fn(*args, **kwargs)
    return wrapper


def open_url(url: str, cache_dir: Optional[str] = None, mode: str = "rb"):
    """Open a local path or a ``file://`` URL (reference
    dnnlib.util.open_url).  Nothing is fetched: an http(s) URL resolves
    to ``<cache_dir>/<sha256(url)[:16]>-<basename>`` (the cache filled by
    hand; ``cache_dir`` defaults to ``$BSE_CACHE_DIR`` or
    ``~/.cache/brushstroke_engine``) and raises when that file is absent.
    """
    if url.startswith("file://"):
        return open(url[len("file://"):], mode)
    if not (url.startswith("http://") or url.startswith("https://")):
        return open(url, mode)
    cache_dir = cache_dir or os.environ.get(
        "BSE_CACHE_DIR", os.path.expanduser("~/.cache/brushstroke_engine"))
    digest = hashlib.sha256(url.encode()).hexdigest()[:16]
    base = os.path.basename(url.split("?")[0]) or "download"
    path = os.path.join(cache_dir, f"{digest}-{base}")
    if os.path.isfile(path):
        return open(path, mode)
    raise FileNotFoundError(
        f"No network egress: place the artifact for {url!r} at {path!r}")


def log_tensor(t, name: str, logger, level=logging.DEBUG,
               print_stats: bool = False):
    """Shape/stat logging (reference forger/util/logging.py:66); a tensor on
    any device is read through ``.detach().cpu()``."""
    if not logger.isEnabledFor(level):
        return
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        dtype = str(t.dtype).replace("torch.", "")
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    else:
        arr = np.asarray(t)
        dtype = arr.dtype
    msg = f"{name}: shape {arr.shape} dtype {dtype}"
    if print_stats and arr.size:
        msg += (f" min {arr.min():.4f} max {arr.max():.4f} "
                f"mean {arr.mean():.4f}")
    logger.log(level, msg)
