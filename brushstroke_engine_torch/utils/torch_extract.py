"""Reading reference PyTorch checkpoints without running their code.

The port's copy of ``brushstroke_engine_tpu/utils/torch_extract.py``.  The
reference persists networks with ``@persistent_class`` pickles that embed
their own source and re-execute it at load time
(reference: thirdparty/.../torch_utils/persistence.py:35-251).  Only the
tensors and the constructor kwargs are needed, so:

  * :func:`load_reference_pickle` reads such a pickle with an unpickler that
    resolves an allowlist of globals (tensor and array reconstructors, dtypes,
    plain containers, ``argparse.Namespace``) and turns every other global,
    ``_reconstruct_persistent_obj`` included, into a passive
    :class:`PersistentStub`; tensor storages inside it are read with
    ``torch.load(weights_only=True)``;
  * :func:`load_torch_file` reads a ``torch.save`` file (an encoder
    checkpoint) with ``weights_only=True``, allowlisting
    ``argparse.Namespace`` and reading ``dnnlib``'s ``EasyDict`` as a dict;
    a file that names any other callable is refused.

:func:`flatten_module_state` then walks the stubbed torch Module state
(``_parameters`` / ``_buffers`` / ``_modules``) into a flat
``name -> numpy array`` map.  No reference code is imported or executed.
"""

from __future__ import annotations

import argparse
import builtins
import collections
import io
import pickle
from typing import Any, Dict

import numpy as np
import torch


class EasyDict(dict):
    """Attribute-access dict standing in for dnnlib.EasyDict during unpickling."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value


class PersistentStub:
    """Inert stand-in for a persistence-pickled torch module (and for any
    other global the unpickler does not allow)."""

    def __init__(self, meta=None):
        self.meta = meta

    def __setstate__(self, state):
        self.meta = state

    @property
    def state(self):
        if isinstance(self.meta, dict) and "state" in self.meta:
            return self.meta["state"]
        return self.meta


def _storage_from_bytes(b: bytes):
    """``torch.storage._load_from_bytes`` without running a pickle's code:
    the nested ``torch.save`` stream holds one storage."""
    return torch.load(io.BytesIO(b), map_location="cpu", weights_only=True)


_BUILTINS = {"set", "frozenset", "slice", "complex", "bytearray", "range",
             "tuple", "list", "dict", "int", "float", "str", "bool"}
_ALLOWED = {
    ("torch._utils", "_rebuild_tensor"), ("torch._utils", "_rebuild_tensor_v2"),
    ("torch._utils", "_rebuild_parameter"),
    ("torch._utils", "_rebuild_parameter_with_state"),
    ("torch._tensor", "_rebuild_from_type_v2"), ("torch", "Size"),
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("collections", "OrderedDict"), ("argparse", "Namespace"),
}


class _ReferenceUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "EasyDict":
            return EasyDict
        if module == "torch.storage" and name == "_load_from_bytes":
            return _storage_from_bytes
        if module == "builtins" and name in _BUILTINS:
            return getattr(builtins, name)
        if module == "torch":
            obj = getattr(torch, name, None)
            if isinstance(obj, torch.dtype) or (
                    name.endswith("Storage") and isinstance(obj, type)):
                return obj
        if (module, name) in _ALLOWED:
            import importlib
            return getattr(importlib.import_module(module), name)
        # _reconstruct_persistent_obj and every other global -> inert stub.
        return PersistentStub


def load_reference_pickle(path: str) -> Any:
    """A reference training snapshot (or TF-legacy pickle), with every
    module a :class:`PersistentStub` and its tensors on the CPU."""
    with open(path, "rb") as f:
        return _ReferenceUnpickler(f).load()


def load_torch_file(path: str) -> Any:
    """``torch.load`` of a plain ``.pt`` checkpoint (an encoder checkpoint:
    ``{"model_state": state_dict, "args": Namespace or EasyDict}``) with
    ``weights_only=True``; raises ``pickle.UnpicklingError`` for a file that
    names any other callable."""
    safe = [argparse.Namespace, collections.OrderedDict,
            (dict, "dnnlib.util.EasyDict"), (dict, "dnnlib.EasyDict")]
    with torch.serialization.safe_globals(safe):
        return torch.load(path, map_location="cpu", weights_only=True)


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _is_tensorlike(t) -> bool:
    return isinstance(t, (np.ndarray, torch.Tensor))


def flatten_module_state(obj, prefix: str = "") -> Dict[str, np.ndarray]:
    """Walk a (stubbed) torch Module state into flat name -> numpy arrays.

    Handles the nn.Module ``__dict__`` layout: ``_parameters``,
    ``_buffers``, ``_modules`` (recursive), live ``nn.Module``s, plain state
    dicts and :class:`PersistentStub` wrappers.
    """
    out: Dict[str, np.ndarray] = {}
    if isinstance(obj, PersistentStub):
        state = obj.state
        return flatten_module_state(state, prefix) \
            if isinstance(state, dict) else out
    if isinstance(obj, torch.nn.Module):
        return {prefix + name: to_numpy(t)
                for name, t in obj.state_dict().items()}
    if isinstance(obj, dict):
        for key in ("_parameters", "_buffers"):
            for name, t in (obj.get(key) or {}).items():
                if t is not None:
                    out[prefix + name] = to_numpy(t)
        for name, sub in (obj.get("_modules") or {}).items():
            if sub is not None:
                out.update(flatten_module_state(sub, prefix + name + "."))
        # Plain state dicts (name -> tensor).
        if "_modules" not in obj and "_parameters" not in obj:
            for name, t in obj.items():
                if _is_tensorlike(t):
                    out[prefix + name] = to_numpy(t)
                elif isinstance(t, (dict, PersistentStub)):
                    out.update(flatten_module_state(t, prefix + name + "."))
    return out


def module_attrs(obj) -> Dict[str, Any]:
    """Non-tensor attributes of a stubbed module (init args like z_dim)."""
    if isinstance(obj, PersistentStub):
        state = obj.state
        return state if isinstance(state, dict) else {}
    return obj if isinstance(obj, dict) else {}
