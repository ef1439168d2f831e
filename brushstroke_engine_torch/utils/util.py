"""Device and tree helpers shared by the port's entry points."""

from __future__ import annotations

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
