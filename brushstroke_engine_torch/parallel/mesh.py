"""Device meshes: data-parallel training over ranks, and rows of a render
batch split over the cards of one process.

Counterpart of ``brushstroke_engine_tpu/parallel/mesh.py``, in PyTorch's
idiom.  A :class:`Mesh` is an ordered tuple of ``torch.device``, an axis name
and an optional process group; :func:`make_mesh` makes one of two kinds:

* a *group* mesh for training: the process group's world, one card per
  process (rank).  The batch is sliced over the ranks, the state is
  replicated by a broadcast from rank 0, and the step runs under
  ``parallel.distributed.rank_context``: global draws, global pooled
  reductions, and the gradients' mean over ranks in one flattened bucket
  per phase (the all-reduce XLA inserts into the JAX package's
  batch-sharded program);
* a *local* mesh for serving and stylizing: one process, N cards; a batch's
  rows are split over the cards, each card's chunk is issued before any is
  gathered, so the cards overlap.  A mesh of N entries of ``cpu`` is
  allowed, so that the split, pad and gather logic runs in tests as JAX's
  virtual CPU devices do.

Tensor, pipeline and expert parallelism are not needed at this model scale,
as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from brushstroke_engine_torch.parallel.distributed import (
    RankGroup, broadcast_, mean_over_ranks_, rank_context, rank_device,
)
from brushstroke_engine_torch.utils.util import (
    resolve_device, tree_leaves, tree_to,
)


@dataclass(frozen=True)
class Mesh:
    """``devices``: the cards this process drives, in order (one, the
    rank's, in a group mesh); ``axis``: the batch axis' name; ``group``: the
    process group of a training mesh, None for a local mesh."""
    devices: Tuple[torch.device, ...]
    axis: str = "data"
    group: Any = None

    @property
    def size(self) -> int:
        """Ranks of a group mesh, devices of a local one."""
        if self.group is not None:
            return dist.get_world_size(self.group)
        return len(self.devices)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self.group is not None else 0

    def ranks(self) -> Optional[RankGroup]:
        """The training step's :class:`RankGroup` (None for a local mesh:
        one process without a group)."""
        if self.group is None:
            return None
        return RankGroup(self.group, self.rank, self.size)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device="cuda", local: bool = False) -> Mesh:
    """A group mesh over the process group's world when one is formed
    (``n_devices`` None or the world size; the rank's device from
    ``device``, ``parallel.distributed.rank_device``), else -- or with
    ``local`` -- a local mesh: the first ``n_devices`` cards (all by
    default; raises when fewer exist), or ``n_devices`` entries of ``cpu``
    (one by default)."""
    if not local and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"a training mesh spans the group's {world} "
                             f"ranks, not {n_devices}")
        return Mesh((rank_device(device),), axis, dist.group.WORLD)
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if n > count:
            raise RuntimeError(f"a mesh of {n} cards needs {n}; this "
                               f"machine has {count}")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)
    return Mesh((dev,) * int(n_devices or 1), axis)


def same_device(a, b) -> bool:
    """Whether two devices are one (``cuda`` names the current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device() if torch.cuda.is_available() else 0
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


# ---------------------------------------------------------------------------
# Rows: pad, split, gather
# ---------------------------------------------------------------------------

def _rows(x, b):
    """Whether ``x`` is a per-row array of a batch of ``b`` rows."""
    return isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim > 0 and \
        x.shape[0] == b


def _map_rows(fn, tree, b):
    """``fn`` on every per-row array of ``tree`` (tuples, lists and dicts
    are walked; anything else is kept)."""
    if isinstance(tree, dict):
        return {k: _map_rows(fn, v, b) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_rows(fn, v, b) for v in tree)
    return fn(tree) if _rows(tree, b) else tree


def pad_rows(tree, b: int, multiple: int):
    """Pad every per-row array of ``tree`` from ``b`` rows to a multiple of
    ``multiple`` by repeating the last row; returns (tree, rows added)."""
    n_pad = (-b) % multiple
    if not n_pad:
        return tree, 0

    def pad(a):
        if isinstance(a, torch.Tensor):
            return torch.cat([a, a[-1:].expand(n_pad, *a.shape[1:])])
        return np.concatenate([a, np.repeat(a[-1:], n_pad, axis=0)])

    return _map_rows(pad, tree, b), n_pad


def split_rows(tree, b: int, n: int):
    """``n`` trees holding consecutive equal chunks of the ``b`` rows of
    every per-row array of ``tree`` (``b % n == 0``)."""
    if b % n:
        raise ValueError(f"{b} rows do not split over {n} devices")
    k = b // n
    return [_map_rows(lambda a, i=i: a[i * k:(i + 1) * k], tree, b)
            for i in range(n)]


def gather_rows(parts, device, keep: Optional[int] = None):
    """Concatenate the per-row tensors of the trees ``parts`` on ``device``
    (one copy per part), keeping the first ``keep`` rows; an entry that is
    not per-row is taken from the first part."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: gather_rows([p[k] for p in parts], device, keep)
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(gather_rows(list(z), device, keep)
                           for z in zip(*parts))
    if isinstance(first, torch.Tensor) and first.ndim > 0 and \
            all(isinstance(p, torch.Tensor) and p.ndim == first.ndim
                and p.shape[1:] == first.shape[1:] for p in parts):
        out = torch.cat([p.to(device) for p in parts])
        return out if keep is None else out[:keep]
    return first


def shard_batch(mesh: Mesh, tree, b: Optional[int] = None):
    """A global batch over the mesh: a group mesh gives this rank's rows on
    its device; a local mesh a list of per-device trees, consecutive equal
    chunks (``b``: the row count, by default the first leaf's)."""
    if b is None:
        b = _first_rows(tree)
    parts = split_rows(tree, b, mesh.size)
    if mesh.group is not None:
        return tree_to(_as_tensors(parts[mesh.rank]), mesh.devices[0])
    return [tree_to(_as_tensors(p), d) for p, d in zip(parts, mesh.devices)]


def _first_rows(tree):
    """The row count of the first array of ``tree``."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return next(n for n in map(_first_rows, tree) if n is not None)
    return tree.shape[0] if isinstance(tree, (np.ndarray, torch.Tensor)) \
        else None


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    return torch.as_tensor(tree) if isinstance(tree, np.ndarray) else tree


def replicate(mesh: Mesh, tree):
    """The tree on every device of the mesh: in a group mesh rank 0's
    values broadcast in place to every rank (one flattened broadcast per
    dtype; the tree is returned); in a local mesh a list with one copy per
    device."""
    if mesh.group is not None:
        tree = tree_to(tree, mesh.devices[0])
        broadcast_([t for t in tree_leaves(tree)
                    if isinstance(t, torch.Tensor)], group=mesh.group)
        return tree
    return [tree_to(tree, d) for d in mesh.devices]


def shard_tile_render(mesh: Mesh, render_fn, device=None):
    """Wrap ``render_fn(*tile_batches, device=d, **kw)`` so that a tile
    batch's rows split over the local mesh: the per-row arrays (those with
    the first argument's row count) are padded to a multiple of the mesh
    size by repeating the last row, every device's chunk is issued before
    any output is gathered, and the outputs' rows come back concatenated on
    ``device`` (the mesh's first by default) without the padding."""
    if mesh.group is not None:
        raise ValueError("tile rendering splits over a local mesh")
    out_dev = mesh.devices[0] if device is None else torch.device(device)

    def wrapped(*tile_batches, **kw):
        b = tile_batches[0].shape[0]
        args, n_pad = pad_rows(tuple(tile_batches), b, mesh.size)
        parts = split_rows(args, b + n_pad, mesh.size)
        outs = [render_fn(*p, device=d, **kw)
                for p, d in zip(parts, mesh.devices)]
        return gather_rows(outs, out_dev, keep=b)

    return wrapped


def make_dp_train_step(cfg, mesh: Mesh):
    """The data-parallel training step over a group mesh: Dmain, lazy Dr1,
    Gmain and lazy Gpl from one geometry encode, as the JAX
    ``make_dp_train_step`` runs them, each phase's gradients averaged over
    the ranks in one flattened all-reduce.

    Returns ``step(state, enc_params, enc_state, real_img, geom_input, z1,
    z2, rng, step_idx, ema_beta, draws=None) -> (state, stats)``:
    ``real_img``, ``geom_input`` (also the geometry truth, as in the JAX
    step), ``z1`` and ``z2`` are this rank's rows of the global batch
    (:func:`shard_batch`); ``rng`` the device ``torch.Generator``, seeded
    alike on every rank; ``step_idx`` a host int selecting the lazy
    regularizers; ``draws`` the phase functions' ``{"dmain", "dreg",
    "gmain", "greg"}`` dicts.  The stats are global means on every rank.  A
    local mesh of one device runs the same step without a group.
    """
    from brushstroke_engine_torch.train import steps as ts

    if mesh.group is None and mesh.size > 1:
        raise ValueError("training runs one card per process: make the "
                         "mesh over a process group (make_mesh after "
                         "maybe_initialize_distributed)")

    def step(state, enc_params, enc_state, real_img, geom_input, z1, z2,
             rng, step_idx, ema_beta, draws=None):
        d = draws or {}
        with rank_context(mesh.ranks()):
            feats = ts.encode_geometry(cfg, enc_params, enc_state,
                                       geom_input)
            state, d_stats = ts.d_main_step(cfg, state, real_img, feats, z1,
                                            rng, draws=d.get("dmain"))
            if cfg.d_reg_interval > 0 and step_idx % cfg.d_reg_interval == 0:
                state, _ = ts.d_reg_step(cfg, state, real_img, rng,
                                         draws=d.get("dreg"))
            state, g_stats = ts.g_main_step(cfg, state, feats, geom_input,
                                            z2, rng, ema_beta,
                                            draws=d.get("gmain"))
            if cfg.g_reg_interval > 0 and step_idx % cfg.g_reg_interval == 0:
                state, _ = ts.g_reg_step(cfg, state, feats, z2, rng,
                                         ema_beta, draws=d.get("greg"))
            stats = dict(d_stats)
            stats.update(g_stats)
            return state, mean_stats(stats)

    return step


def mean_stats(stats):
    """A step's stats as their mean over the active ranks, one flattened
    all-reduce (unchanged without a group)."""
    keys = [k for k, v in stats.items() if isinstance(v, torch.Tensor)]
    out = dict(stats)
    out.update(zip(keys, mean_over_ranks_([stats[k] for k in keys])))
    return out
