"""Process groups for data-parallel training, and the collectives the
training step runs under one.

Counterpart of ``brushstroke_engine_tpu/parallel/distributed.py``.  The JAX
package runs one process per host and lets XLA insert the collectives of a
batch-sharded program; the PyTorch idiom is one process per card (a *rank*)
in a ``torch.distributed`` process group -- NCCL on CUDA, gloo on the CPU --
with rank-sliced inputs and explicit collectives.  Here a "process" of
:func:`maybe_initialize_distributed` is one rank.

Meaning kept from the JAX package: an N-rank run computes what a 1-rank run
at the same global batch computes, up to reduction order.  While a
:func:`rank_context` is active (the training steps enter one under a mesh):

* every per-sample random draw is made at the global row count from the
  same seeded generator on every rank and sliced to the rank's rows
  (:func:`draw_rows`);
* a batch made of ``k`` equal parts, each the rank's rows of a global part
  (Gstitch's discriminator sees ``concat(fake1, fake2)``), is laid out
  part by part in the global batch under :func:`row_parts`, so that a draw
  or a gather sees the rows in the order one process sees them;
* reductions that pool over the batch see the global batch:
  :func:`all_reduce_sum` and :func:`all_gather_rows` are differentiable, so
  a rank's gradient is its share of the global one -- every rank's loss
  ``L_r`` satisfies ``sum_r L_r = world * L`` (rank-local means of equal row
  counts do by themselves; a pooled value is the global one on every rank,
  its backward summing the ranks' cotangents), and the mean of the ranks'
  gradients (:func:`mean_over_ranks_`, one flattened bucket) is the
  gradient of ``L``.

A world of one rank makes no collective but the gradient and stats means
(so that a group of one still runs its backend), and those are exact: the
single-process path computes bit for bit what it computes without a group.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
from dataclasses import dataclass
from typing import Any, List, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# torchrun's variables (the JAX version autodetects its coordinator's).
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def local_rank(default: int = 0) -> int:
    """This process's index among the ranks of its host (``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", default))


def rank_device(device="cuda", local: Optional[int] = None) -> torch.device:
    """The card of this rank: ``cuda`` names ``cuda:<LOCAL_RANK>``; an
    explicit index (``cuda:0``) or ``cpu`` stays as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank() if local is None else local)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank device {dev} does not exist: "
                               f"{torch.cuda.device_count()} card(s)")
    return dev


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 device="cuda", backend: Optional[str] = None,
                                 timeout_s: float = 600.0) -> bool:
    """Form the process group if the arguments or the environment ask for
    one; False for a plain single-process run.

    From the explicit arguments (``coordinator_address`` ``host:port`` or
    ``tcp://host:port``, the world size ``num_processes`` and this rank
    ``process_id``; all three or none) or else from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``).  The backend is NCCL when the rank's device
    (:func:`rank_device`) is CUDA and gloo on the CPU unless ``backend``
    names one.  Unlike the JAX version, which logs and carries on alone, a
    group that does not form raises: a run asked to train on N ranks never
    trains on one.
    """
    if dist.is_initialized():
        return True
    explicit = (coordinator_address, num_processes, process_id)
    if any(x is not None for x in explicit):
        if any(x is None for x in explicit):
            raise ValueError("coordinator_address, num_processes and "
                             "process_id are given together")
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    elif any(k in os.environ for k in _TORCHRUN_ENV):
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"incomplete torchrun environment: {missing} "
                               f"unset")
        init = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    try:
        dist.init_process_group(
            backend, init_method=init, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        raise RuntimeError(f"the {backend} process group of {world} ranks "
                           f"did not form at {init} (rank {rank}): "
                           f"{e}") from e
    logger.info("process group: rank %d / %d, %s on %s", rank, world,
                backend, dev)
    return True


def host_shard_info():
    """(rank, world size) for per-rank input sharding; (0, 1) without a
    group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# ---------------------------------------------------------------------------
# The active rank context of a training step
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RankGroup:
    """The ranks a training step runs over: ``group`` (None = the default
    group), this ``rank`` and the ``world`` size."""
    group: Any
    rank: int
    world: int


_ACTIVE: Optional[RankGroup] = None
_PARTS = 1


@contextlib.contextmanager
def rank_context(ranks: Optional[RankGroup]):
    """Run the enclosed training step over ``ranks`` (None: one process, no
    group).  One process is one rank, so the context is process-wide; the
    collectives' backward keeps the group it was made with."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, ranks
    try:
        yield
    finally:
        _ACTIVE = prev


def _multi() -> Optional[RankGroup]:
    """The active group when it has more than one rank."""
    return _ACTIVE if _ACTIVE is not None and _ACTIVE.world > 1 else None


def num_ranks() -> int:
    """The active group's world size (1 without one)."""
    r = _multi()
    return 1 if r is None else r.world


def rows_of(n: int) -> slice:
    """This rank's rows of a global batch of ``n * world`` rows."""
    r = _multi()
    return slice(None) if r is None else slice(r.rank * n, (r.rank + 1) * n)


@contextlib.contextmanager
def row_parts(k: int):
    """Within the context a local batch of ``k * p`` rows is ``k`` parts of
    ``p`` rows, part ``i`` this rank's rows of global part ``i``; the global
    batch is the ``k`` global parts one after the other, as one process
    concatenates them.  :func:`draw_rows`, :func:`all_gather_rows` and
    :func:`local_rows` follow that layout."""
    global _PARTS
    prev, _PARTS = _PARTS, int(k)
    try:
        yield
    finally:
        _PARTS = prev


def local_rows(n: int, device=None):
    """This rank's rows (a slice, or an index tensor on ``device``) of the
    global batch of a local batch of ``n`` rows, in the layout of
    :func:`row_parts`."""
    r = _multi()
    if r is None or _PARTS == 1:
        return rows_of(n)
    p = n // _PARTS
    return torch.cat([torch.arange(i * p * r.world + r.rank * p,
                                   i * p * r.world + (r.rank + 1) * p,
                                   device=device)
                      for i in range(_PARTS)])


def draw_rows(fn, shape, **kwargs):
    """A per-sample draw ``fn(shape, **kwargs)`` (``torch.randn``,
    ``torch.rand``, ``torch.randint``'s size) made at the global row count
    ``shape[0] * world`` and sliced to this rank's rows (:func:`local_rows`),
    so that every rank consumes the generator as a 1-rank run does."""
    r = _multi()
    if r is None:
        return fn(tuple(shape), **kwargs)
    n = shape[0]
    full = fn((n * r.world,) + tuple(shape[1:]), **kwargs)
    return full[local_rows(n, full.device)]


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its backward is the same sum of the cotangents
    (differentiable again, for the double backward of R1 and PL)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the active ranks (``x`` itself with
    one rank)."""
    r = _multi()
    return x if r is None else _AllReduceSum.apply(x, r.group)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Differentiable concatenation of every rank's rows of ``x`` in rank
    order (``x`` itself with one rank); under :func:`row_parts` part by
    part.  A sum of zero-padded copies: the copy is exact, its backward is
    each rank's slice of the summed cotangents, and it needs only
    all-reduce, which every backend runs on every device type."""
    r = _multi()
    if r is None:
        return x
    if _PARTS > 1:
        return torch.cat([_gather_part(p, r)
                          for p in x.chunk(_PARTS, dim=0)])
    return _gather_part(x, r)


def _gather_part(x: torch.Tensor, r: RankGroup) -> torch.Tensor:
    n = x.shape[0]
    full = x.new_zeros((n * r.world,) + tuple(x.shape[1:]))
    full = full.index_copy(0, torch.arange(r.rank * n, (r.rank + 1) * n,
                                           device=x.device), x)
    return _AllReduceSum.apply(full, r.group)


def batch_mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x.mean(dim)`` over the global batch, for a ``dim`` that includes
    the rows (dim 0; None: every element), differentiable; exactly
    ``x.mean(dim)`` with one rank."""
    r = _multi()
    if r is None:
        return x.mean() if dim is None else x.mean(dim=dim)
    s = x.sum() if dim is None else x.sum(dim=dim)
    return all_reduce_sum(s) / float(x.numel() // s.numel() * r.world)


def _buckets(tensors: List[torch.Tensor]):
    """Indices of ``tensors`` grouped by (device, dtype): one flat buffer
    each."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    return groups.values()


def mean_over_ranks_(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the active ranks of each tensor, through one flattened
    all-reduce per dtype (not one collective per tensor); returns new
    tensors shaped as the inputs.  Without a group they come back as given;
    a group of one runs its collective and divides by nothing."""
    r = _ACTIVE
    if r is None or not tensors:
        return list(tensors)
    out = list(tensors)
    for idx in _buckets(tensors):
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, group=r.group)
        if r.world > 1:
            flat = flat / float(r.world)
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[at:at + n].view_as(tensors[i])
            at += n
    return out


def broadcast_(tensors: List[torch.Tensor], src: int = 0, group=None):
    """Overwrite ``tensors`` in place with rank ``src``'s values, one
    flattened broadcast per dtype."""
    for idx in _buckets(tensors):
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.broadcast(flat, src=src, group=group)
        at = 0
        for i in idx:
            n = tensors[i].numel()
            with torch.no_grad():
                tensors[i].copy_(flat[at:at + n].view_as(tensors[i]))
            at += n
