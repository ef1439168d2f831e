"""Scalar training statistics: moments and a collector, with the
cross-rank reduction.

Counterpart of ``brushstroke_engine_tpu/utils/stats.py`` (the reference's
``torch_utils/training_stats.py``): :func:`report_moments` builds the
``[count, sum, sum_sq]`` moments of a tensor on its device, a
:class:`Collector` accumulates them on the host and answers mean / std
queries, and :meth:`Collector.reduce_over_ranks` sums each name's moments
over a process group -- what the reference's ``training_stats`` did with
its side-channel process group, and what the JAX package gets from
``jax.lax.pmean`` inside its jitted step.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Dict

import numpy as np
import torch


def report_moments(value) -> torch.Tensor:
    """``[count, sum, sum_sq]`` moments of a tensor, f32, on its device."""
    v = torch.as_tensor(value, dtype=torch.float32).reshape(-1)
    return torch.stack([torch.tensor(float(v.numel()), device=v.device),
                        v.sum(), v.square().sum()])


class Collector:
    """Accumulates reported moments; answers mean/std queries
    (reference training_stats.Collector, :113-180)."""

    def __init__(self, regex: str = ".*", keep_previous: bool = True):
        self._regex = re.compile(regex)
        self._keep_previous = keep_previous
        self._moments: Dict[str, np.ndarray] = defaultdict(
            lambda: np.zeros(3, np.float64))
        self._cumulative: Dict[str, np.ndarray] = defaultdict(
            lambda: np.zeros(3, np.float64))

    def report(self, name: str, value):
        """Accumulate a scalar / tensor of VALUES under `name`."""
        if not self._regex.match(name):
            return
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        flat = np.asarray(value, np.float64).reshape(-1)
        m = np.array([flat.size, flat.sum(), np.square(flat).sum()])
        self._moments[name] += m
        self._cumulative[name] += m

    def report_raw_moments(self, name: str, moments):
        """Accumulate a precomputed [count, sum, sum_sq] vector (e.g. from
        :func:`report_moments` inside a training step)."""
        if not self._regex.match(name):
            return
        if isinstance(moments, torch.Tensor):
            moments = moments.detach().cpu().numpy()
        m = np.asarray(moments, np.float64)
        assert m.shape == (3,)
        self._moments[name] += m
        self._cumulative[name] += m

    def reduce_over_ranks(self, group=None, device="cpu"):
        """Sum every name's moments over the ranks of ``group`` (the
        default group if None) in one all-reduce, so that each rank's
        queries answer for the global batch.  The names must be the same on
        every rank (a name no rank reported is absent everywhere); a no-op
        without a process group.  ``device``: where the collective runs
        (a CUDA device for NCCL)."""
        import torch.distributed as dist
        if not dist.is_initialized():
            return
        names = self.names()
        if not names:
            return
        flat = torch.tensor(np.stack([self._moments[n] for n in names]),
                            dtype=torch.float64, device=device)
        dist.all_reduce(flat, group=group)
        summed = flat.cpu().numpy()
        for n, m in zip(names, summed):
            self._cumulative[n] += m - self._moments[n]
            self._moments[n] = m

    def update(self):
        """Roll the accumulation window (reference: delta since last update)."""
        if not self._keep_previous:
            self._moments.clear()

    def names(self):
        return sorted(self._moments.keys())

    def num(self, name: str) -> int:
        return int(self._moments[name][0])

    def mean(self, name: str) -> float:
        m = self._moments[name]
        if m[0] == 0:
            return float("nan")
        return float(m[1] / m[0])

    def std(self, name: str) -> float:
        m = self._moments[name]
        if m[0] < 2:
            return 0.0
        mean = m[1] / m[0]
        var = max(m[2] / m[0] - mean * mean, 0.0)
        return math.sqrt(var)

    def __getitem__(self, name: str) -> float:
        return self.mean(name)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {name: {"num": self.num(name), "mean": self.mean(name),
                       "std": self.std(name)}
                for name in self.names()}

    def reset(self):
        self._moments.clear()
