"""The training loop's tensor-wise train-state backend (``backend="orbax"``:
``torch.distributed.checkpoint``, the JAX package's Orbax directory's
counterpart), on the CPU at 32 px, B = 4.

It round-trips bitwise -- every state leaf, the Adam counts, the counters
and the three random streams (host numpy, device ``torch.Generator``,
stitch crops) -- as ``tests/test_train.py::test_train_state_roundtrip_
backends`` holds the JAX backends; it holds what the pickle backend holds;
and a run resumed through it goes on bitwise as the uninterrupted run
does (``tests/test_train.py``'s resume case).
"""

import os
import random

import numpy as np
import pytest
import torch

from brushstroke_engine_torch.utils.util import tree_leaves
from tests.torch_train_helpers import (  # noqa: F401 (_strict: autouse)
    _strict, B, small_loop,
)


def _assert_same(a, b):
    assert (a.cur_nimg, a.batch_idx, a.cur_tick) == \
        (b.cur_nimg, b.batch_idx, b.cur_tick)
    la, lb = tree_leaves(a.state), tree_leaves(b.state)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y
    assert a.rng.bit_generator.state == b.rng.bit_generator.state
    assert torch.equal(a.device_rng.get_state(), b.device_rng.get_state())
    assert a.stitch_rng.getstate() == b.stitch_rng.getstate()


def test_tensorwise_backend_round_trips_bitwise(tmp_path):
    loop, _ = small_loop(tmp_path, "a", geom_warmstart_kimg=0)
    loop.run(total_kimg=B / 1000.0)
    loop.cur_nimg, loop.batch_idx, loop.cur_tick = 1234, 17, 3
    loop.stitch_rng.random()
    path = loop.save_train_state(backend="orbax")
    assert path == os.path.join(loop.run_dir, "train_state_orbax")
    assert os.path.isdir(path) and os.path.isfile(path + ".nprng.pkl")
    assert not os.path.exists(path + ".tmp")
    # Written again over itself, atomically.
    assert loop.save_train_state(backend="orbax") == path

    fresh, _ = small_loop(tmp_path, "b", geom_warmstart_kimg=0)
    assert fresh.load_train_state(str(tmp_path / "none"),
                                  backend="orbax") is False
    assert fresh.load_train_state(path, backend="orbax")
    _assert_same(fresh, loop)
    assert isinstance(fresh.state["g_opt"]["count"], int)
    assert fresh.state["g_opt"]["count"] == loop.state["g_opt"]["count"] > 0
    # The pickle backend restores the same state.
    pk = loop.save_train_state(backend="pickle")
    other, _ = small_loop(tmp_path, "c", geom_warmstart_kimg=0)
    assert other.load_train_state(pk)
    _assert_same(other, fresh)
    with pytest.raises(ValueError, match="backend"):
        loop.save_train_state(backend="zarr")


def test_resume_through_the_tensorwise_backend_is_bitwise(tmp_path):
    """Two batches, save, two more; a new loop resumed from the save takes
    the same two batches bit for bit."""
    x, _ = small_loop(tmp_path, "x", geom_warmstart_kimg=0)
    x.run(total_kimg=2 * B / 1000.0)
    path = x.save_train_state(str(tmp_path / "mid"), backend="orbax")
    x.run(total_kimg=4 * B / 1000.0)
    y, _ = small_loop(tmp_path, "y", geom_warmstart_kimg=0)
    # A fresh loop draws from the seed, not from the saved streams.
    y.stitch_rng = random.Random(99)
    assert y.load_train_state(path, backend="orbax")
    assert (y.batch_idx, y.cur_nimg) == (2, 2 * B)
    y.run(total_kimg=4 * B / 1000.0)
    _assert_same(y, x)
    assert np.isfinite(float(y.state["pl_mean"]))
