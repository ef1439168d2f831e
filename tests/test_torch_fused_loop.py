"""The loop's production path on the CPU: ``TrainingLoop`` with the fused
step from host batches and from device banks (``profile_phases``,
``Timing/fused``, the phases of the phase path, the JAX loop's guards), and
with banks and ``steps_per_dispatch=2``: ticks on dispatch boundaries with
each phase's last finite value, a resume across a dispatch boundary bitwise
the uninterrupted run (both random streams and the stitch crop stream), and
the profiler trace of a dispatch.  32 px, B = 4, <= 32 channels.
"""

import itertools
import json
import os

import numpy as np
import pytest
import torch

from brushstroke_engine_torch.train.device_dataset import build_device_banks
from brushstroke_engine_torch.train.loop import TrainingLoop
from brushstroke_engine_torch.utils.util import tree_leaves
from tests.torch_train_helpers import (  # noqa: F401 (_strict: autouse)
    _strict, RES, B, _train_cfgs,
)
from tests.torch_helpers import one_torch_thread  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_torch_thread")


class _DS:
    def __init__(self, a):
        self.a = a

    def __len__(self):
        return len(self.a)

    def __getitem__(self, i):
        return self.a[i]


def _bank_loop(tmp_path, name, cfg, m, banks, **kw):
    return TrainingLoop(cfg, m["torch"]["enc_params"],
                        m["torch"]["enc_state"], None, None,
                        run_dir=str(tmp_path / name), seed=5, device="cpu",
                        use_fused=True, device_banks=banks,
                        steps_per_dispatch=2, snapshot_ticks=10 ** 9, **kw)


def test_chunked_loop_resumes_bitwise_and_keeps_finite_stats(tmp_path):
    """Banks and ``steps_per_dispatch=2`` with stitching on: the counters
    step by 2 batches, a tick lands on each dispatch boundary with every
    phase's last finite value; a loop resumed from the state saved after
    one dispatch takes the next one bitwise as the uninterrupted loop
    does; the profiler trace covers the dispatch from batch 2."""
    m, _, cfg = _train_cfgs(
        "bgc", noise_mode="random", style_mixing_prob=0.9, d_reg_interval=4,
        g_reg_interval=2, geom_interval=2, ada_interval=1,
        geom_warmstart_kimg=0, stitch_interval=2, kimg_per_tick=B / 1000.0,
        stitch_phase_losses="1.0*gan(fake)+1.0*l1(patch)")
    rng = np.random.RandomState(4)
    banks = build_device_banks(
        _DS(rng.randint(0, 256, (6, RES, RES, 3)).astype(np.uint8)),
        _DS(rng.randint(0, 256, (5, RES + 24, RES + 24, 3)).astype(
            np.uint8)), device="cpu")
    rows = []
    x = _bank_loop(tmp_path, "x", cfg, m, banks,
                   profile_dir=str(tmp_path / "trace"),
                   profile_batches=(1, 3))
    x.run(total_kimg=2 * B / 1000.0)
    assert (x.batch_idx, x.cur_nimg, x.cur_tick) == (2, 2 * B, 1)
    os.makedirs(tmp_path / "y")
    x.save_train_state(str(tmp_path / "y" / "train_state.pkl"))
    x.run(total_kimg=4 * B / 1000.0)
    assert (x.batch_idx, x.cur_nimg) == (4, 4 * B)
    with open(x.stats_path) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 2
    for row in rows:
        assert all(np.isfinite(v) for v in row.values())
        # Batch 0 / 2 ran Dreg / Gstitch / Ggeom, batch 1 / 3 did not: the
        # tick keeps batch 0's / 2's values, not NaN.
        for k in ("Loss/D/loss", "Loss/G/reg", "Loss/forger/Ggeom/total",
                  "Loss/forger/Gstitch/total"):
            assert k in row, k
    assert "Loss/r1_penalty" in rows[0] and "Loss/r1_penalty" not in rows[1]
    assert os.listdir(tmp_path / "trace") == ["batches_2-4.pt.trace.json"]

    y = _bank_loop(tmp_path, "y", cfg, m, banks, auto_resume=True)
    assert (y.batch_idx, y.cur_nimg) == (2, 2 * B)
    y.run(total_kimg=4 * B / 1000.0)
    for a, b in zip(tree_leaves(x.state), tree_leaves(y.state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    assert x.rng.bit_generator.state == y.rng.bit_generator.state
    assert torch.equal(x.device_rng.get_state(), y.device_rng.get_state())
    with open(y.stats_path) as f:
        last = [json.loads(line) for line in f][-1]
    strip = {k: v for k, v in rows[-1].items() if not k.startswith("Timing")}
    assert strip == {k: v for k, v in last.items()
                     if not k.startswith("Timing")}


@pytest.mark.parametrize("mode", ["host", "banks"])
def test_fused_loop_modes_run_every_phase(tmp_path, mode):
    """One fused step per batch from host batches and from banks, with
    ``profile_phases``: ``Timing/fused``, and the same phases the loop's
    phase path runs."""
    m, _, cfg = _train_cfgs(
        "bgc", d_reg_interval=2, g_reg_interval=2, geom_interval=2,
        ada_interval=1, geom_warmstart_kimg=B / 1000.0,
        kimg_per_tick=B / 1000.0)
    rng = np.random.RandomState(1)
    style = rng.randint(0, 256, (B, RES, RES, 3)).astype(np.uint8)
    tri = rng.randint(0, 256, (B, RES + 8, RES + 8, 3)).astype(np.uint8)
    kw = {}
    its = (itertools.repeat(style), itertools.repeat(tri))
    if mode == "banks":
        kw["device_banks"] = build_device_banks(_DS(style), _DS(tri),
                                                device="cpu")
        its = (None, None)
    loop = TrainingLoop(cfg, m["torch"]["enc_params"],
                        m["torch"]["enc_state"], *its,
                        run_dir=str(tmp_path / mode), seed=3, device="cpu",
                        use_fused=True, profile_phases=True, **kw)
    loop.run(total_kimg=3 * B / 1000.0)
    with open(loop.stats_path) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 3 and all("Timing/fused" in r for r in rows)
    assert "Loss/forger/Ggeom-warm/total" in rows[0] and \
        "Loss/D/loss" not in rows[0]
    assert "Loss/D/loss" in rows[1] and "Loss/r1_penalty" not in rows[1]
    assert {"Loss/D/loss", "Loss/r1_penalty", "Loss/G/reg",
            "Loss/forger/Ggeom/total"} <= set(rows[2])
    assert len(loop.phase_seconds["fused"]) == 3
    # The loop's guards, as the JAX loop's.
    for kw, err in ((dict(device_banks=object()), ValueError),
                    (dict(steps_per_dispatch=2), ValueError),
                    (dict(mesh=object()), NotImplementedError)):
        with pytest.raises(err):
            TrainingLoop(cfg, {}, {}, None, None,
                         run_dir=str(tmp_path / "g"), device="cpu", **kw)
