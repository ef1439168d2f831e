"""``TrainingLoop`` of the port on the CPU, strict f32: three batches with
every phase (stats, moved parameters, optimizer counts, the same numbers
from the same seed), and the CUDA requirement of its entry points (the rest
of the loop's tests are in ``tests/test_torch_train_loop.py``).

Small shapes: 32 px, B = 4, <= 32 channels.
"""

import numpy as np
import pytest
import torch

from brushstroke_engine_torch.train import state as tstate
from brushstroke_engine_torch.train.loop import TrainingLoop
from brushstroke_engine_torch.utils.util import tree_leaves
from tests.torch_train_helpers import (  # noqa: F401 (_strict: autouse)
    _strict, B, _train_cfgs, read_stats, small_loop,
)


def test_training_loop_three_batches_on_cpu(tmp_path):
    loop, cfg = small_loop(tmp_path, "a", geom_warmstart_kimg=0)
    p0 = [t.clone() for t in tree_leaves(loop.state["g_params"])]
    d0 = [t.clone() for t in tree_leaves(loop.state["d_params"])]
    ticks = []
    loop.run(total_kimg=3 * B / 1000.0,
             progress_fn=lambda cur, total: ticks.append(cur))
    assert loop.batch_idx == 3 and loop.cur_nimg == 3 * B
    assert ticks == [0, B, 2 * B, 3 * B]
    rows = read_stats(loop)
    assert len(rows) == 3
    for row in rows:
        assert all(np.isfinite(v) for v in row.values())
        assert row["Progress/ada_p"] >= 0
    # Batch 0 and 2 run every phase; batch 1 only Dmain and Gmain.
    for k in ("Loss/D/loss", "Loss/D/reg", "Loss/G/loss", "Loss/G/reg",
              "Loss/forger/Ggeom/total", "Loss/forger/Gmain/iou_inv_uvs"):
        assert k in rows[0] and k in rows[2], k
    assert "Loss/D/reg" not in rows[1] and "Loss/G/reg" not in rows[1]
    assert any(not torch.equal(a, b) for a, b in
               zip(p0, tree_leaves(loop.state["g_params"])))
    assert any(not torch.equal(a, b) for a, b in
               zip(d0, tree_leaves(loop.state["d_params"])))
    assert loop.state["g_opt"]["count"] == 5       # 3 Gmain + 2 Gpl
    assert loop.state["d_opt"]["count"] == 5
    assert loop.state["geom_opt"]["count"] == 2

    # Same seed, same numbers.
    loop2, _ = small_loop(tmp_path, "b", geom_warmstart_kimg=0)
    loop2.run(total_kimg=3 * B / 1000.0)
    for a, b in zip(tree_leaves(loop.state["g_params"]),
                    tree_leaves(loop2.state["g_params"])):
        assert torch.equal(a, b)


def test_training_loop_needs_cuda_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, cfg = _train_cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainingLoop(cfg, {}, {}, None, None, run_dir=str(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tstate.init_train_state(cfg)
