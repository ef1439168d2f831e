"""The port's network snapshots and resumable train state on the CPU, strict
f32: the train-state file leaf by leaf, the conversion to and from the JAX
package's train state, a resumed run against the uninterrupted one, the
snapshot cadence and hooks, a port snapshot rendered by the JAX package,
and a failing eval hook counted in the stats.

Small shapes: 32 px, B = 4, <= 32 channels.  Tolerances: the train-state
file, the conversions and a resumed run are exact (bitwise); a snapshot
rendered by both packages 2e-5 abs in RGBA (the render parity of
``tests/test_torch_render.py``).
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.engine import brush as jbrush
from brushstroke_engine_tpu.train import steps as jsteps
from brushstroke_engine_tpu.utils.checkpoint import load_native as jload
from brushstroke_engine_torch.engine import brush as tbrush
from brushstroke_engine_torch.train import eval_hooks
from brushstroke_engine_torch.train.loop import LoopHooks, TrainingLoop
from brushstroke_engine_torch.utils.checkpoint import (
    load_native, train_state_from_jax, train_state_to_jax,
)
from brushstroke_engine_torch.utils.util import tree_leaves
from tests.torch_train_helpers import (  # noqa: F401 (_strict: autouse)
    _strict, RES, B, _np_tree, _train_cfgs, _jax_state, _batch,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small shapes: the suite runs several
    test processes on the machine's cores, and torch's default pool of one
    thread per core then oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Batches:
    """Iterates given batches; ``start`` skips the first ones."""

    def __init__(self, batches, start=0):
        self.batches, self.i = batches, start

    def __iter__(self):
        return self

    def __next__(self):
        b = self.batches[self.i % len(self.batches)]
        self.i += 1
        return b


def _data(n):
    rng = np.random.RandomState(21)
    style = [rng.randint(0, 256, (B, RES, RES, 3)).astype(np.uint8)
             for _ in range(n)]
    tri = [rng.randint(0, 256, (B, RES + 8, RES + 8, 3)).astype(np.uint8)
           for _ in range(n)]
    return style, tri


def _loop(run_dir, start=0, n=8, hooks=None, **kw):
    m, _, tcfg = _train_cfgs(
        "bgc", noise_mode="random", style_mixing_prob=0.9, d_reg_interval=2,
        g_reg_interval=2, geom_interval=2, ada_interval=1,
        kimg_per_tick=B / 1000.0, geom_warmstart_kimg=B / 1000.0)
    style, tri = _data(n)
    loop = TrainingLoop(tcfg, m["torch"]["enc_params"],
                        m["torch"]["enc_state"], _Batches(style, start),
                        _Batches(tri, start), run_dir=str(run_dir), seed=5,
                        hooks=hooks, device="cpu", **kw)
    return loop


def _stats(loop):
    with open(loop.stats_path) as f:
        return [json.loads(line) for line in f]


def _no_timing(rows):
    return [{k: v for k, v in r.items() if not k.startswith("Timing/")}
            for r in rows]


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        elif isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert torch.equal(a[k], b[k]), k
        else:
            assert type(a[k]) is type(b[k]) and a[k] == b[k], k


# ---------------------------------------------------------------------------
# The train-state file and the conversions
# ---------------------------------------------------------------------------

def test_train_state_round_trips_leaf_by_leaf(tmp_path):
    loop = _loop(tmp_path / "a")
    loop.run(total_kimg=3 * B / 1000.0)
    assert loop.state["g_opt"]["count"] > 0
    path = loop.save_train_state(str(tmp_path / "ts.pkl"))
    with open(path, "rb") as f:
        payload = pickle.load(f)
    assert payload["magic"] == "brushstroke_engine_torch.train_state.v1"
    assert payload["state"]["ada_p"].shape == ()
    assert isinstance(payload["state"]["d_opt"]["count"], int)
    assert payload["rng_state"]["device_rng"].dtype == np.uint8

    other = _loop(tmp_path / "b")
    assert other.load_train_state(path)
    _assert_trees_equal(other.state, loop.state)
    for leaf in tree_leaves(other.state):
        if isinstance(leaf, torch.Tensor):
            assert leaf.device.type == "cpu"
    assert (other.cur_nimg, other.batch_idx, other.cur_tick) == \
        (loop.cur_nimg, loop.batch_idx, loop.cur_tick) == (3 * B, 3, 3)
    assert other.rng.bit_generator.state == loop.rng.bit_generator.state
    assert torch.equal(other.device_rng.get_state(),
                       loop.device_rng.get_state())
    assert not other.load_train_state(str(tmp_path / "missing.pkl"))
    with open(str(tmp_path / "bad.pkl"), "wb") as f:
        pickle.dump({"magic": "brushstroke_engine_tpu.train_state.v1"}, f)
    with pytest.raises(ValueError, match="train state"):
        other.load_train_state(str(tmp_path / "bad.pkl"))


def test_train_state_to_jax_inverts_from_jax():
    """A JAX state after one Dmain and one Gmain step -> the port's ->
    back, equal leaf by leaf (Adam as optax's ScaleByAdamState fields)."""
    m, jcfg, _ = _train_cfgs()
    real, geom, truth, zs = _batch(1)
    state = _jax_state(m, jcfg, ada_p=0.25)
    feats = jsteps.encode_geometry(jcfg, m["jax"]["enc_params"],
                                   m["jax"]["enc_state"], jnp.asarray(geom))
    state, _ = jsteps.d_main_step(jcfg, state, jnp.asarray(real), feats,
                                  jnp.asarray(zs[0]), jax.random.PRNGKey(1))
    state, _ = jsteps.g_main_step(jcfg, state, feats, jnp.asarray(truth),
                                  jnp.asarray(zs[1]), jax.random.PRNGKey(2),
                                  jnp.float32(0.5))
    snap = _np_tree(state)
    back = train_state_to_jax(train_state_from_jax(snap, device="cpu"))
    assert set(back) == set(snap)
    for k in ("g_opt", "d_opt", "geom_opt"):
        adam = next(s for s in state[k] if hasattr(s, "mu"))
        want = {"count": np.asarray(adam.count), "mu": _np_tree(adam.mu),
                "nu": _np_tree(adam.nu)}
        assert back[k]["count"].dtype == want["count"].dtype
        jax.tree_util.tree_map(np.testing.assert_array_equal, back[k], want)
        snap[k] = want
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    flat_s = jax.tree_util.tree_leaves_with_path(snap)
    assert [p for p, _ in flat_b] == [p for p, _ in flat_s]
    for (p, a), (_, b) in zip(flat_b, flat_s):
        assert a.shape == b.shape, p
        np.testing.assert_array_equal(a, b, err_msg=str(p))


# ---------------------------------------------------------------------------
# Resume
# ---------------------------------------------------------------------------

def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path):
    """N = 3 batches (2 of them warm start), save, then M = 3 more: the
    loop that goes on and a new loop resumed from the file (``auto_resume``)
    get the same batches and end bitwise equal, stats included."""
    n, m = 3, 3
    x = _loop(tmp_path / "x", n=n + m)
    x.run(total_kimg=n * B / 1000.0)
    os.makedirs(tmp_path / "y")
    shutil.copy(os.path.join(x.run_dir, "train_state.pkl"), tmp_path / "y")
    x.run(total_kimg=(n + m) * B / 1000.0)

    y = _loop(tmp_path / "y", start=n, n=n + m, auto_resume=True)
    assert (y.cur_nimg, y.batch_idx) == (n * B, n)
    y.run(total_kimg=(n + m) * B / 1000.0)
    _assert_trees_equal(y.state, x.state)
    assert y.rng.bit_generator.state == x.rng.bit_generator.state
    assert _no_timing(_stats(y)) == _no_timing(_stats(x)[n:])

    # A loop that starts from nothing differs: the resume carried state.
    z = _loop(tmp_path / "z", start=n, n=n + m)
    z.run(total_kimg=m * B / 1000.0)
    assert not torch.equal(z.state["g_ema"]["mapping"]["fc0"]["weight"],
                           x.state["g_ema"]["mapping"]["fc0"]["weight"])


def test_finetune_original_generator_is_taken_after_resume(tmp_path):
    """With a fake_orig loss the frozen original is the RESUMED generator
    (a copy: later steps do not move it)."""
    kw = dict(geom_warmstart_losses="0.5*iou_inv(uvs)+2.0*l1(fake_orig)")
    m, _, tcfg = _train_cfgs(geom_warmstart_kimg=4 * B / 1000.0,
                             kimg_per_tick=B / 1000.0, **kw)
    style, tri = _data(2)
    src = TrainingLoop(tcfg, m["torch"]["enc_params"],
                       m["torch"]["enc_state"], _Batches(style),
                       _Batches(tri), run_dir=str(tmp_path / "s"), seed=1,
                       device="cpu")
    src.run(total_kimg=2 * B / 1000.0)
    ft = TrainingLoop(tcfg, m["torch"]["enc_params"],
                      m["torch"]["enc_state"], _Batches(style),
                      _Batches(tri), run_dir=str(tmp_path / "s"), seed=9,
                      device="cpu", auto_resume=True)
    assert ft.g_orig_params is not None
    _assert_trees_equal(ft.g_orig_params, src.state["g_params"])
    orig = [t.clone() for t in tree_leaves(ft.g_orig_params)]
    ft.run(total_kimg=3 * B / 1000.0)
    assert all(torch.equal(a, b) for a, b in
               zip(orig, tree_leaves(ft.g_orig_params)))
    assert not torch.equal(ft.state["g_params"]["synthesis"][f"b{RES}"]
                           ["conv1"]["weight"],
                           src.state["g_params"]["synthesis"][f"b{RES}"]
                           ["conv1"]["weight"])


# ---------------------------------------------------------------------------
# Snapshots and hooks
# ---------------------------------------------------------------------------

def test_snapshot_cadence_and_on_snapshot(tmp_path):
    seen = []
    loop = _loop(tmp_path / "c", hooks=LoopHooks(
        on_snapshot=lambda lp, path: seen.append((lp.cur_tick, path))),
        snapshot_ticks=2)
    loop.run(total_kimg=5 * B / 1000.0)
    assert [t for t, _ in seen] == [0, 2, 4]          # every 2nd, and done
    assert [os.path.basename(p) for _, p in seen] == \
        ["network-snapshot-000000.pkl"] * 3
    rows = _stats(loop)
    assert ["Timing/snapshot_sec" in r for r in rows] == \
        [False, True, False, True, False]
    assert all(r["Timing/snapshot_sec"] > 0 for r in rows
               if "Timing/snapshot_sec" in r)
    bundle = load_native(seen[-1][1], device="cpu")
    assert bundle.extra == {"cur_nimg": 5 * B}
    _assert_trees_equal(bundle.gen_params, loop.state["g_ema"])


def test_snapshot_engine_keeps_its_weights(tmp_path):
    """An engine built from the loop (as the eval hooks build it) and a
    written snapshot stay as they were while training goes on."""
    loop = _loop(tmp_path / "d")
    loop.run(total_kimg=2 * B / 1000.0)
    engine = eval_hooks._engine_from_loop(loop)
    before = [t.clone() for t in tree_leaves(engine.gen_params)]
    # Kept aside: the run's own snapshots reuse the name (same kimg).
    kept = str(tmp_path / "kept.pkl")
    os.replace(loop.save_snapshot(), kept)
    loop.run(total_kimg=4 * B / 1000.0)
    assert all(torch.equal(a, b) for a, b in
               zip(before, tree_leaves(engine.gen_params)))
    assert not torch.equal(before[0], tree_leaves(loop.state["g_ema"])[0])
    assert all(torch.equal(a, b) for a, b in zip(
        before, tree_leaves(load_native(kept, device="cpu").gen_params)))


def _stroke_geom():
    g = np.ones((2, RES, RES, 1), np.float32)
    g[0, 10:22, 4:28] = 0.0
    g[1, 4:28, 14:18] = 0.0
    return g


def test_port_snapshot_renders_in_the_jax_package(tmp_path):
    loop = _loop(tmp_path / "e")
    loop.run(total_kimg=2 * B / 1000.0)
    path = loop.save_snapshot()
    jb = jload(path)
    assert jb.extra == {"cur_nimg": 2 * B}
    j = jbrush.TriadGanPaintEngine(
        jb.gen_cfg, jb.gen_params, jb.gen_state, jb.enc_cfg, jb.enc_params,
        jb.enc_state, geom_inject_resolutions=jb.geom_inject_resolutions)
    t = tbrush.PaintEngineFactory.create(path, device="cpu")
    z = np.random.RandomState(3).randn(2, 16).astype(np.float32)
    outs = []
    for eng, opts in ((j, jbrush.GanBrushOptions()),
                      (t, tbrush.GanBrushOptions())):
        opts.set_style(z)
        outs.append(np.asarray(eng._run_core(_stroke_geom(), opts)["rgba"]))
    assert np.isfinite(outs[1]).all() and outs[1].std() > 0
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=2e-5)


@pytest.mark.parametrize("which", ["viz", "metric"])
def test_failing_hook_is_counted(tmp_path, monkeypatch, which):
    from brushstroke_engine_torch.metrics import metric_main
    from brushstroke_engine_torch.viz import visualize

    def boom(*a, **k):
        raise RuntimeError("broken on purpose")

    target = (visualize.TrainingVisualizer, "do_visualize") \
        if which == "viz" else (metric_main, "paint_engine_metric_loop")
    monkeypatch.setattr(*target, boom)
    hooks = eval_hooks.make_eval_hooks(
        image_snapshot_ticks=1, metric_snapshot_ticks=1,
        metric_batch_size=2, num_metric_styles=1)
    loop = _loop(tmp_path / which, hooks=hooks)
    loop.run(total_kimg=2 * B / 1000.0)
    rows = _stats(loop)
    assert f"Eval/{which}_failures" not in rows[0]
    assert rows[1][f"Eval/{which}_failures"] == 1
    assert loop.hook_failure_counts == {which: 2}
