"""The port's stitching against the JAX package's on the CPU, strict f32:
the stitcher's image algebra, ``generate_with_stitching``, the Gstitch step
(without and with ADA), the training loop with stitching across a resume,
and ``stitching_metric_loop``.

Small shapes: 32 px, B = 4, <= 32 channels.  Crops and canvas positions are
injected on both sides; where the JAX package draws (its ADA key, its
unseeded global ``random`` for the second crop) the test replays or seeds
the draw and hands the port the same numbers.  Canvas positions stay off
x or y = 17, 21, 25, 29 (mod 32), where the JAX package's jitted noise
sampling reads wrong texels on the CPU (``ROADMAP.md`` section 3).

Tolerances (set before the runs):
  * the stitcher's translation, masks and composites: 1e-5 abs (the same
    f32 arithmetic; the generator's renders agree to ~1e-6);
  * the Gstitch step: every stat 1e-4 relative (+1e-5 abs); each Adam
    moment of G within 1e-4 relative plus 1e-4 of the largest moment of its
    kind (mu, nu) over G -- a first run held each tensor to 1e-4 of its own
    largest entry and a 0-d moment missed (a noise strength's gradient, a
    sum over every pixel that cancels: 1.2e-4 relative, 1.7e-7 abs); the
    updated G by the method of ``tests/test_torch_train_
    phases.py`` (one Adam step is ~lr * sign(g): per tensor the mean
    |delta_port - delta_jax| under 2 % of the step and 99 % of the entries
    under 10 %); the EMA 2e-5 abs;
  * a resumed stitch run against the uninterrupted one: bitwise;
  * ``stitching_metric_loop``: 1e-5 abs on each metric.
"""

import dataclasses
import pickle
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.engine import brush as jbrush
from brushstroke_engine_tpu.metrics import metric_main as jmm
from brushstroke_engine_tpu.metrics import stroke_generator as jsg
from brushstroke_engine_tpu.train import steps as jsteps
from brushstroke_engine_tpu.train import stitching as jst
from brushstroke_engine_torch.engine import brush as tbrush
from brushstroke_engine_torch.metrics import metric_main as tmm
from brushstroke_engine_torch.metrics import stroke_generator as tsg
from brushstroke_engine_torch.train import steps as tsteps
from brushstroke_engine_torch.train import stitching as tst
from brushstroke_engine_torch.train.loop import LoopHooks, TrainingLoop
from brushstroke_engine_torch.utils.checkpoint import (
    params_from_jax, train_state_from_jax,
)
from brushstroke_engine_torch.utils.util import tree_leaves
from tests.torch_helpers import replay_augment_draws
from tests.torch_train_helpers import (  # noqa: F401 (_strict: autouse)
    _strict, RES, B, _np_tree, _flat, _train_cfgs, _jax_state, _batch,
    _assert_update_parity, _assert_stats, _assert_tree_close,
)

STITCH_LOSSES = "1.0*gan(fake)+1.0*gan(fake_composite)+1.0*l1(patch)"
BAD_NOISE_POS = {17, 21, 25, 29}        # mod 32, see the module doc


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _positions(crop1, crop2, seed=0):
    """``[B, 2]`` canvas positions whose both crops' values keep off the
    positions the JAX package's jitted noise gets wrong."""
    rng = np.random.RandomState(seed)
    delta = np.asarray([crop2[0] - crop1[0], crop2[1] - crop1[1]])
    while True:
        pos = rng.randint(0, RES - 1, size=(B, 2))
        if not (set((pos % RES).ravel()) | set(((pos + delta) % RES)
                                                .ravel())) & BAD_NOISE_POS:
            return pos


# ---------------------------------------------------------------------------
# The stitcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dy, dx", [(0, 0), (3, 5), (-4, 2), (-7, -9),
                                    (6, -1), (31, 0), (0, -31)])
def test_translate_image_and_composite_match_jax(dy, dx):
    rng = np.random.RandomState(dy * 100 + dx + 1000)
    a = rng.randn(2, 12, 10, 3).astype(np.float32)
    b = rng.randn(2, 12, 10, 3).astype(np.float32)
    got = tst.translate_image(torch.from_numpy(a), dy, dx)
    want = jst.translate_image(jnp.asarray(a), dy, dx)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)
    area = (max(dy, 0) + 1, 11 + min(dy, 0), 2, 9 - abs(dx) % 4)
    got = tst.composite_shifted(torch.from_numpy(a), torch.from_numpy(b),
                                area, (dy, dx))
    want = jst.composite_shifted(jnp.asarray(a), jnp.asarray(b), area,
                                 (dy, dx))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        _np(tst.rect_mask(12, 10, *area)),
        np.asarray(jst.rect_mask(12, 10, *area)))


def _features(m, jcfg, tcfg, geom):
    jf = jsteps.encode_geometry(jcfg, m["jax"]["enc_params"],
                                m["jax"]["enc_state"], jnp.asarray(geom))
    tf = tsteps.encode_geometry(tcfg, m["torch"]["enc_params"],
                                m["torch"]["enc_state"],
                                torch.from_numpy(geom))
    return jf, tf


@pytest.mark.parametrize("margin, min_overlap, crop1, crop2", [
    (10, 50, (4, 6, RES, RES), (9, 2, RES, RES)),     # pw = the whole crop
    (0, 20, (7, 3, RES, RES), (1, 8, RES, RES)),
    (3, 12, (0, 0, RES, RES), (6, 4, RES, RES)),
])
def test_generate_with_stitching_matches_jax(margin, min_overlap, crop1,
                                             crop2):
    m, jcfg, tcfg = _train_cfgs()
    _, geom, _, zs = _batch(3)
    geom2 = np.ascontiguousarray(geom[:, ::-1])
    jf1, tf1 = _features(m, jcfg, tcfg, geom)
    jf2, tf2 = _features(m, jcfg, tcfg, geom2)
    pos = _positions(crop1, crop2, seed=margin)
    want = jst.RandomStitcher(margin, min_overlap).generate_with_stitching(
        jcfg.gen_cfg, m["jax"]["gen_params"], m["jax"]["gen_state"],
        jnp.asarray(zs[0]), jf1, jf2, crop1, crop2, jax.random.PRNGKey(0),
        positions1=jnp.asarray(pos))
    got = tst.RandomStitcher(margin, min_overlap).generate_with_stitching(
        tcfg.gen_cfg, m["torch"]["gen_params"], m["torch"]["gen_state"],
        torch.from_numpy(zs[0]), tf1, tf2, crop1, crop2,
        positions1=torch.from_numpy(pos))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    pw = min(min_overlap, RES)
    assert got["patch1"].shape == (B, pw, pw, 3)
    if pw == RES:
        # At 32 px the window is the whole crop.
        assert torch.equal(got["patch1"], got["fake1"])
    # The composites differ from the fakes only inside the overlap.
    assert not torch.equal(got["fake1_composite"], got["fake1"])


def test_positions_are_drawn_from_the_generator():
    a = tst.draw_positions(torch.Generator().manual_seed(3), B, RES, "cpu")
    b = tst.draw_positions(torch.Generator().manual_seed(3), B, RES, "cpu")
    assert torch.equal(a, b) and a.shape == (B, 2)
    assert int(a.min()) >= 0 and int(a.max()) < RES - 1


# ---------------------------------------------------------------------------
# The Gstitch step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("augment", [None, "bgc"])
def test_gstitch_step_matches_jax(augment):
    m, jcfg, tcfg = _train_cfgs(augment, stitch_interval=4,
                                stitch_phase_losses=STITCH_LOSSES)
    _, geom, _, zs = _batch(5)
    geom2 = np.ascontiguousarray(geom[:, :, ::-1])
    jf1, tf1 = _features(m, jcfg, tcfg, geom)
    jf2, tf2 = _features(m, jcfg, tcfg, geom2)
    crop1, crop2 = (2, 3, RES, RES), (7, 0, RES, RES)
    pos = _positions(crop1, crop2, seed=7)
    ada_p = 0.6 if augment else 0.0
    jstate = _jax_state(m, jcfg, ada_p)
    tstate = train_state_from_jax(_np_tree(jstate), device="cpu")
    before = _np_tree(jstate["g_params"])
    key = jax.random.PRNGKey(21)
    stitcher = (3, 12)
    draws = {"positions1": torch.from_numpy(pos)}
    if augment:
        _, k_aug1, k_aug2, _ = jax.random.split(key, 4)
        shape = (RES, RES, 3)
        draws["aug_fake"] = replay_augment_draws(tcfg.augment, k_aug1,
                                                 2 * B, shape)
        draws["aug_composite"] = replay_augment_draws(tcfg.augment, k_aug2,
                                                      2 * B, shape)
    tstate2, ts = tsteps.g_stitch_step(
        tcfg, tstate, tf1, tf2, torch.from_numpy(zs[1]), crop1, crop2,
        ema_beta=0.5, draws=draws, stitcher=tst.RandomStitcher(*stitcher))
    jstate2, js = jsteps.make_stitch_step(
        jcfg, stitcher=jst.RandomStitcher(*stitcher))(
        jstate, jf1, jf2, jnp.asarray(zs[1]), jnp.asarray(crop1),
        jnp.asarray(crop2), key, jnp.float32(0.5),
        positions1=jnp.asarray(pos))
    _assert_stats(ts, js, f"Gstitch {augment}")
    assert {"Loss/forger/Gstitch/gan_fake", "Loss/forger/Gstitch/l1_patch",
            "Loss/forger/Gstitch/gan_fake_composite"} <= set(ts)
    assert float(ts["Loss/forger/Gstitch/l1_patch"]) > 0
    jport = train_state_from_jax(_np_tree(jstate2), device="cpu")
    _assert_update_parity(params_from_jax(before), tstate2["g_params"],
                          jport["g_params"], 2e-4 * 4 / 5, "Gstitch")
    fg, fj = _flat(tstate2["g_opt"]), _flat(jport["g_opt"])
    assert set(fg) == set(fj)
    for kind in ("mu", "nu"):
        keys = [k for k in fj if k.startswith(f"/{kind}/")]
        scale = max(float(np.abs(fj[k]).max()) for k in keys)
        assert keys and scale > 0
        for k in keys:
            np.testing.assert_allclose(fg[k], fj[k], rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=k)
    assert tstate2["g_opt"]["count"] == 1
    _assert_tree_close(tstate2["g_ema"], jport["g_ema"], "Gstitch ema")
    # D, w_avg and the input state are left as they were.
    for a, b in zip(tree_leaves(tstate["g_params"]),
                    tree_leaves(params_from_jax(before))):
        assert torch.equal(a, b)
    assert tstate2["d_params"] is tstate["d_params"]
    assert tstate2["w_avg"] is tstate["w_avg"]


def test_gstitch_rounds_pair_both_crops():
    """With batch_gpu rounds, each round takes the same samples of both
    crops: two rounds of 2 give the mean loss of the two halves."""
    m, jcfg, tcfg = _train_cfgs(None, stitch_interval=4, batch_gpu=2,
                                stitch_phase_losses="1.0*l1(fake_composite)")
    _, geom, _, zs = _batch(6)
    tf1 = tsteps.encode_geometry(tcfg, m["torch"]["enc_params"],
                                 m["torch"]["enc_state"],
                                 torch.from_numpy(geom))
    tf2 = [torch.flip(f, dims=(2,)) for f in tf1]
    state = train_state_from_jax(_np_tree(_jax_state(m, jcfg)),
                                 device="cpu")
    crop1, crop2 = (0, 0, RES, RES), (5, 6, RES, RES)
    pos = torch.from_numpy(_positions(crop1, crop2, seed=2))
    z = torch.from_numpy(zs[0])
    _, rounds = tsteps.g_stitch_step(
        tcfg, state, tf1, tf2, z, crop1, crop2,
        draws=[{"positions1": pos[:2]}, {"positions1": pos[2:]}])
    halves = []
    one = dataclasses.replace(tcfg, batch_gpu=None)
    for sl in (slice(0, 2), slice(2, 4)):
        _, s = tsteps.g_stitch_step(
            one, state, [f[sl] for f in tf1], [f[sl] for f in tf2], z[sl],
            crop1, crop2, draws={"positions1": pos[sl]})
        halves.append(float(s["Loss/forger/Gstitch/total"]))
    np.testing.assert_allclose(float(rounds["Loss/forger/Gstitch/total"]),
                               np.mean(halves), rtol=1e-6)


# ---------------------------------------------------------------------------
# The loop with stitching: resume is bitwise
# ---------------------------------------------------------------------------

class _Const:
    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        return self

    def __next__(self):
        return self.batch


def _stitch_loop(run_dir, cfg_kw=None, **kw):
    m, _, tcfg = _train_cfgs(
        "bgc", noise_mode="random", style_mixing_prob=0.9, d_reg_interval=4,
        g_reg_interval=4, geom_interval=4, ada_interval=2, stitch_interval=1,
        stitch_phase_losses=STITCH_LOSSES, kimg_per_tick=B / 1000.0,
        geom_warmstart_kimg=0, **(cfg_kw or {}))
    rng = np.random.RandomState(8)
    style = rng.randint(0, 256, (B, RES, RES, 3)).astype(np.uint8)
    tri = rng.randint(0, 256, (B, RES + 24, RES + 24, 3)).astype(np.uint8)
    rows = []
    loop = TrainingLoop(tcfg, m["torch"]["enc_params"],
                        m["torch"]["enc_state"], _Const(style), _Const(tri),
                        run_dir=str(run_dir), seed=9, device="cpu",
                        hooks=LoopHooks(on_tick=lambda lp, st: rows.append(
                            {k: v for k, v in st.items()
                             if not k.startswith("Timing/")})), **kw)
    return loop, rows


def test_stitch_loop_resume_is_bitwise(tmp_path):
    """X takes 1 batch, saves, takes 2 more; Y resumes X's save and takes
    the same 2: equal stats and state, bit for bit (the crop stream travels
    in the train state).  A state file without the crop stream starts it
    from the seed."""
    x, xs = _stitch_loop(tmp_path / "r", snapshot_ticks=10 ** 9)
    x.run(total_kimg=B / 1000.0)
    x.save_train_state()
    crops = x.stitch_rng.getstate()
    y, ys = _stitch_loop(tmp_path / "r", auto_resume=True,
                         snapshot_ticks=10 ** 9)
    assert y.batch_idx == 1 and y.stitch_rng.getstate() == crops
    x.run(total_kimg=3 * B / 1000.0)
    y.run(total_kimg=3 * B / 1000.0)
    assert xs[-2:] == ys[-2:]
    assert all("Loss/forger/Gstitch/total" in r for r in xs)
    leaves = list(zip(tree_leaves(x.state), tree_leaves(y.state)))
    assert leaves and all(
        torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        for a, b in leaves)
    assert x.stitch_rng.getstate() == y.stitch_rng.getstate()
    # A state file without the crop stream starts it from the seed.
    path = x.save_train_state()
    with open(path, "rb") as f:
        payload = pickle.load(f)
    del payload["rng_state"]["stitch_rng"]
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    z, _ = _stitch_loop(tmp_path / "r", auto_resume=True)
    assert z.stitch_rng.getstate() == random.Random(9).getstate()


# ---------------------------------------------------------------------------
# stitching_metric_loop
# ---------------------------------------------------------------------------

def _engines():
    m, _, _ = _train_cfgs()
    jgen, jenc = m["jax_cfg"]
    tgen, tenc = m["cfg"]
    j = jbrush.TriadGanPaintEngine(
        jgen, m["jax"]["gen_params"], m["jax"]["gen_state"], jenc,
        m["jax"]["enc_params"], m["jax"]["enc_state"],
        geom_inject_resolutions=(0, 1))
    t = tbrush.TriadGanPaintEngine(
        tgen, m["torch"]["gen_params"], m["torch"]["gen_state"], tenc,
        m["torch"]["enc_params"], m["torch"]["enc_state"],
        geom_inject_resolutions=(0, 1), device="cpu")
    return j, t


def test_stitching_metric_loop_matches_jax():
    jeng, teng = _engines()
    rng = np.random.RandomState(11)
    tris = [rng.randint(0, 256, (2, 56, 56, 3)).astype(np.uint8)
            for _ in range(2)]
    key = jax.random.PRNGKey(4)
    draws = []
    for _ in tris:
        key, ks = jax.random.split(key)
        k_pos = jax.random.split(ks, 3)[0]
        draws.append({"positions1": np.asarray(
            jax.random.randint(k_pos, (2, 2), 0, RES - 1))})
    jgen = jsg.PaintStrokeGenerator(2, jeng, jsg.RandomState(4))
    tgen = tsg.PaintStrokeGenerator(2, teng, tsg.RandomState(4))
    random.seed(4)
    want = jmm.stitching_metric_loop(
        jgen, iter(tris), num_batches=2,
        stitcher=jst.RandomStitcher(crop_margin=2, min_overlap=8))
    got = tmm.stitching_metric_loop(
        tgen, iter(tris), num_batches=2,
        stitcher=tst.RandomStitcher(crop_margin=2, min_overlap=8),
        draws=draws)
    assert set(got) == set(want) == {"STITCH_LPIPS", "STITCH_L1"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
        assert got[k] > 0
    # Geometry no wider than the patch: nothing to stitch.
    small = [rng.randint(0, 256, (2, RES, RES, 3)).astype(np.uint8)]
    assert tmm.stitching_metric_loop(tgen, iter(small), 1) == {}
