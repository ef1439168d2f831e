"""The port's training phases against the JAX package, on the CPU, strict
f32: one full Dmain -> Dr1 -> Gmain -> Gpl -> Ggeom cycle, the warm-start
step, the ADA p update and the ``batch_gpu`` rounds.

Small shapes: 32 px, B = 4, <= 32 channels, ``noise_mode="const"``, style
mixing 0, explicit path-length noise, so both packages consume the same
numbers.  Where the JAX step draws from its key (ADA, path-length noise) the
test replays the key's splits and hands the port the same draws.

Tolerances:
  * phase stats 1e-4 relative (+1e-5 abs), ``pl_mean`` 1e-4 relative;
  * parameter updates by the method of ``tests/test_reference_parity.py``:
    with beta1 = 0 one Adam step is ~lr * sign(g), so per tensor the mean
    |delta_port - delta_jax| must stay under 2 % of the step size and 99 % of
    the entries under 10 %; a tensor one side freezes must be exactly
    untouched on the other.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.train import steps as jsteps
from brushstroke_engine_torch.train import state as tstate
from brushstroke_engine_torch.train import steps as tsteps
from brushstroke_engine_torch.utils.checkpoint import (
    params_from_jax, train_state_from_jax,
)
from brushstroke_engine_torch.utils.util import tree_leaves
from tests.torch_helpers import replay_augment_draws
from tests.torch_train_helpers import (  # noqa: F401 (_strict: autouse)
    _strict, RES, B, _np_tree, _flat, _train_cfgs, _jax_state, _batch,
    _assert_update_parity, _assert_stats, _assert_tree_close,
)


# ---------------------------------------------------------------------------
# One full phase cycle through both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("augment", [None, "bgc"])
def test_full_phase_cycle_matches_jax(augment):
    """Dmain -> Dr1 -> Gmain -> Gpl -> Ggeom from the same state through both
    packages; after every phase the port restarts from the JAX state, so each
    phase is compared on its own."""
    m, jcfg, tcfg = _train_cfgs(augment)
    real, geom, truth, zs = _batch(7)
    ada_p = 0.7 if augment else 0.0
    jst = _jax_state(m, jcfg, ada_p)
    jfeats = jsteps.encode_geometry(jcfg, m["jax"]["enc_params"],
                                    m["jax"]["enc_state"], jnp.asarray(geom))
    tfeats = tsteps.encode_geometry(tcfg, m["torch"]["enc_params"],
                                    m["torch"]["enc_state"],
                                    torch.from_numpy(geom))
    t_real, t_truth = torch.from_numpy(real), torch.from_numpy(truth)
    t_zs = [torch.from_numpy(z) for z in zs]
    beta = 0.5
    lr_g, lr_d, lr_geom = 2e-4 * 4 / 5, 2e-4 * 16 / 17, 2e-4
    shape = (RES, RES, 3)

    def replay(key, batch=B):
        if augment is None:
            return None
        return replay_augment_draws(tcfg.augment, key, batch, shape)

    def port_state():
        return train_state_from_jax(_np_tree(jst), device="cpu")

    # --- Dmain: k_g, k_aug1, k_aug2 = split(key, 3) -------------------
    key = jax.random.PRNGKey(11)
    _, k_aug1, k_aug2 = jax.random.split(key, 3)
    tst, before = port_state(), _np_tree(jst["d_params"])
    tst2, ts = tsteps.d_main_step(
        tcfg, tst, t_real, tfeats, t_zs[0],
        draws={"aug_fake": replay(k_aug1), "aug_real": replay(k_aug2)})
    jst, js = jsteps.d_main_step(jcfg, jst, jnp.asarray(real), jfeats,
                                 jnp.asarray(zs[0]), key)
    _assert_stats(ts, js, "Dmain")
    _assert_update_parity(params_from_jax(before), tst2["d_params"],
                          params_from_jax(_np_tree(jst["d_params"])), lr_d,
                          "Dmain")
    np.testing.assert_allclose(float(tst2["ada_signs"]),
                               float(jst["ada_signs"]))
    assert float(tst2["ada_count"]) == float(jst["ada_count"]) == B
    assert tst2["d_opt"]["count"] == 1 and tst["d_opt"]["count"] == 0

    # --- Dr1: the key goes to the augment pipe as it is ----------------
    key = jax.random.PRNGKey(12)
    tst, before = port_state(), _np_tree(jst["d_params"])
    tst2, ts = tsteps.d_reg_step(tcfg, tst, t_real,
                                 draws={"aug": replay(key)})
    jst, js = jsteps.d_reg_step(jcfg, jst, jnp.asarray(real), key)
    _assert_stats(ts, js, "Dr1")
    assert float(ts["Loss/r1_penalty"]) > 0
    _assert_update_parity(params_from_jax(before), tst2["d_params"],
                          params_from_jax(_np_tree(jst["d_params"])), lr_d,
                          "Dr1")

    # --- Gmain: k_g, k_aug, k_loss = split(key, 3) ---------------------
    key = jax.random.PRNGKey(13)
    _, k_aug, _ = jax.random.split(key, 3)
    tst, before = port_state(), _np_tree(jst["g_params"])
    tst2, ts = tsteps.g_main_step(tcfg, tst, tfeats, t_truth, t_zs[1],
                                  ema_beta=beta, draws={"aug": replay(k_aug)})
    jst, js = jsteps.g_main_step(jcfg, jst, jfeats, jnp.asarray(truth),
                                 jnp.asarray(zs[1]), key, jnp.float32(beta))
    _assert_stats(ts, js, "Gmain")
    _assert_update_parity(params_from_jax(before), tst2["g_params"],
                          params_from_jax(_np_tree(jst["g_params"])), lr_g,
                          "Gmain")
    np.testing.assert_allclose(tst2["w_avg"].numpy(),
                               np.asarray(jst["w_avg"]), rtol=1e-5, atol=1e-6)
    _assert_tree_close(tst2["g_ema"],
                       params_from_jax(_np_tree(jst["g_ema"])), "Gmain ema")
    # The input state is left as it was.
    for a, b in zip(tree_leaves(tst["g_params"]),
                    tree_leaves(params_from_jax(before))):
        assert torch.equal(a, b)

    # --- Gpl: k_g, k_noise_img = split(key); shrunk batch --------------
    key = jax.random.PRNGKey(14)
    _, k_noise = jax.random.split(key)
    bs = B // jcfg.pl_batch_shrink
    pl_noise = torch.from_numpy(np.array(
        jax.random.normal(k_noise, (bs,) + shape)))
    tst, before = port_state(), _np_tree(jst["g_params"])
    tst2, ts = tsteps.g_reg_step(tcfg, tst, tfeats, t_zs[2], ema_beta=beta,
                                 draws={"pl_noise": pl_noise})
    jst, js = jsteps.g_reg_step(jcfg, jst, jfeats, jnp.asarray(zs[2]), key,
                                jnp.float32(beta))
    _assert_stats(ts, js, "Gpl")
    np.testing.assert_allclose(float(tst2["pl_mean"]), float(jst["pl_mean"]),
                               rtol=1e-4)
    assert float(jst["pl_mean"]) > 0
    _assert_update_parity(params_from_jax(before), tst2["g_params"],
                          params_from_jax(_np_tree(jst["g_params"])), lr_g,
                          "Gpl")

    # --- Ggeom: only the last block and toRGB move ---------------------
    key = jax.random.PRNGKey(15)
    tst, before = port_state(), _np_tree(jst["g_params"])
    tst2, ts = tsteps.make_geom_step(tcfg, warmstart=False)(
        tst, tfeats, t_truth, t_zs[3], ema_beta=beta)
    jst, js = jsteps.make_geom_step(jcfg, warmstart=False)(
        jst, jfeats, jnp.asarray(truth), jnp.asarray(zs[3]), key,
        jnp.float32(beta))
    _assert_stats(ts, js, "Ggeom")
    _assert_update_parity(params_from_jax(before), tst2["g_params"],
                          params_from_jax(_np_tree(jst["g_params"])), lr_geom,
                          "Ggeom")
    moved = {k for k, v in _flat(tst2["g_params"]).items()
             if np.any(v != _flat(params_from_jax(before))[k])}
    assert moved and all(k.startswith(f"/synthesis/b{RES}/") for k in moved)
    assert tst2["geom_opt"]["count"] == 1 and tst2["g_opt"]["count"] == 2
    _assert_tree_close(tst2["g_ema"],
                       params_from_jax(_np_tree(jst["g_ema"])), "Ggeom ema")


def test_warm_step_with_frozen_original_matches_jax():
    """Ggeom-warm with a fake_orig loss: the frozen original generator runs
    without style mixing, and its image is a constant of the loss."""
    m, jcfg, tcfg = _train_cfgs(
        geom_warmstart_losses="0.5*iou_inv(uvs)+2.0*l1(fake_orig)",
        geom_warmstart_mode="all")
    real, geom, truth, zs = _batch(8)
    jst = _jax_state(m, jcfg)
    g_orig_np = jax.tree_util.tree_map(
        lambda a: np.array(a) * np.float32(1.01), m["np"]["gen_params"])
    jfeats = jsteps.encode_geometry(jcfg, m["jax"]["enc_params"],
                                    m["jax"]["enc_state"], jnp.asarray(geom))
    tfeats = tsteps.encode_geometry(tcfg, m["torch"]["enc_params"],
                                    m["torch"]["enc_state"],
                                    torch.from_numpy(geom))
    tst = train_state_from_jax(_np_tree(jst), device="cpu")
    before = _np_tree(jst["g_params"])
    tstep = tsteps.make_geom_step(tcfg, warmstart=True)
    with pytest.raises(ValueError, match="g_orig_params"):
        tstep(tst, tfeats, torch.from_numpy(truth), torch.from_numpy(zs[0]))
    tst2, ts = tstep(tst, tfeats, torch.from_numpy(truth),
                     torch.from_numpy(zs[0]), ema_beta=0.9,
                     g_orig_params=params_from_jax(g_orig_np))
    jst, js = jsteps.make_geom_step(jcfg, warmstart=True)(
        jst, jfeats, jnp.asarray(truth), jnp.asarray(zs[0]),
        jax.random.PRNGKey(3), jnp.float32(0.9),
        g_orig_params=jax.tree_util.tree_map(jnp.asarray, g_orig_np))
    _assert_stats(ts, js, "Ggeom-warm")
    assert float(ts["Loss/forger/Ggeom-warm/l1_fake_orig"]) > 0
    _assert_update_parity(params_from_jax(before), tst2["g_params"],
                          params_from_jax(_np_tree(jst["g_params"])), 2e-4,
                          "Ggeom-warm")


def test_ada_update_matches_jax():
    m, jcfg, tcfg = _train_cfgs("bgc")
    for signs, count, p0 in [(3.0, 4.0, 0.0), (-2.0, 8.0, 0.001),
                             (0.0, 0.0, 0.0), (-4.0, 4.0, 0.0)]:
        jst = dict(_jax_state(m, jcfg, p0), ada_signs=jnp.float32(signs),
                   ada_count=jnp.float32(count))
        tst = {"ada_p": torch.tensor(p0), "ada_signs": torch.tensor(signs),
               "ada_count": torch.tensor(count)}
        want = jsteps.ada_update(jcfg, jst, np.float32(B * 4))
        got = tsteps.ada_update(tcfg, tst, float(B * 4))
        np.testing.assert_allclose(float(got["ada_p"]), float(want["ada_p"]),
                                   rtol=1e-6, atol=1e-9)
        assert float(got["ada_p"]) >= 0
        assert float(got["ada_signs"]) == 0 and float(got["ada_count"]) == 0


@pytest.mark.parametrize("phase", ["Dmain", "Dr1", "Gmain"])
def test_batch_gpu_rounds_give_the_one_round_update(phase):
    """``batch_gpu=2`` (two accumulation rounds) against one round of 4.
    Minibatch-stddev is off: it couples the samples of a round, so with it
    the two are different functions.  Stats to 1e-5; the mean gradients
    agree to f32 rounding, so the Adam updates agree by the update-parity
    bounds."""
    disc = dict(mbstd_num_channels=0)
    m, _, cfg1 = _train_cfgs(disc=disc)
    _, _, cfg2 = _train_cfgs(disc=disc, batch_gpu=2)
    real, geom, truth, zs = _batch(9)
    state = tstate.init_train_state(
        cfg1, seed=2, g_params=m["torch"]["gen_params"],
        g_state=m["torch"]["gen_state"], device="cpu")
    feats = tsteps.encode_geometry(cfg1, m["torch"]["enc_params"],
                                   m["torch"]["enc_state"],
                                   torch.from_numpy(geom))
    t_real, t_truth = torch.from_numpy(real), torch.from_numpy(truth)
    z = torch.from_numpy(zs[0])

    def run(cfg):
        if phase == "Dmain":
            return tsteps.d_main_step(cfg, state, t_real, feats, z) + \
                ("d_params", 2e-4 * 16 / 17)
        if phase == "Dr1":
            return tsteps.d_reg_step(cfg, state, t_real) + \
                ("d_params", 2e-4 * 16 / 17)
        return tsteps.g_main_step(cfg, state, feats, t_truth, z,
                                  ema_beta=0.5) + ("g_params", 2e-4 * 4 / 5)

    s1, stats1, which, lr = run(cfg1)
    s2, stats2, _, _ = run(cfg2)
    assert tsteps._num_rounds(cfg2, B) == 2 and tsteps._num_rounds(cfg1, B) == 1
    for k in stats1:
        np.testing.assert_allclose(float(stats2[k]), float(stats1[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    _assert_update_parity(state[which], s2[which], s1[which], lr, phase)
    with pytest.raises(ValueError, match="divisible"):
        tsteps._num_rounds(dataclasses.replace(cfg1, batch_gpu=3), B)
