"""Shared pieces of the port's training parity tests
(``tests/test_torch_train_*.py``): the small configs of both packages, a
batch, tree flattening and the comparisons with their tolerances (stated in
each test file), the full phase cycle that two files run with and without
ADA, and the small ``TrainingLoop`` of the loop tests.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.models import discriminator as jdisc
from brushstroke_engine_tpu.ops.precision import set_precision_mode as jset
from brushstroke_engine_tpu.train import augment as jaug
from brushstroke_engine_tpu.train import state as jstate
from brushstroke_engine_tpu.train import steps as jsteps
from brushstroke_engine_torch.models import discriminator as tdisc
from brushstroke_engine_torch.ops.precision import set_precision_mode as tset
from brushstroke_engine_torch.train import augment as taug
from brushstroke_engine_torch.train import state as tstate
from brushstroke_engine_torch.train import steps as tsteps
from brushstroke_engine_torch.train.loop import TrainingLoop
from brushstroke_engine_torch.utils.checkpoint import (
    params_from_jax, train_state_from_jax,
)
from brushstroke_engine_torch.utils.util import tree_leaves
from tests.torch_helpers import replay_augment_draws, small_model

RES, B = 32, 4
STAT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _strict():
    jset("strict")
    tset("strict")
    yield
    jset("strict")
    tset("strict")


def _disc_cfgs(arch="orig", **kw):
    base = dict(c_dim=0, img_resolution=RES, img_channels=3,
                architecture=arch, channel_base=2048, channel_max=32)
    base.update(kw)
    return jdisc.DiscriminatorConfig(**base), \
        tdisc.DiscriminatorConfig(**base)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _flat(tree, prefix=""):
    """{path: float64 array} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    a = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)
    return {prefix: a.astype(np.float64)}




# StyleGAN2 config-f's kind of model, small: a 'skip' G with the RGB head
# and no geometry input (with a 'resnet' D: ``disc=CONFIGF_DISC``).
CONFIGF_MODEL = dict(inject_res=(), color_format="orig", architecture="skip")
CONFIGF_DISC = dict(architecture="resnet")


def _train_cfgs(augment=None, model=None, **kw):
    """Both packages' TrainConfig over ``small_model(seed=3, **model)``;
    a model with no injected resolution trains with no encoder and no
    forger loss."""
    m = small_model(seed=3, **(model or {}))
    jd, td = _disc_cfgs("orig", **kw.pop("disc", {}))
    geometry = bool(m["cfg"][0].synthesis.geom_feature_resolutions)
    common = dict(enc_res=(0, 1), batch_size=B, noise_mode="const",
                  style_mixing_prob=0.0, r1_gamma=10.0,
                  main_phase_losses="0.1*iou_inv(uvs)",
                  geom_phase_mode="last_and_rgb")
    if not geometry:
        common.update(enc_res=(), main_phase_losses="")
    common.update(kw)
    jcfg = jstate.TrainConfig(
        gen_cfg=m["jax_cfg"][0], disc_cfg=jd,
        enc_cfg=m["jax_cfg"][1] if geometry else None,
        augment=None if augment is None
        else jaug.AugmentConfig.from_spec(augment), **common)
    tcfg = tstate.TrainConfig(
        gen_cfg=m["cfg"][0], disc_cfg=td,
        enc_cfg=m["cfg"][1] if geometry else None,
        augment=None if augment is None
        else taug.AugmentConfig.from_spec(augment), **common)
    return m, jcfg, tcfg


def _jax_state(m, jcfg, ada_p=0.0):
    state = jstate.init_train_state(
        jcfg, jax.random.PRNGKey(0), g_params=m["jax"]["gen_params"],
        g_state=m["jax"]["gen_state"])
    state["ada_p"] = jnp.float32(ada_p)
    return state


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    real = rng.randn(B, RES, RES, 3).astype(np.float32)
    geom = (rng.rand(B, RES, RES, 1) > 0.5).astype(np.float32)
    truth = rng.choice([0.0, 0.5, 1.0],
                       size=(B, RES, RES, 1)).astype(np.float32)
    zs = [rng.randn(B, 16).astype(np.float32) for _ in range(4)]
    return real, geom, truth, zs


def _assert_update_parity(before, port_after, jax_after, lr_eff, label):
    fb, fp, fj = _flat(before), _flat(port_after), _flat(jax_after)
    assert set(fb) == set(fp) == set(fj)
    for k in sorted(fb):
        dp, dj = fp[k] - fb[k], fj[k] - fb[k]
        if not np.any(dj):
            assert not np.any(np.abs(dp) > 1e-12), \
                f"{label}:{k} updated a tensor the JAX step froze"
            continue
        diff = np.abs(dp - dj)
        assert diff.mean() < 0.02 * lr_eff, \
            (label, k, float(diff.mean() / lr_eff))
        assert np.mean(diff < 0.1 * lr_eff) > 0.99, \
            (label, k, float(np.mean(diff < 0.1 * lr_eff)))


def _assert_stats(got, want, label):
    assert set(got) == set(want), label
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   err_msg=f"{label}:{k}", **STAT_TOL)


def _assert_tree_close(got, want, label, tol=2e-5):
    fg, fw = _flat(got), _flat(want)
    assert set(fg) == set(fw)
    for k in fw:
        np.testing.assert_allclose(fg[k], fw[k], rtol=0, atol=tol,
                                   err_msg=f"{label}:{k}")


def full_phase_cycle(augment, model=None, disc=None):
    """Dmain -> Dr1 -> Gmain -> Gpl -> Ggeom from the same state through both
    packages; after every phase the port restarts from the JAX state, so each
    phase is compared on its own.  A model with no injected resolution
    (``CONFIGF_MODEL``) runs the four phases with no geometry and no
    Ggeom."""
    m, jcfg, tcfg = _train_cfgs(augment, model=model, disc=disc or {})
    real, geom, truth, zs = _batch(7)
    ada_p = 0.7 if augment else 0.0
    jst = _jax_state(m, jcfg, ada_p)
    geometry = bool(jcfg.enc_res)
    if geometry:
        jfeats = jsteps.encode_geometry(jcfg, m["jax"]["enc_params"],
                                        m["jax"]["enc_state"],
                                        jnp.asarray(geom))
        tfeats = tsteps.encode_geometry(tcfg, m["torch"]["enc_params"],
                                        m["torch"]["enc_state"],
                                        torch.from_numpy(geom))
        t_truth = torch.from_numpy(truth)
    else:
        jfeats, tfeats, truth, t_truth = [], [], None, None
    t_real = torch.from_numpy(real)
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
    jst, js = jsteps.g_main_step(jcfg, jst, jfeats,
                                 None if truth is None else jnp.asarray(truth),
                                 jnp.asarray(zs[1]), key, jnp.float32(beta))
    _assert_stats(ts, js, "Gmain")
    _assert_update_parity(params_from_jax(before), tst2["g_params"],
                          params_from_jax(_np_tree(jst["g_params"])), lr_g,
                          "Gmain")
    np.testing.assert_allclose(tst2["w_avg"].numpy(),
                               np.asarray(jst["w_avg"]), rtol=1e-5, atol=1e-6)
    if geometry:
        _assert_tree_close(tst2["g_ema"],
                           params_from_jax(_np_tree(jst["g_ema"])),
                           "Gmain ema")
    else:
        # In the skip model about one entry in 10^4 has a gradient within
        # float32 rounding of zero (|g| ~ 1e-7 against a median of 4e-4),
        # where Adam's ~lr * sign(g) step flips: the EMA (which started at
        # the parameters) is held to the update's own bounds.
        _assert_update_parity(params_from_jax(before), tst2["g_ema"],
                              params_from_jax(_np_tree(jst["g_ema"])),
                              lr_g * (1 - beta), "Gmain ema")
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
    if not geometry:
        return
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


class _Const:
    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        return self

    def __next__(self):
        return self.batch


def small_loop(tmp_path, name, **kw):
    m, _, tcfg = _train_cfgs(
        "bgc", noise_mode="random", style_mixing_prob=0.9, d_reg_interval=2,
        g_reg_interval=2, geom_interval=2, ada_interval=1,
        kimg_per_tick=B / 1000.0, **kw)
    rng = np.random.RandomState(4)
    style = rng.randint(0, 256, (B, RES, RES, 3)).astype(np.uint8)
    tri = rng.randint(0, 256, (B, RES + 8, RES + 8, 3)).astype(np.uint8)
    loop = TrainingLoop(tcfg, m["torch"]["enc_params"],
                        m["torch"]["enc_state"], _Const(style), _Const(tri),
                        run_dir=str(tmp_path / name), seed=5, device="cpu")
    return loop, tcfg


def read_stats(loop):
    with open(loop.stats_path) as f:
        return [json.loads(line) for line in f]
