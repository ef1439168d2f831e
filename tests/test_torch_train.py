"""The port's training path against the JAX package, on the CPU, strict f32.

Small shapes: 32 px, B = 4, <= 32 channels, ``noise_mode="const"``, style
mixing 0, explicit path-length noise, so both packages consume the same
numbers.  Where the JAX step draws from its key (ADA, path-length noise) the
test replays the key's splits and hands the port the same draws.

Tolerances:
  * discriminator logits 1e-4 (f32 conv sums in another order, 4 blocks);
  * every loss of the DSL 1e-5;
  * phase stats 1e-4 relative (+1e-5 abs), ``pl_mean`` 1e-4 relative;
  * parameter updates by the method of ``tests/test_reference_parity.py``:
    with beta1 = 0 one Adam step is ~lr * sign(g), so per tensor the mean
    |delta_port - delta_jax| must stay under 2 % of the step size and 99 % of
    the entries under 10 %; a tensor one side freezes must be exactly
    untouched on the other.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.models import discriminator as jdisc
from brushstroke_engine_tpu.ops.precision import set_precision_mode as jset
from brushstroke_engine_tpu.train import augment as jaug
from brushstroke_engine_tpu.train import losses as jlosses
from brushstroke_engine_tpu.train import state as jstate
from brushstroke_engine_tpu.train import steps as jsteps
from brushstroke_engine_torch.models import discriminator as tdisc
from brushstroke_engine_torch.ops import fir_epilogue as fe
from brushstroke_engine_torch.ops.filters import setup_filter
from brushstroke_engine_torch.ops.precision import set_precision_mode as tset
from brushstroke_engine_torch.train import augment as taug
from brushstroke_engine_torch.train import losses as tlosses
from brushstroke_engine_torch.train import state as tstate
from brushstroke_engine_torch.train import steps as tsteps
from brushstroke_engine_torch.train.loop import TrainingLoop
from brushstroke_engine_torch.utils.checkpoint import (
    init_native_params, params_from_jax, train_state_from_jax,
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


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["orig", "resnet"])
def test_discriminator_matches_jax(arch):
    jcfg, tcfg = _disc_cfgs(arch)
    m = small_model(seed=1)
    trees = init_native_params(*m["cfg"], seed=4, disc_cfg=tcfg)
    d_np = trees["disc_params"]
    # Shapes of the numpy init are those of the JAX init.
    want_shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jdisc.discriminator_init(jcfg,
                                                    jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_map(lambda a: a.shape, d_np) == want_shapes
    # The other trees do not depend on the discriminator's draws.
    base = init_native_params(*m["cfg"], seed=4)
    for a, b in zip(jax.tree_util.tree_leaves(base["gen_params"]),
                    jax.tree_util.tree_leaves(trees["gen_params"])):
        np.testing.assert_array_equal(a, b)

    img = np.random.RandomState(2).randn(B, RES, RES, 3).astype(np.float32)
    want = jdisc.discriminator_apply(
        jcfg, jax.tree_util.tree_map(jnp.asarray, d_np), jnp.asarray(img))
    got = tdisc.discriminator_apply(tcfg, params_from_jax(d_np),
                                    torch.from_numpy(img))
    assert got.shape == (B, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_minibatch_stddev_matches_jax():
    x = np.random.RandomState(3).randn(8, 4, 4, 6).astype(np.float32)
    want = jdisc._minibatch_stddev(jnp.asarray(x), 4, 2)
    got = tdisc._minibatch_stddev(torch.from_numpy(x), 4, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_conditional_discriminator_raises():
    _, tcfg = _disc_cfgs(c_dim=3)
    with pytest.raises(NotImplementedError):
        tdisc.discriminator_apply(tcfg, {}, torch.zeros(1, RES, RES, 3))


# ---------------------------------------------------------------------------
# Loss DSL
# ---------------------------------------------------------------------------

def _debug_data(seed=0, batch=3, res=16):
    rng = np.random.RandomState(seed)
    logits = rng.randn(batch, res, res, 3).astype(np.float32)
    uvs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)

    def img():
        return rng.randn(batch, res, res, 3).astype(np.float32)

    dd = {"uvs": uvs,
          "colors": np.tanh(rng.randn(batch, 3, 3)).astype(np.float32),
          "canvas": img(),
          "alpha": uvs[..., :2] / uvs[..., :2].sum(-1, keepdims=True),
          "fake_img": img(), "fake_orig": img(), "fake": img(),
          "fake_composite": img(), "patch1": img(), "patch2": img(),
          "fake_logits": rng.randn(batch, 1).astype(np.float32)}
    # Triband truth: 1 = BG, 0 = FG, a gray band in between.
    truth = rng.choice([0.0, 0.03, 0.5, 0.95, 1.0],
                       size=(batch, res, res, 1)).astype(np.float32)
    return dd, truth


class _ReplayIntegers:
    """Stands in for the host generator of the port's crop draws with the
    offsets the JAX loss drew from its key."""

    def __init__(self, values):
        self.values = list(values)

    def integers(self, low, high):
        v = self.values.pop(0)
        assert low <= v < high
        return v


LOSS_STRINGS = [
    "1.0*rgb(canvas)", "2.0*rgb(color_0,r=0.1,g=0.9,b=0.3,loss=L2)",
    "1.0*rgb(uvs,mean_rgb=1)", "1.0*hsv(color_1,v=0.8,s=0.4)",
    "1.0*hsv(canvas,s=0.2,loss=L1)",
    "1.0*iou(uvs)", "1.0*iou(u)", "0.5*iou(alpha)", "1.0*iou_inv(uvs)",
    "1.0*iou_inv(alpha)", "1.0*dice(u)", "1.0*dice_inv(uvs)",
    "1.0*l1(u)", "1.0*l1(fake_img)", "3.0*l1(fake_orig)",
    "1.0*l1(fake_composite)", "1.0*l1(patch)", "1.0*l1(canvas)",
    "1.0*gan(fake)", "1.0*bce(u)", "1.0*bgstd(uvs)", "1.0*bgl2(uvs)",
    "1.0*fgl4gt(uvs)",
    "0.5*iou_inv(uvs)+0.5*iou(u)+50*l1(fake_orig)",
]


@pytest.mark.parametrize("triband", [True, False])
@pytest.mark.parametrize("spec", LOSS_STRINGS)
def test_losses_match_jax(spec, triband):
    dd, truth = _debug_data()
    jl = jlosses.ForgerLosses.create_from_string(spec)
    tl = tlosses.ForgerLosses.create_from_string(spec)
    jl.set_partial_loss_with_triband_input(triband)
    tl.set_partial_loss_with_triband_input(triband)
    assert tl.summary() == jl.summary()
    assert tl.require_original_fake_image() == \
        jl.require_original_fake_image()
    key = jax.random.PRNGKey(9)
    want, want_items = jl.compute(
        {k: jnp.asarray(v) for k, v in dd.items()}, jnp.asarray(truth),
        rng=key)
    # l1(canvas) crops: item i draws from fold_in(key, i); target (y, x),
    # then the source crop from fold_in(.., 3).
    crops = []
    for i, item in enumerate(jl.items):
        if item.name == "l1" and item.component == "canvas":
            sub = jax.random.fold_in(key, i)
            for k in (sub, jax.random.fold_in(sub, 3)):
                crops.append(int(jax.random.randint(k, (), 0, 16 - 4 + 1)))
                crops.append(int(jax.random.randint(
                    jax.random.fold_in(k, 1), (), 0, 16 - 4 + 1)))
    got, got_items = tl.compute(
        {k: torch.from_numpy(v) for k, v in dd.items()},
        torch.from_numpy(truth), rng=_ReplayIntegers(crops))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
    assert set(got_items) == set(want_items)
    for k in want_items:
        np.testing.assert_allclose(float(got_items[k]), float(want_items[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("spec", ["0.5*lpips(fake_orig)", "1.0*plpips(canvas)"])
def test_lpips_losses_parse_but_are_not_ported(spec):
    fl = tlosses.ForgerLosses.create_from_string(spec)
    assert tlosses.split_loss_string(spec) == jlosses.split_loss_string(spec)
    dd, truth = _debug_data()
    with pytest.raises(NotImplementedError, match="metrics/lpips.py"):
        fl.compute({k: torch.from_numpy(v) for k, v in dd.items()},
                   torch.from_numpy(truth))


@pytest.mark.parametrize("bad", ["1.0*nope(uvs)", "1.0*iou(wrong)",
                                 "1*2*iou(u)", "iou", "1.0*iou(u)+2.0*iou(u)",
                                 "1.0*rgb(canvas,r=1,r=2)"])
def test_loss_strings_are_rejected_as_in_jax(bad):
    with pytest.raises((ValueError, AssertionError)):
        jlosses.ForgerLosses.create_from_string(bad)
    with pytest.raises(ValueError):
        tlosses.ForgerLosses.create_from_string(bad)


# ---------------------------------------------------------------------------
# Adam, state conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("interval", [None, 4, 16])
def test_lazy_adam_matches_optax(interval):
    """Three steps on injected gradients of mixed magnitude (O(1), 1e-4,
    near eps, zero): the port's Adam equals ``optax.adam`` to 1e-7."""
    import optax
    rng = np.random.RandomState(50)
    p0 = rng.randn(64).astype(np.float32)
    scales = np.concatenate([np.ones(16), 1e-4 * np.ones(16),
                             1e-8 * np.ones(16), np.zeros(16)])
    grads = [(rng.randn(64) * scales).astype(np.float32) for _ in range(3)]
    jopt = jstate.lazy_adam(2e-4, 0.0, 0.99, 1e-8, interval)
    topt = tstate.lazy_adam(2e-4, 0.0, 0.99, 1e-8, interval)
    pj, sj = jnp.asarray(p0), None
    pt = {"w": torch.from_numpy(p0.copy())}
    sj, st = jopt.init(pj), topt.init(pt)
    for g in grads:
        upd, sj = jopt.update(jnp.asarray(g), sj, pj)
        pj = optax.apply_updates(pj, upd)
        upd_t, st = topt.update({"w": torch.from_numpy(g.copy())}, st)
        pt = {"w": pt["w"] + upd_t["w"]}
    assert st["count"] == 3
    np.testing.assert_allclose(pt["w"].numpy(), np.asarray(pj), rtol=0,
                               atol=1e-7)


def _train_cfgs(augment=None, **kw):
    m = small_model(seed=3)
    jd, td = _disc_cfgs("orig", **kw.pop("disc", {}))
    common = dict(enc_res=(0, 1), batch_size=B, noise_mode="const",
                  style_mixing_prob=0.0, r1_gamma=10.0,
                  main_phase_losses="0.1*iou_inv(uvs)",
                  geom_phase_mode="last_and_rgb")
    common.update(kw)
    jcfg = jstate.TrainConfig(
        gen_cfg=m["jax_cfg"][0], disc_cfg=jd, enc_cfg=m["jax_cfg"][1],
        augment=None if augment is None
        else jaug.AugmentConfig.from_spec(augment), **common)
    tcfg = tstate.TrainConfig(
        gen_cfg=m["cfg"][0], disc_cfg=td, enc_cfg=m["cfg"][1],
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


def test_train_state_from_jax_round_trip():
    """A JAX train state after one Dmain and one Gmain step (non-zero Adam
    moments) converts leaf by leaf with the layout rules, and the converted
    trees drive the port's networks to the JAX package's outputs."""
    m, jcfg, tcfg = _train_cfgs()
    real, geom, truth, zs = _batch(1)
    state = _jax_state(m, jcfg)
    feats = jsteps.encode_geometry(jcfg, m["jax"]["enc_params"],
                                   m["jax"]["enc_state"], jnp.asarray(geom))
    state, _ = jsteps.d_main_step(jcfg, state, jnp.asarray(real), feats,
                                  jnp.asarray(zs[0]), jax.random.PRNGKey(1))
    state, _ = jsteps.g_main_step(jcfg, state, feats, jnp.asarray(truth),
                                  jnp.asarray(zs[1]), jax.random.PRNGKey(2),
                                  jnp.float32(0.5))
    snap = _np_tree(state)
    got = train_state_from_jax(snap, device="cpu")

    assert set(got) == set(snap)
    for k in ("g_opt", "d_opt"):
        assert got[k]["count"] == 1 and isinstance(got[k]["count"], int)
    assert got["geom_opt"]["count"] == 0
    for k in ("g_params", "d_params", "g_ema", "noise"):
        want = params_from_jax(snap[k])
        for a, b in zip(tree_leaves(got[k]), tree_leaves(want)):
            assert torch.equal(a, b)
    adam = state["d_opt"][0]
    for name in ("mu", "nu"):
        want = params_from_jax(_np_tree(getattr(adam, name)))
        for a, b, p in zip(tree_leaves(got["d_opt"][name]),
                           tree_leaves(want), tree_leaves(got["d_params"])):
            assert torch.equal(a, b) and a.shape == p.shape
    assert float(got["d_opt"]["nu"]["b4"]["fc"]["weight"].abs().sum()) > 0
    # b4.fc: only the [in, out] -> [out, in] transpose (both flatten NHWC).
    np.testing.assert_array_equal(
        got["d_params"]["b4"]["fc"]["weight"].numpy(),
        snap["d_params"]["b4"]["fc"]["weight"].T)
    for k in ("w_avg", "pl_mean", "ada_p", "ada_signs", "ada_count"):
        np.testing.assert_array_equal(got[k].numpy(), snap[k])
    img = np.random.RandomState(5).randn(B, RES, RES, 3).astype(np.float32)
    np.testing.assert_allclose(
        tdisc.discriminator_apply(tcfg.disc_cfg, got["d_params"],
                                  torch.from_numpy(img)).numpy(),
        np.asarray(jdisc.discriminator_apply(jcfg.disc_cfg,
                                             state["d_params"],
                                             jnp.asarray(img))),
        rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# One full phase cycle through both packages
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# The FIR-epilogue kernel's backward, with the launch stood in for
# ---------------------------------------------------------------------------

def test_fir_epilogue_function_backward_and_double_backward(monkeypatch):
    """``_Fir4EpilogueFn`` wraps a launch whose result has no history.  With
    the launch replaced by the (detached) plain version on the CPU, its
    first and second derivatives must equal autograd through
    ``fir4_epilogue_plain``: before the repair the kernel path returned a
    tensor without ``grad_fn`` and every ``conv0`` layer cut the gradient."""
    def fake_launch(x, taps, d, noise, bias, act_gain, clamp, alpha, dt):
        return fe.fir4_epilogue_plain(x, taps, d, noise, bias, act_gain,
                                      clamp, alpha, dt).detach()

    monkeypatch.setattr(fe, "_launch_kernel", fake_launch)
    rng = np.random.RandomState(0)
    b, h, c = 2, 6, 5
    taps = fe.correlation_taps(setup_filter([1, 3, 3, 1]))

    def leaves():
        rs = np.random.RandomState(1)
        return [torch.from_numpy(a.astype(np.float32)).requires_grad_(True)
                for a in (rs.randn(b, h + 3, h + 3, c), rs.rand(b, c) + 0.5,
                          rs.randn(b, h, h, 1), rs.randn(c))]

    cot = torch.from_numpy(rng.randn(b, h, h, c).astype(np.float32))
    results = []
    for use_fn in (True, False):
        x, d, noise, bias = leaves()
        # A non-linear pre-map so second derivatives are not trivially 0.
        xin = torch.tanh(x) * 3
        if use_fn:
            y = fe._Fir4EpilogueFn.apply(xin, d, noise, bias, taps, 1.4, 2.0,
                                         0.2, torch.float32)
            assert y.grad_fn is not None
        else:
            y = fe.fir4_epilogue_plain(xin, taps, d, noise, bias, 1.4, 2.0,
                                       0.2, torch.float32)
        g1 = torch.autograd.grad((y * cot).sum(), [x, d, noise, bias],
                                 create_graph=True)
        penalty = sum(g.square().sum() for g in g1)
        g2 = torch.autograd.grad(penalty, [x, d, noise, bias],
                                 allow_unused=True)
        results.append((y.detach(), g1, g2))
    (y_a, g1_a, g2_a), (y_b, g1_b, g2_b) = results
    torch.testing.assert_close(y_a, y_b, rtol=0, atol=0)
    for a, b_ in zip(g1_a, g1_b):
        torch.testing.assert_close(a.detach(), b_.detach(), rtol=1e-6,
                                   atol=1e-6)
    for a, b_ in zip(g2_a, g2_b):
        assert (a is None) == (b_ is None)
        if a is not None:
            torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)
    assert g2_a[0] is not None and g2_a[0].abs().max() > 0
    # Under no_grad nothing is recorded.
    with torch.no_grad():
        x, d, noise, bias = leaves()
        y = fe._Fir4EpilogueFn.apply(x, d, noise, bias, taps, 1.4, 2.0, 0.2,
                                     torch.float32)
    assert y.grad_fn is None and not y.requires_grad


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

class _Const:
    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        return self

    def __next__(self):
        return self.batch


def _loop(tmp_path, name, **kw):
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


def _read_stats(loop):
    with open(loop.stats_path) as f:
        return [json.loads(line) for line in f]


def test_training_loop_three_batches_on_cpu(tmp_path):
    loop, cfg = _loop(tmp_path, "a", geom_warmstart_kimg=0)
    p0 = [t.clone() for t in tree_leaves(loop.state["g_params"])]
    d0 = [t.clone() for t in tree_leaves(loop.state["d_params"])]
    ticks = []
    loop.run(total_kimg=3 * B / 1000.0,
             progress_fn=lambda cur, total: ticks.append(cur))
    assert loop.batch_idx == 3 and loop.cur_nimg == 3 * B
    assert ticks == [0, B, 2 * B, 3 * B]
    rows = _read_stats(loop)
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
    loop2, _ = _loop(tmp_path, "b", geom_warmstart_kimg=0)
    loop2.run(total_kimg=3 * B / 1000.0)
    for a, b in zip(tree_leaves(loop.state["g_params"]),
                    tree_leaves(loop2.state["g_params"])):
        assert torch.equal(a, b)


def test_training_loop_warm_start_and_unported_options(tmp_path):
    loop, cfg = _loop(tmp_path, "w", geom_warmstart_kimg=2 * B / 1000.0)
    assert loop.in_warmstart()
    d0 = [t.clone() for t in tree_leaves(loop.state["d_params"])]
    loop.run(total_kimg=1.0, exit_after_warmstart=True)
    assert loop.batch_idx == 2 and not loop.in_warmstart()
    rows = _read_stats(loop)
    assert all("Loss/forger/Ggeom-warm/total" in r for r in rows)
    assert all("Loss/D/loss" not in r for r in rows)
    for a, b in zip(d0, tree_leaves(loop.state["d_params"])):
        assert torch.equal(a, b)
    assert loop.state["geom_opt"]["count"] == 2
    for method in (loop.save_snapshot, loop.save_train_state,
                   loop.load_train_state):
        with pytest.raises(NotImplementedError):
            method()
    # No ramp-up in this configuration: beta follows the half-life.
    assert loop._ema_beta() == pytest.approx(
        0.5 ** (B / (cfg.ema_kimg * 1000.0)), rel=1e-6)

    for kw in (dict(use_fused=True), dict(device_banks=object()),
               dict(steps_per_dispatch=4), dict(mesh=object()),
               dict(profile_dir="x"), dict(auto_resume=True)):
        with pytest.raises(NotImplementedError):
            TrainingLoop(cfg, {}, {}, None, None, run_dir=str(tmp_path / "n"),
                         device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="stitch"):
        TrainingLoop(dataclasses.replace(
            cfg, stitch_interval=4, stitch_phase_losses="1.0*l1(patch)"),
            {}, {}, None, None, run_dir=str(tmp_path / "n"), device="cpu")


def test_training_loop_needs_cuda_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, cfg = _train_cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainingLoop(cfg, {}, {}, None, None, run_dir=str(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tstate.init_train_state(cfg)
