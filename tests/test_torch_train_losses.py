"""The port's discriminator, loss DSL and Adam against the JAX package, on
the CPU, strict f32.

Small shapes: 32 px, <= 32 channels.  Tolerances: discriminator logits 1e-4
(f32 conv sums in another order, 4 blocks); every loss of the DSL 1e-5;
Adam 1e-7 abs on the parameters after three steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.models import discriminator as jdisc
from brushstroke_engine_tpu.train import losses as jlosses
from brushstroke_engine_tpu.train import state as jstate
from brushstroke_engine_torch.models import discriminator as tdisc
from brushstroke_engine_torch.train import losses as tlosses
from brushstroke_engine_torch.train import state as tstate
from brushstroke_engine_torch.utils.checkpoint import (
    init_native_params, params_from_jax,
)
from tests.torch_helpers import small_model
from tests.torch_train_helpers import (  # noqa: F401 (_strict: autouse)
    _strict, RES, B, _disc_cfgs,
)


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
    """The two LPIPS losses (ported since the name was given): they parse as
    in JAX and compute JAX's value, plpips on the patches JAX's key picks
    (item 0 draws from fold_in(key, 0): the first patch from it, the second
    from fold_in(.., 7); each (y, x) as ``random_patches`` draws them).
    Tolerance 1e-4 relative (the LPIPS convolutions; test_torch_metrics)."""
    fl = tlosses.ForgerLosses.create_from_string(spec)
    jl = jlosses.ForgerLosses.create_from_string(spec)
    assert tlosses.split_loss_string(spec) == jlosses.split_loss_string(spec)
    dd, truth = _debug_data()
    key = jax.random.PRNGKey(4)
    want, _ = jl.compute({k: jnp.asarray(v) for k, v in dd.items()},
                         jnp.asarray(truth), rng=key)
    sub = jax.random.fold_in(key, 0)
    crops = []
    for k in (sub, jax.random.fold_in(sub, 7)):
        crops += [int(jax.random.randint(k, (), 0, 16 - 4 + 1)),
                  int(jax.random.randint(jax.random.fold_in(k, 1), (), 0,
                                         16 - 4 + 1))]
    got, items = fl.compute({k: torch.from_numpy(v) for k, v in dd.items()},
                            torch.from_numpy(truth),
                            rng=_ReplayIntegers(crops))
    assert float(got) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-6)


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
