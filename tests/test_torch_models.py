"""Parity of the port's models against the JAX package on the CPU.

Weights are numpy trees in the JAX layout (``init_native_params``); the JAX
side takes them as they are, the port through ``params_from_jax``, and both
sides get the same numpy inputs.
JAX runs in strict f32, the port with TF32 off.  Tolerance 2e-5 abs on
outputs of unit scale (the RGB image in [-1, 1], uvs in [0, 1], features
after BatchNorm): f32 sums reordered over up to ~10 chained layers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.models import generator as jgen
from brushstroke_engine_tpu.models import geo_encoder as jenc
from brushstroke_engine_tpu.models import mapping as jmap
from brushstroke_engine_tpu.ops.precision import precision_mode
from brushstroke_engine_torch.models import generator as tgen
from brushstroke_engine_torch.models import geo_encoder as tenc
from brushstroke_engine_torch.models import mapping as tmap
from brushstroke_engine_torch.ops.precision import set_precision_mode
from brushstroke_engine_torch.utils.checkpoint import (
    init_native_params, params_from_jax,
)
from tests.torch_helpers import small_model

set_precision_mode("strict")

TOL = dict(rtol=1e-5, atol=2e-5)


@pytest.fixture(scope="module")
def bundle():
    return small_model()


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("psi,cutoff", [(1.0, None), (0.7, None), (0.5, 3)])
def test_mapping(bundle, psi, cutoff):
    rng = np.random.RandomState(1)
    z = rng.randn(3, 16).astype(np.float32)
    jcfg = bundle["jax_cfg"][0].mapping
    tcfg = bundle["cfg"][0].mapping
    w_avg = bundle["np"]["gen_state"]["w_avg"]
    with precision_mode("strict"):
        want, _ = jmap.mapping_apply(
            jcfg, bundle["jax"]["gen_params"]["mapping"], jnp.asarray(z),
            w_avg=jnp.asarray(w_avg), truncation_psi=psi,
            truncation_cutoff=cutoff)
    got = tmap.mapping_apply(tcfg, bundle["torch"]["gen_params"]["mapping"],
                             _t(z), w_avg=_t(w_avg), truncation_psi=psi,
                             truncation_cutoff=cutoff)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("neg_slope,decoder_pre_filters", [
    (None, -1), (0.2, -1), (None, 8)])
@pytest.mark.parametrize("res", [(0,), (0, 1), (2,)])
def test_geo_encoder(bundle, neg_slope, decoder_pre_filters, res):
    """Both layer orders and up-layer kinds (bilinear + conv, or the
    transposed conv of ``scale_up_v2``), with and without a decoder 'first'
    layer."""
    rng = np.random.RandomState(2)
    geom = (rng.rand(2, 32, 32, 1) > 0.4).astype(np.float32)
    kw = dict(neg_slope=neg_slope, decoder_pre_filters=decoder_pre_filters)
    jcfg = dataclasses.replace(bundle["jax_cfg"][1], **kw)
    tcfg = dataclasses.replace(bundle["cfg"][1], **kw)
    trees = init_native_params(bundle["cfg"][0], tcfg, seed=4)
    # Non-trivial BatchNorm statistics and affine.
    state = jax.tree_util.tree_map(
        lambda a: (a + rng.rand(*a.shape).astype(np.float32) * 0.5),
        trees["enc_state"])
    params = jax.tree_util.tree_map(
        lambda a: (a + rng.randn(*a.shape).astype(np.float32) * 0.1),
        trees["enc_params"])
    with precision_mode("strict"):
        want = jenc.geo_encoder_encode(
            jcfg, jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(geom),
            res=res)
    got = tenc.geo_encoder_encode(tcfg, params_from_jax(params),
                                  params_from_jax(state), _t(geom), res=res)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)


def _geom_features(bundle, rng, b):
    gen_cfg = bundle["cfg"][0]
    return [rng.randn(b, r, r, c).astype(np.float32) for r, c in zip(
        gen_cfg.synthesis.geom_feature_resolutions,
        gen_cfg.synthesis.geom_feature_channels)]


@pytest.mark.parametrize("style", ["z", "ws"])
@pytest.mark.parametrize("positions", [None, [[7, 90], [33, 2]]])
def test_generator(bundle, style, positions):
    rng = np.random.RandomState(3)
    gen_cfg = bundle["cfg"][0]
    feats = _geom_features(bundle, rng, 2)
    z = rng.randn(2, 16).astype(np.float32) if style == "z" else None
    ws = rng.randn(2, gen_cfg.num_ws, 16).astype(np.float32) \
        if style == "ws" else None
    with precision_mode("strict"):
        want, wdebug, _ = jgen.generator_apply(
            bundle["jax_cfg"][0], bundle["jax"]["gen_params"],
            bundle["jax"]["gen_state"], z=_j(z), ws=_j(ws),
            geom_features=[jnp.asarray(f) for f in feats],
            positions=_j(positions), truncation_psi=0.8,
            return_debug_data=True)
    got, debug = tgen.generator_apply(
        gen_cfg, bundle["torch"]["gen_params"], bundle["torch"]["gen_state"],
        z=_t(z), ws=_t(ws), geom_features=[_t(f) for f in feats],
        positions=None if positions is None else torch.tensor(positions),
        truncation_psi=0.8, return_debug_data=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("uvs", "colors", "ws"):
        np.testing.assert_allclose(debug[k].numpy(), np.asarray(wdebug[k]),
                                   **TOL)


def test_synthesis_features_and_blending(bundle):
    rng = np.random.RandomState(4)
    gen_cfg = bundle["cfg"][0]
    feats = _geom_features(bundle, rng, 2)
    ws = rng.randn(2, gen_cfg.num_ws, 16).astype(np.float32)
    noise_buffers = {"b16.conv1.noise_const":
                     rng.randn(16, 16).astype(np.float32)}
    ch = gen_cfg.synthesis.channels
    blended = {16: (rng.randn(2, 16, 16, ch(16)).astype(np.float32),
                    rng.rand(2, 16, 16, 1).astype(np.float32)),
               32: (rng.randn(2, 32, 32, ch(32)).astype(np.float32),
                    rng.rand(2, 32, 32, 1).astype(np.float32))}
    with precision_mode("strict"):
        want, wdebug, _ = jgen.generator_apply(
            bundle["jax_cfg"][0], bundle["jax"]["gen_params"],
            bundle["jax"]["gen_state"], ws=jnp.asarray(ws),
            geom_features=[jnp.asarray(f) for f in feats],
            noise_buffers={k: jnp.asarray(v)
                           for k, v in noise_buffers.items()},
            return_features=(16, 32),
            blended_features={r: (jnp.asarray(f), jnp.asarray(a))
                              for r, (f, a) in blended.items()})
    got, debug = tgen.generator_apply(
        gen_cfg, bundle["torch"]["gen_params"], bundle["torch"]["gen_state"],
        ws=_t(ws), geom_features=[_t(f) for f in feats],
        noise_buffers={k: _t(v) for k, v in noise_buffers.items()},
        return_features=(16, 32),
        blended_features={r: (_t(f), _t(a)) for r, (f, a) in blended.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for r in (16, 32):
        for k in (f"features{r}", f"features{r}_preblend"):
            np.testing.assert_allclose(debug[k].numpy(),
                                       np.asarray(wdebug[k]), rtol=1e-5,
                                       atol=1e-4)


def test_init_native_params_matches_jax_tree(bundle):
    """init_native_params builds the tree of the JAX package's own init:
    same keys, same shapes, f32, so it reaches the model through
    params_from_jax like a bundle does."""
    jgen_cfg, jenc_cfg = bundle["jax_cfg"]
    key = jax.random.PRNGKey(0)
    ref = dict(zip(("gen_params", "gen_state"), jax.eval_shape(
        lambda k: jgen.generator_init(jgen_cfg, k), key)))
    ref.update(zip(("enc_params", "enc_state"), jax.eval_shape(
        lambda k: jenc.geo_encoder_init(jenc_cfg, k), key)))
    trees = init_native_params(*bundle["cfg"], seed=0)
    for k, want in ref.items():
        got_leaves = jax.tree_util.tree_leaves_with_path(trees[k])
        want_leaves = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves], k
        for (p, g), (_, w) in zip(got_leaves, want_leaves):
            assert np.shape(g) == w.shape, (k, p)
            assert np.asarray(g).dtype == np.float32, (k, p)


def test_params_from_jax_layouts():
    rng = np.random.RandomState(5)
    tree = {"fc": {"weight": rng.randn(3, 5), "bias": rng.randn(5)},
            "conv": {"weight": rng.randn(3, 3, 4, 6)},
            "const": rng.randn(4, 4, 7),
            "noise": {"b8.conv0.noise_const": rng.randn(8, 8)}}
    out = params_from_jax(tree)
    np.testing.assert_array_equal(out["fc"]["weight"].numpy(),
                                  tree["fc"]["weight"].T.astype(np.float32))
    assert tuple(out["conv"]["weight"].shape) == (6, 4, 3, 3)
    np.testing.assert_array_equal(
        out["conv"]["weight"][5, 2, 0, 1].item(),
        np.float32(tree["conv"]["weight"][0, 1, 2, 5]))
    assert tuple(out["const"].shape) == (7, 4, 4)
    assert tuple(out["noise"]["b8.conv0.noise_const"].shape) == (8, 8)
    assert out["fc"]["bias"].dtype == torch.float32
