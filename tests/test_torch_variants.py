"""The model variants that reference checkpoints carry, the port against the
JAX package on the CPU: positional encodings (the tables, 'cat' injection in
'fixed' and 'varying' featuremap mode, and each 'add' case), the StyleGAN2
'orig' head on the 'skip' and 'orig' trunks, class-conditional mapping, the
conditional discriminator, and the 'conv' and 'sauto' geometry autoencoders
(encode, and the full forward in eval and in train BatchNorm with its
running stats).

Weights come from the port's ``init_native_params`` (numpy trees in the JAX
layout; their structure and shapes are checked against the JAX package's
own init), with every bias, noise gain and BatchNorm statistic made
non-zero.  JAX runs in strict f32, the port with TF32 off; TOL as in the
other parity tests (f32 sums reordered over up to ~10 chained layers).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.models import discriminator as jdisc
from brushstroke_engine_tpu.models import generator as jgen
from brushstroke_engine_tpu.models import geo_encoder as jenc
from brushstroke_engine_tpu.models import mapping as jmap
from brushstroke_engine_tpu.models import positional as jpos
from brushstroke_engine_tpu.ops.precision import precision_mode
from brushstroke_engine_torch.models import discriminator as tdisc
from brushstroke_engine_torch.models import generator as tgen
from brushstroke_engine_torch.models import geo_encoder as tenc
from brushstroke_engine_torch.models import mapping as tmap
from brushstroke_engine_torch.models import positional as tpos
from brushstroke_engine_torch.ops.precision import set_precision_mode
from brushstroke_engine_torch.utils.checkpoint import (
    init_encoder_trees, init_native_params, params_from_jax, params_to_jax,
)

set_precision_mode("strict")

TOL = dict(rtol=1e-5, atol=2e-5)
# The encoder drawn beside a generator or D that a test does not use.
SMALL_ENC = tenc.GeoEncoderConfig(pre_filters=2, down_filters=(2,),
                                  post_filters=(2,), up_filters=(2,))


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _shapes(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: tuple(tree.shape)}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _perturb(tree, rng, scale=0.2):
    """Non-zero biases, noise gains and BN stats (weights stay as drawn);
    running variances stay positive."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, scale)
        elif np.ndim(v) < 2 and k != "w_avg":
            d = np.asarray(scale * rng.randn(*np.shape(v)), np.float32)
            out[k] = (np.asarray(v) + (np.abs(d) if k == "var" else d)) \
                .astype(np.float32)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------

SPECS = ["grid", "sine:8", "simplesine"]


@pytest.mark.parametrize("spec", SPECS)
def test_positional_config_from_string(spec):
    j = jpos.PositionalEncoderConfig.from_string(spec, 64)
    t = tpos.PositionalEncoderConfig.from_string(spec, 64)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.out_channels == j.out_channels


@pytest.mark.parametrize("spec", SPECS)
def test_encode_xy(spec):
    cfg_j = jpos.PositionalEncoderConfig.from_string(spec, 64)
    cfg_t = tpos.PositionalEncoderConfig.from_string(spec, 64)
    x = np.array([0, 5, 63, 64, 130, -3], np.int32)
    y = np.array([7, 0, 31, 200, 1, 63], np.int32)
    want = jpos.encode_xy(cfg_j, jnp.asarray(x), jnp.asarray(y))
    got = tpos.encode_xy(cfg_t, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("spec", SPECS)
def test_encode_grid(spec):
    cfg_j = jpos.PositionalEncoderConfig.from_string(spec, 64)
    cfg_t = tpos.PositionalEncoderConfig.from_string(spec, 64)
    sx = np.array([3, 60], np.int32)
    sy = np.array([17, 0], np.int32)
    want = jpos.encode_grid(cfg_j, jnp.asarray(sx), jnp.asarray(sy), 8)
    got = tpos.encode_grid(cfg_t, torch.from_numpy(sx), torch.from_numpy(sy),
                           8)
    assert got.shape == (2, 8, 8, cfg_t.out_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# Generator variants
# ---------------------------------------------------------------------------

BASE = dict(z_dim=8, w_dim=8, img_resolution=32, channel_base=256,
            channel_max=16, mapping_layers=2)
GEOM = dict(geom_feature_resolutions=(8,), geom_feature_channels=(4,))
VARIANTS = {
    # 'cat' after the 8- and 16-px blocks, one encoding per patch.
    "posenc-cat-fixed": dict(**GEOM, positional_encoding="sine:8",
                             posenc_inject_resolutions=(1, 2)),
    "posenc-cat-varying": dict(**GEOM, positional_encoding="grid",
                               posenc_inject_resolutions=(1,),
                               posenc_featuremap_mode="varying"),
    # 'add': the encoding matches the trunk (16 ch), the geometry (4) or
    # both concatenated (20) after the 8-px block.
    "posenc-add-trunk": dict(**GEOM, positional_encoding="sine:16",
                             posenc_inject_resolutions=(1,),
                             posenc_injection_mode="add"),
    "posenc-add-geometry": dict(**GEOM, positional_encoding="sine:4",
                                posenc_inject_resolutions=(1,),
                                posenc_injection_mode="add"),
    "posenc-add-both": dict(**GEOM, positional_encoding="sine:20",
                            posenc_inject_resolutions=(1,),
                            posenc_injection_mode="add"),
    "orig-head-skip": dict(color_format="orig", architecture="skip"),
    "orig-head-orig": dict(color_format="orig", architecture="orig"),
    "c_dim-4": dict(**GEOM, c_dim=4),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    kw = VARIANTS[request.param]
    jcfg = jgen.make_generator_config(**BASE, **kw)
    tcfg = tgen.make_generator_config(**BASE, **kw)
    trees = init_native_params(tcfg, SMALL_ENC, seed=2)
    rng = np.random.RandomState(3)
    gp = _perturb(trees["gen_params"], rng)
    gs = dict(trees["gen_state"],
              w_avg=rng.randn(tcfg.w_dim).astype(np.float32))
    return {"name": request.param, "jcfg": jcfg, "tcfg": tcfg,
            "np": (gp, gs), "jax_init": jax.eval_shape(
                lambda: jgen.generator_init(jcfg, jax.random.PRNGKey(0)))}


def test_variant_config_equals_jax(variant):
    assert dataclasses.asdict(variant["tcfg"]) == dataclasses.asdict(
        variant["jcfg"])


def test_variant_init_has_the_jax_shapes(variant):
    jp, js = variant["jax_init"]
    gp, gs = variant["np"]
    assert _shapes(gp) == _shapes(jp)
    assert _shapes(gs["noise"]) == _shapes(js["noise"])


def test_variant_renders_as_jax(variant):
    jcfg, tcfg = variant["jcfg"], variant["tcfg"]
    gp, gs = variant["np"]
    rng = np.random.RandomState(4)
    b = 3
    z = rng.randn(b, 8).astype(np.float32)
    c = rng.randn(b, 4).astype(np.float32) if tcfg.c_dim else None
    geom = [rng.randn(b, 8, 8, 4).astype(np.float32)] \
        if tcfg.synthesis.geom_feature_resolutions else []
    positions = np.array([[5, 70], [301, 13], [0, 31]], np.int32)
    with precision_mode("strict"):
        want, jdebug, _ = jgen.generator_apply(
            jcfg, _jax(gp), _jax(gs), z=jnp.asarray(z),
            c=None if c is None else jnp.asarray(c),
            geom_features=[jnp.asarray(g) for g in geom],
            positions=jnp.asarray(positions), truncation_psi=0.8,
            noise_mode="const", return_debug_data=True)
    got, tdebug = tgen.generator_apply(
        tcfg, params_from_jax(gp), params_from_jax(gs), z=torch.from_numpy(z),
        c=None if c is None else torch.from_numpy(c),
        geom_features=[torch.from_numpy(g) for g in geom],
        positions=torch.from_numpy(positions), truncation_psi=0.8,
        noise_mode="const", return_debug_data=True)
    assert got.shape == (b, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sorted(tdebug) == sorted(jdebug)


def test_posenc_without_positions_draws_them_from_the_rng():
    cfg = tgen.make_generator_config(**BASE, positional_encoding="sine:8",
                                     posenc_inject_resolutions=(1,))
    trees = init_native_params(cfg, SMALL_ENC, seed=2)
    gp, gs = params_from_jax(trees["gen_params"]), \
        params_from_jax(trees["gen_state"])
    z = torch.randn(2, 8, generator=torch.Generator().manual_seed(0))
    imgs = [tgen.generator_apply(
        cfg, gp, gs, z=z, rng=torch.Generator().manual_seed(s))[0]
        for s in (1, 1, 2)]
    assert torch.equal(imgs[0], imgs[1]) and not torch.equal(imgs[0], imgs[2])
    with pytest.raises(ValueError, match="positions or an rng"):
        tgen.generator_apply(cfg, gp, gs, z=z)


def test_triad_head_still_requires_the_orig_trunk():
    with pytest.raises(AssertionError, match="orig"):
        tgen.make_generator_config(**BASE, color_format="triad",
                                   architecture="skip")


@pytest.mark.parametrize("z_dim", [8, 0])
def test_conditional_mapping(z_dim):
    kw = dict(z_dim=z_dim, c_dim=5, w_dim=8, num_ws=3, num_layers=2)
    jcfg, tcfg = jmap.MappingConfig(**kw), tmap.MappingConfig(**kw)
    assert tcfg.features_list == jcfg.features_list
    assert tcfg.embed_dim == jcfg.embed_dim == 8
    rng = np.random.RandomState(6)
    params = {f"fc{i}": {
        "weight": rng.randn(jcfg.features_list[i],
                            jcfg.features_list[i + 1]).astype(np.float32),
        "bias": rng.randn(jcfg.features_list[i + 1]).astype(np.float32)}
        for i in range(2)}
    params["embed"] = {"weight": rng.randn(5, 8).astype(np.float32),
                       "bias": rng.randn(8).astype(np.float32)}
    z = rng.randn(4, z_dim).astype(np.float32)
    c = rng.randn(4, 5).astype(np.float32)
    with precision_mode("strict"):
        want, _ = jmap.mapping_apply(jcfg, _jax(params), jnp.asarray(z),
                                     jnp.asarray(c))
    got = tmap.mapping_apply(tcfg, params_from_jax(params),
                             torch.from_numpy(z), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["orig", "resnet"])
def test_conditional_discriminator(arch):
    kw = dict(c_dim=3, img_resolution=32, img_channels=4, architecture=arch,
              channel_base=256, channel_max=16)
    jcfg, tcfg = jdisc.DiscriminatorConfig(**kw), \
        tdisc.DiscriminatorConfig(**kw)
    gcfg = tgen.make_generator_config(img_resolution=4, channel_max=1,
                                      mapping_layers=1)
    trees = init_native_params(gcfg, SMALL_ENC, seed=8,
                               disc_cfg=tcfg)
    dp = _perturb(trees["disc_params"], np.random.RandomState(9))
    assert _shapes(dp) == _shapes(jax.eval_shape(
        lambda: jdisc.discriminator_init(jcfg, jax.random.PRNGKey(0))))
    rng = np.random.RandomState(10)
    img = rng.randn(4, 32, 32, 4).astype(np.float32)
    c = rng.randn(4, 3).astype(np.float32)
    with precision_mode("strict"):
        want = jdisc.discriminator_apply(jcfg, _jax(dp), jnp.asarray(img),
                                         jnp.asarray(c))
    got = tdisc.discriminator_apply(tcfg, params_from_jax(dp),
                                    torch.from_numpy(img),
                                    torch.from_numpy(c))
    assert got.shape == (4, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# Geometry autoencoders
# ---------------------------------------------------------------------------

ENCODERS = {
    "conv": dict(kind="conv", preproc="-11inverse", img_width=32,
                 emb_channel=4, channel_factor=2, num_layers=2),
    "conv-3ch": dict(kind="conv", out_channels=3, preproc="none",
                     img_width=32, emb_channel=3, channel_factor=2,
                     num_layers=3),
    "sauto-legacy": dict(kind="sauto", preproc="-11inverse", pre_filters=4,
                         down_filters=(8, 8), post_filters=(6,),
                         up_filters=(8, 4)),
    "sauto-v2": dict(kind="sauto", preproc="inverse", pre_filters=4,
                     down_filters=(8, 8), post_filters=(6,),
                     up_filters=(8, 4), decoder_pre_filters=5,
                     neg_slope=0.2, out_channels=3),
}


@pytest.fixture(scope="module", params=sorted(ENCODERS))
def encoder(request):
    kw = ENCODERS[request.param]
    jcfg, tcfg = jenc.GeoEncoderConfig(**kw), tenc.GeoEncoderConfig(**kw)
    params, state = init_encoder_trees(tcfg, seed=11)
    rng = np.random.RandomState(12)
    params, state = _perturb(params, rng), _perturb(state, rng)
    geom = (np.random.RandomState(13).rand(4, 32, 32, 1) > 0.4) \
        .astype(np.float32)
    return {"name": request.param, "jcfg": jcfg, "tcfg": tcfg,
            "np": (params, state), "geom": geom,
            "jax_init": jax.eval_shape(
                lambda: jenc.geo_encoder_init(jcfg, jax.random.PRNGKey(0)))}


def test_encoder_init_has_the_jax_shapes(encoder):
    jp, js = encoder["jax_init"]
    params, state = encoder["np"]
    assert _shapes(params) == _shapes(jp)
    assert _shapes(state) == _shapes(js)


def test_encoder_encode(encoder):
    jcfg, tcfg = encoder["jcfg"], encoder["tcfg"]
    params, state = encoder["np"]
    res = [0] if tcfg.kind == "conv" else [0, 1, 2]
    with precision_mode("strict"):
        want = jenc.geo_encoder_encode(jcfg, _jax(params), _jax(state),
                                       jnp.asarray(encoder["geom"]), res=res)
    got = tenc.geo_encoder_encode(tcfg, params_from_jax(params),
                                  params_from_jax(state),
                                  torch.from_numpy(encoder["geom"]), res=res)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_encoder_full_forward_and_running_stats(encoder, train):
    jcfg, tcfg = encoder["jcfg"], encoder["tcfg"]
    params, state = encoder["np"]
    with precision_mode("strict"):
        want, jstate = jenc.geo_encoder_apply(
            jcfg, _jax(params), _jax(state), jnp.asarray(encoder["geom"]),
            train=train)
    got, tstate = tenc.geo_encoder_apply(
        tcfg, params_from_jax(params), params_from_jax(state),
        torch.from_numpy(encoder["geom"]), train=train)
    assert got.shape == want.shape == (4, 32, 32, tcfg.out_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jflat, tflat = _flat(jax.tree_util.tree_map(np.asarray, jstate)), \
        _flat(params_to_jax(tstate))
    assert sorted(tflat) == sorted(jflat)
    for k in jflat:
        np.testing.assert_allclose(tflat[k], jflat[k], **TOL, err_msg=k)
    if train:      # the running stats moved
        before = _flat(state)
        assert any(not np.array_equal(tflat[k], before[k]) for k in tflat)
    for fn in ("postprocess", "postprocess_partial"):
        np.testing.assert_allclose(
            getattr(tenc, fn)(tcfg, got).numpy(),
            np.asarray(getattr(jenc, fn)(jcfg, want)), **TOL, err_msg=fn)
    np.testing.assert_array_equal(
        tenc.preprocess_truth(tcfg, torch.from_numpy(encoder["geom"])).numpy(),
        np.asarray(jenc.preprocess_truth(jcfg, jnp.asarray(encoder["geom"]))))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def test_conv_encoder_has_the_bottleneck_only():
    cfg = tenc.GeoEncoderConfig(**ENCODERS["conv"])
    params, state = map(params_from_jax, init_encoder_trees(cfg, seed=1))
    geom = torch.ones(1, 32, 32, 1)
    (feat,) = tenc.geo_encoder_encode(cfg, params, state, geom, res=[0])
    assert feat.shape == (1, 8, 8, 4)
    with pytest.raises(ValueError, match="bottleneck"):
        tenc.geo_encoder_encode(cfg, params, state, geom, res=[0, 1])
