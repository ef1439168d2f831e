"""The port's autoencoder trainer and its CLIs against the JAX package on the
CPU: the balanced BCE, three Adam steps with BatchNorm on batch statistics
('sauto', 'conv' and a 3-channel decoder) on crops drawn from the same
``default_rng``, checkpoints each package writes and the other reads,
``tools/train_autoencoder.py``, ``tools/train.py --encoder_checkpt`` with the
positional-encoding flags against ``scripts/train_main.py:setup_config``,
and the encoder reconstruction sheet.

Tolerances: the parameters after 3 steps within 1e-4 of each tensor's
largest entry plus 1e-4 of the 3 lr that three Adam steps can move an entry
(f32 sums reordered through the forward and backward passes; for the biases
and BN parameters, which start at 0 or 1, those steps are the whole change).
The one exception is a conv bias that feeds BatchNorm directly (the legacy
'sauto' layers: conv -> BN -> act): BN subtracts the batch mean, so its
gradient is zero up to rounding, and Adam, which moves every weight by about
the learning rate whatever the gradient's size, turns that rounding into
+-lr steps; both packages hold such a bias within 3 lr of its start, and
the running mean of the BN it feeds, which moves by 0.1 of the batch mean,
within 0.1 x (3 steps x 2 lr) more than the tolerance.  The
loss within 1e-5 relative of the same loss summed in
float64 over the JAX package's forward (``geo_encoder_apply`` in train mode,
as its step runs it): the JAX step's own loss sums 4096 weighted f32 terms
and lands up to 2.2e-5 relative off that float64 sum (0.80386788 against
0.80388562 at the first 'conv' step), so it is held within 5e-5.
"""

import argparse
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.models import geo_encoder as jenc
from brushstroke_engine_tpu.ops.precision import precision_mode
from brushstroke_engine_tpu.train import train_autoencoder as jae
from brushstroke_engine_tpu.viz import visualize as jviz
from brushstroke_engine_torch.models import geo_encoder as tenc
from brushstroke_engine_torch.ops.precision import set_precision_mode
from brushstroke_engine_torch.tools import train as ttrain
from brushstroke_engine_torch.tools import train_autoencoder as ttae
from brushstroke_engine_torch.train import train_autoencoder as tae
from brushstroke_engine_torch.utils.checkpoint import (
    init_encoder_trees, params_from_jax, params_to_jax,
)
from brushstroke_engine_torch.viz import visualize as tviz
from tests.test_checkpoint_parity import ENC_ARGS, TorchGoldenEncoder
from tests.test_torch_train_cli import _flags, _jax_cli

set_precision_mode("strict")

TOL = dict(rtol=1e-5, atol=2e-5)
ENCODERS = {
    "sauto": dict(kind="sauto", preproc="-11inverse", pre_filters=4,
                  down_filters=(8, 8), post_filters=(6,), up_filters=(8, 4)),
    "sauto-v2-3ch": dict(kind="sauto", preproc="-11inverse", pre_filters=4,
                         down_filters=(8,), post_filters=(6,),
                         up_filters=(4,), neg_slope=0.2, out_channels=3),
    "conv": dict(kind="conv", preproc="-11inverse", img_width=32,
                 emb_channel=4, channel_factor=2, num_layers=2),
}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _tri_batches(n, b=4, size=40, seed=0):
    """Triband uint8 batches: noise in R, random strokes as 0 in G and B."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tri = np.full((b, size, size, 3), 255, np.uint8)
        tri[..., 0] = rng.randint(0, 256, (b, size, size))
        mask = rng.rand(b, size, size) < 0.3
        tri[..., 1][mask] = 0
        tri[..., 2][mask | (rng.rand(b, size, size) < 0.05)] = 0
        out.append(tri)
    return out


@pytest.mark.parametrize("weights", [False, True])
def test_bce_with_logits(weights):
    rng = np.random.RandomState(1)
    logits = (3 * rng.randn(2, 8, 8, 1)).astype(np.float32)
    target = (rng.rand(2, 8, 8, 1) > 0.5).astype(np.float32)
    w = rng.rand(2, 8, 8, 1).astype(np.float32) if weights else None
    want = jae.bce_with_logits(jnp.asarray(logits), jnp.asarray(target),
                               None if w is None else jnp.asarray(w))
    got = tae.bce_with_logits(torch.from_numpy(logits),
                              torch.from_numpy(target),
                              None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _loss64(cfg, params, state, tri):
    """The AE loss of the JAX package's train-mode forward, summed in
    float64."""
    enc = cfg.enc_cfg
    logits, _ = jax.jit(lambda p, s, x: jenc.geo_encoder_apply(
        enc, p, s, x, train=True, preprocess_input=False))(
        params, state, jenc.preprocess(enc, jnp.asarray(tri[..., 1:2])))
    y = np.asarray(logits, np.float64)
    t = np.asarray(jenc.preprocess_truth(enc, jnp.asarray(tri[..., 2:3])),
                   np.float64)
    if enc.out_channels == 3:
        labels = (t[..., 0] > 0.5).astype(int) * 2
        logp = y - y.max(-1, keepdims=True)
        logp -= np.log(np.exp(logp).sum(-1, keepdims=True))
        return float(-np.take_along_axis(logp, labels[..., None], -1).mean())
    y = y + 0.5
    fg = (t < 0.5).astype(np.float64)
    w = fg / max(fg.sum(), 1) + (1 - fg) / max((1 - fg).sum(), 1)
    loss = np.maximum(y, 0) - y * t + np.log1p(np.exp(-np.abs(y)))
    return float((loss * w).sum() / max(w.sum(), 1))


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_three_ae_steps_as_jax(name):
    kw = ENCODERS[name]
    jcfg = jae.AETrainConfig(enc_cfg=jenc.GeoEncoderConfig(**kw),
                             widths=(32,))
    tcfg = tae.AETrainConfig(enc_cfg=tenc.GeoEncoderConfig(**kw),
                             widths=(32,))
    # The same weights in both packages: numpy draws with the shapes and
    # distributions of the JAX package's geo_encoder_init.
    jp, js = init_encoder_trees(tcfg.enc_cfg, seed=4)
    tp, ts = params_from_jax(jp), params_from_jax(js)
    start_params = tp
    jstep, jopt = jae.make_ae_train_step(jcfg)
    tstep, topt = tae.make_ae_train_step(tcfg)
    jp, js = jax.tree_util.tree_map(jnp.asarray, (jp, js))
    jo, to = jopt.init(jp), topt.init(tp)
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    for tri in _tri_batches(3):
        tri = tri.astype(np.float32) / 255.0
        jtri = jae.random_crop_batch(tri, 32, jrng)
        ttri = tae.random_crop_batch(tri, 32, trng)
        np.testing.assert_array_equal(ttri, jtri)
        with precision_mode("strict"):
            want = _loss64(jcfg, jp, js, jtri)
            jp, js, jo, jloss = jstep(jp, js, jo, jnp.asarray(jtri[..., 1:2]),
                                      jnp.asarray(jtri[..., 2:3]))
        ttri = torch.from_numpy(np.ascontiguousarray(ttri))
        tp, ts, to, tloss = tstep(tp, ts, to, ttri[..., 1:2], ttri[..., 2:3])
        np.testing.assert_allclose(tloss.item(), want, rtol=1e-5)
        np.testing.assert_allclose(float(jloss), want, rtol=5e-5)
    noise_only = _biases_before_bn(tcfg.enc_cfg)
    start = _flat(params_to_jax(start_params))
    for tree_t, tree_j in ((tp, jp), (ts, js)):
        got, want = _flat(params_to_jax(tree_t)), _flat(
            jax.tree_util.tree_map(np.asarray, tree_j))
        assert sorted(got) == sorted(want)
        for k in want:
            if k in noise_only:
                for moved in (got[k], want[k]):
                    assert np.abs(moved - start[k]).max() <= \
                        3 * tcfg.learning_rate * (1 + 1e-5), k
                continue
            err = np.abs(got[k] - want[k]).max()
            slack = 0.1 * 3 * 2 * tcfg.learning_rate \
                if k.replace("bn/mean", "conv/bias") in noise_only else 0.0
            assert err <= 1e-4 * (np.abs(want[k]).max()
                                  + 3 * tcfg.learning_rate) + slack, (k, err)


def _biases_before_bn(enc):
    """Conv biases that BatchNorm follows directly (conv -> BN -> act): the
    legacy 'sauto' encoder layers and bilinear ScaleUp decoder layers."""
    if enc.kind != "sauto" or enc.batchnorm_after_activation:
        return set()
    n_enc = (1 if enc.pre_filters > 0 else 0) + len(enc.down_filters) \
        + len(enc.post_filters)
    return {f"encoder/layer{i}/conv/bias" for i in range(n_enc)} | \
        {f"decoder/up{i}/conv/bias" for i in range(len(enc.up_filters))}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``tools/train_autoencoder.py`` on the CPU: a small 'sauto' encoder,
    4 steps at batch 2 on synthetic geometry."""
    run = str(tmp_path_factory.mktemp("ae"))
    params, state, losses = ttae.main([
        "--run_dir", run, "--device", "cpu", "--num_steps", "4",
        "--batch_size", "2", "--widths", "32", "--encoder_pre_filters", "4",
        "--encoder_down_filters", "8,8", "--encoder_post_filters", "6",
        "--decoder_up_filters", "8,4"])
    return {"run": run, "path": os.path.join(run, "ae_latest.pkl"),
            "params": params, "state": state, "losses": losses}


def test_train_autoencoder_cli_writes_a_checkpoint_jax_reads(trained):
    assert len(trained["losses"]) == 4
    assert all(np.isfinite(float(x)) for x in trained["losses"])
    cfg, params, state = jae.load_ae_checkpoint(trained["path"])
    assert cfg == jenc.GeoEncoderConfig(**ENCODERS["sauto"])
    for got, want in ((params, trained["params"]),
                      (state, trained["state"])):
        g, w = _flat(got), _flat(params_to_jax(want))
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_ae_checkpoint_written_by_jax_loads_in_the_port(tmp_path):
    cfg = jenc.GeoEncoderConfig(**ENCODERS["conv"])
    params, state = init_encoder_trees(
        tenc.GeoEncoderConfig(**ENCODERS["conv"]), seed=6)
    p = str(tmp_path / "ae.pkl")
    jae.save_ae_checkpoint(p, cfg, params, state, step=7)
    assert tae.is_ae_checkpoint(p)
    got_cfg, got_p, got_s = tae.load_ae_checkpoint(p, device="cpu")
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(cfg)
    for got, want in ((got_p, params), (got_s, state)):
        g, w = _flat(params_to_jax(got)), _flat(
            jax.tree_util.tree_map(np.asarray, want))
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_resume_continues_from_the_checkpoint(trained, tmp_path):
    cfg = tae.AETrainConfig(enc_cfg=tenc.GeoEncoderConfig(**ENCODERS["sauto"]),
                            batch_size=2, num_steps=6, widths=(32,))
    it = iter(_tri_batches(3, b=2))
    _, _, losses = tae.train_autoencoder(cfg, it, str(tmp_path), seed=1,
                                         resume=trained["path"],
                                         device="cpu")
    # The checkpoint holds the index of its last step (3 of 0-3); as in the
    # JAX package, the run resumes at that index: steps 3, 4 and 5 of 6.
    assert len(losses) == 3
    with open(os.path.join(str(tmp_path), "ae_latest.pkl"), "rb") as f:
        assert pickle.load(f)["step"] == 5


def test_is_ae_checkpoint_tells_formats_apart(trained, tmp_path):
    pt = str(tmp_path / "enc.pt")
    torch.save({"model_state": {}, "args": {}}, pt)
    assert tae.is_ae_checkpoint(trained["path"])
    assert not tae.is_ae_checkpoint(pt)


@pytest.mark.parametrize("source", ["ae", "pt"])
def test_encoder_checkpt_and_posenc_flags_build_the_jax_config(
        trained, tmp_path, source):
    if source == "ae":
        path = trained["path"]
    else:
        path = str(tmp_path / "encoder.pt")
        torch.save({"model_state": TorchGoldenEncoder(seed=1).state_dict(),
                    "args": argparse.Namespace(**ENC_ARGS)}, path)
    argv = _flags("train_flags.txt") + [
        "--outdir", "unused", "--d_arch=resnet", "--encoder_checkpt", path,
        "--positional_encoding", "sine:8", "--posenc_inject_resolutions",
        "1,2", "--posenc_injection_mode", "cat"]
    jmod = _jax_cli()
    jcfg, jenc_cfg, jp, js = jmod.setup_config(
        jmod.build_parser().parse_args(argv))
    tcfg, tenc_cfg, tp, ts = ttrain.setup_config(
        ttrain.build_parser().parse_args(argv))
    assert dataclasses.asdict(tenc_cfg) == dataclasses.asdict(jenc_cfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.gen_cfg.positional_encoding == "sine:8"
    assert tcfg.gen_cfg.synthesis.pos_encoding_resolutions == (8, 16)
    for got, want in ((tp, jp), (ts, js)):
        g, w = _flat(params_to_jax(got)), _flat(
            jax.tree_util.tree_map(np.asarray, want))
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_encoder_diagnostics_sheet(trained):
    cfg = tenc.GeoEncoderConfig(**ENCODERS["sauto"])
    geom = (np.random.RandomState(2).rand(3, 32, 32, 1) > 0.3) \
        .astype(np.float32)
    jp, js = (jax.tree_util.tree_map(jnp.asarray, params_to_jax(t))
              for t in (trained["params"], trained["state"]))
    with precision_mode("strict"):
        want = jviz.output_encoder_diagnostics(
            None, jenc.GeoEncoderConfig(**ENCODERS["sauto"]), jp, js, geom)
    got = tviz.output_encoder_diagnostics(None, cfg, trained["params"],
                                          trained["state"], geom)
    assert got.dtype == np.uint8 and got.shape == want.shape == (96, 64, 3)
    assert np.abs(got.astype(int) - np.asarray(want).astype(int)).max() <= 1
