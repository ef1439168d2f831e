"""The port's reference-checkpoint conversion against the JAX package's on
the CPU: the layout primitives, config inference, converted parameters,
snapshots (with the encoder inside or in a ``.pt``) and TF-legacy pickles
through both factories, the converter CLI, the factory's format dispatch and
the loaders that run no code of the file.

The reference-layout files are built offline from seeded weights, the way
the JAX package's own tests build them (``tests/test_checkpoint_parity.py``
and ``tests/test_checkpoint.py``, whose file-building helpers are imported).  JAX runs in
strict f32, the port with TF32 off; converted parameters are bit-equal, and
renders agree within TOL (f32 sums reordered through ~10 layers).
"""

import argparse
import dataclasses
import pickle
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.engine import brush as jbrush
from brushstroke_engine_tpu.engine.render import render_core as jrender_core
from brushstroke_engine_tpu.models import discriminator as jdisc
from brushstroke_engine_tpu.models import generator as jgen
from brushstroke_engine_tpu.ops.precision import precision_mode
from brushstroke_engine_tpu.train import train_autoencoder as jae
from brushstroke_engine_tpu.utils import checkpoint as jckpt
from brushstroke_engine_torch.engine import brush as tbrush
from brushstroke_engine_torch.engine.render import render_core
from brushstroke_engine_torch.models import discriminator as tdisc
from brushstroke_engine_torch.models import generator as tgen
from brushstroke_engine_torch.ops.precision import set_precision_mode
from brushstroke_engine_torch.tools import convert_checkpoint as tconv
from brushstroke_engine_torch.ui.core import create_core
from brushstroke_engine_torch.utils import checkpoint as tckpt
from brushstroke_engine_torch.utils import torch_extract as ttx
from tests import test_checkpoint as jtc
from tests.test_checkpoint_parity import (
    ENC_ARGS, TorchGolden, TorchGoldenEncoder, _write_snapshot,
)

set_precision_mode("strict")

TOL = dict(rtol=1e-5, atol=2e-5)
RNG = np.random.RandomState(0)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _leaves(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def assert_trees_equal(got, want):
    """Same keys, shapes and bits (``got`` in the JAX layout)."""
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---------------------------------------------------------------------------
# Layout primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("conv_from_torch", (RNG.randn(5, 3, 3, 2).astype(np.float32),)),
    ("convtranspose_from_torch", (RNG.randn(4, 6, 3, 3).astype(np.float32),)),
    ("epilogue_fc_from_torch", (RNG.randn(7, 3 * 16).astype(np.float32), 3)),
])
def test_layout_primitive_is_bit_equal(name, args):
    want = getattr(jckpt, name)(*args)
    got = getattr(tckpt, name)(*args)
    assert got.shape == want.shape and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bias", [True, False])
def test_fc_from_torch_is_bit_equal(bias):
    flat = {"fc.weight": RNG.randn(6, 10).astype(np.float32)}
    if bias:
        flat["fc.bias"] = RNG.randn(6).astype(np.float32)
    assert_trees_equal(tckpt.fc_from_torch(flat, "fc"),
                       jckpt.fc_from_torch(flat, "fc"))


# ---------------------------------------------------------------------------
# A reference training snapshot through both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """The golden 16-px snapshot of ``tests/test_checkpoint_parity.py``
    (EasyDict args), plus a copy without the encoder and the encoder as a
    ``.pt`` with Namespace args."""
    torch.manual_seed(0)
    gen = TorchGolden(seed=0).eval()
    enc = TorchGoldenEncoder(seed=1).eval()
    d = tmp_path_factory.mktemp("snap")
    path, bare, pt = (str(d / n) for n in
                      ("network-snapshot.pkl", "no-encoder.pkl", "enc.pt"))
    args = ttx.EasyDict(color_format="triad", geom_inject_resolutions=[0])
    _write_snapshot(path, gen, enc, args=args)
    _write_bare_snapshot(bare, gen, args)
    torch.save({"model_state": enc.state_dict(),
                "args": argparse.Namespace(**ENC_ARGS)}, pt)
    return {"path": path, "bare": bare, "pt": pt,
            "jax": jckpt.convert_reference_snapshot(path),
            "torch": tckpt.convert_reference_snapshot(path, device="cpu")}


def _write_bare_snapshot(path, gen, args):
    """``_write_snapshot``'s pickle without the ``encoder`` entry."""
    from tests import test_checkpoint_parity as tcp
    mod = types.ModuleType("torch_utils.persistence")
    mod._reconstruct_persistent_obj = tcp._fake_reconstruct
    pkg = types.ModuleType("torch_utils")
    pkg.persistence = mod
    sys.modules["torch_utils"], sys.modules["torch_utils.persistence"] = \
        pkg, mod
    try:
        with open(path, "wb") as f:
            pickle.dump({"G_ema": tcp._PersistedModule(gen), "args": args},
                        f)
    finally:
        del sys.modules["torch_utils"], sys.modules["torch_utils.persistence"]


def test_snapshot_configs_equal_field_by_field(snapshot):
    j, t = snapshot["jax"], snapshot["torch"]
    assert dataclasses.asdict(t.gen_cfg) == dataclasses.asdict(j.gen_cfg)
    assert dataclasses.asdict(t.enc_cfg) == dataclasses.asdict(j.enc_cfg)
    assert t.color_format == j.color_format == "triad"
    assert t.geom_inject_resolutions == j.geom_inject_resolutions == (0,)


@pytest.mark.parametrize("tree", ["gen_params", "gen_state", "enc_params",
                                  "enc_state"])
def test_snapshot_parameters_bit_equal(snapshot, tree):
    assert_trees_equal(tckpt.params_to_jax(getattr(snapshot["torch"], tree)),
                       getattr(snapshot["jax"], tree))


def _render_both(jb, tb, seed=3):
    rng = np.random.RandomState(seed)
    res = jb.gen_cfg.img_resolution
    geom = (rng.rand(2, res, res, 1) > 0.5).astype(np.float32)
    z = rng.randn(2, jb.gen_cfg.z_dim).astype(np.float32)
    positions = np.array([[5, 70], [300, 13]], np.int32)
    enc_res = tuple(jb.geom_inject_resolutions)
    with precision_mode("strict"):
        want = jrender_core(
            jb.gen_cfg, jb.enc_cfg, enc_res, "clear", (), "triad",
            *(jax.tree_util.tree_map(jnp.asarray, getattr(jb, k)) for k in
              ("gen_params", "gen_state", "enc_params", "enc_state")),
            jnp.asarray(geom), jnp.asarray(z), None, jnp.asarray(positions),
            None, None, None, None, None)
    got = render_core(
        tb.gen_cfg, tb.enc_cfg, enc_res, "clear", (), "triad",
        tb.gen_params, tb.gen_state, tb.enc_params, tb.enc_state,
        geom, z, None, positions, None, None, None, None, None,
        device="cpu")
    return want, got


@pytest.mark.parametrize("source", ["snapshot", "snapshot+encoder.pt"])
def test_snapshot_renders_as_the_jax_conversion(snapshot, source):
    if source == "snapshot":
        jb, tb = snapshot["jax"], snapshot["torch"]
    else:
        jb = jckpt.load_engine_bundle(snapshot["bare"], snapshot["pt"])
        tb = tckpt.load_engine_bundle(snapshot["bare"], snapshot["pt"],
                                      device="cpu")
        assert_trees_equal(tckpt.params_to_jax(tb.enc_params), jb.enc_params)
    want, got = _render_both(jb, tb)
    for k in ("rgba", "uvs", "colors", "raw_img"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)


def _factory_strokes(jeng, teng):
    patch = np.zeros((16, 16, 4), np.uint8)
    patch[4:10, 2:14, 3] = 255
    outs = []
    for eng, brush in ((jeng, jbrush), (teng, tbrush)):
        opts = brush.GanBrushOptions()
        opts.set_style(eng.random_style(2), style_id=2)
        opts.set_position(x=3, y=40)
        with precision_mode("strict"):
            outs.append(eng.render_stroke(patch, None, opts)[0])
    return outs


@pytest.mark.parametrize("source", ["snapshot", "snapshot+encoder.pt"])
def test_both_factories_render_the_same_stroke(snapshot, source):
    args = (snapshot["path"],) if source == "snapshot" else \
        (snapshot["bare"], snapshot["pt"])
    jeng = jbrush.PaintEngineFactory.create(*args)
    teng = tbrush.PaintEngineFactory.create(*args, device="cpu")
    assert isinstance(teng, tbrush.TriadGanPaintEngine)
    assert dataclasses.asdict(teng.gen_cfg) == dataclasses.asdict(
        jeng.gen_cfg)
    assert_trees_equal(tckpt.params_to_jax(teng.enc_params),
                       jax.tree_util.tree_map(np.asarray, jeng.enc_params))
    j_rgba, t_rgba = _factory_strokes(jeng, teng)
    assert t_rgba.shape == (16, 16, 4)
    assert np.abs(j_rgba.astype(int) - t_rgba.astype(int)).max() <= 1


def test_snapshot_without_encoder_raises_as_the_jax_package(snapshot):
    with pytest.raises(ValueError, match="No geometry encoder"):
        tckpt.load_engine_bundle(snapshot["bare"], device="cpu")


def test_create_core_serves_a_reference_snapshot(snapshot):
    core = create_core(gan_checkpoint=snapshot["path"], device="cpu")
    assert isinstance(core.engine, tbrush.TriadGanPaintEngine)
    assert core.engine.gen_cfg.img_resolution == 16


def test_load_engine_bundle_reads_a_native_bundle(snapshot, tmp_path):
    p = str(tmp_path / "native.pkl")
    tckpt.save_native(p, snapshot["torch"])
    got = tckpt.load_engine_bundle(p, device="cpu")
    want = tckpt.load_native(p, device="cpu")
    assert_trees_equal(tckpt.params_to_jax(got.gen_params),
                       tckpt.params_to_jax(want.gen_params))
    assert got.gen_cfg == want.gen_cfg and got.enc_cfg == want.enc_cfg


# ---------------------------------------------------------------------------
# The factory's format dispatch and the loaders that run no code
# ---------------------------------------------------------------------------

def test_truncated_native_bundle_raises_its_own_error(snapshot, tmp_path):
    p = str(tmp_path / "native.pkl")
    tckpt.save_native(p, snapshot["torch"])
    with open(p, "rb") as f:
        data = f.read()
    with open(p, "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises((pickle.UnpicklingError, EOFError)) as e:
        tbrush.PaintEngineFactory.create(p, device="cpu")
    # not the converter's errors (no snapshot structure, no encoder).
    assert "snapshot" not in str(e.value) and "encoder" not in str(e.value)


def test_corrupt_native_bundle_is_not_converted(snapshot, tmp_path):
    p = str(tmp_path / "native.pkl")
    tckpt.save_native(p, snapshot["torch"])
    with open(p, "rb") as f:
        payload = pickle.load(f)
    payload["gen_cfg"]["no_such_field"] = 1
    with open(p, "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(TypeError, match="no_such_field"):
        tbrush.PaintEngineFactory.create(p, device="cpu")


def _foreign_call(*_):
    _foreign_call.calls += 1
    return {}


_foreign_call.calls = 0


class _Foreign:
    def __reduce__(self):
        return (_foreign_call, ("x",))


def test_encoder_pt_naming_a_foreign_callable_is_refused(tmp_path):
    p = str(tmp_path / "evil.pt")
    torch.save({"model_state": {}, "args": _Foreign()}, p)
    with pytest.raises(pickle.UnpicklingError):
        ttx.load_torch_file(p)
    assert _foreign_call.calls == 0


@pytest.mark.parametrize("module,name", [("builtins", "eval"),
                                         ("os", "system"),
                                         ("torch", "load"),
                                         ("tests.test_torch_checkpoint",
                                          "_foreign_call")])
def test_reference_pickle_runs_no_foreign_global(tmp_path, module, name):
    p = str(tmp_path / "evil.pkl")
    calls = _foreign_call.calls
    # GLOBAL module name; MARK; a string; TUPLE; REDUCE; STOP (protocol 0).
    with open(p, "wb") as f:
        f.write(f"c{module}\n{name}\n(S'0'\ntR.".encode())
    got = ttx.load_reference_pickle(p)
    assert isinstance(got, ttx.PersistentStub) and got.meta == "0"
    assert _foreign_call.calls == calls


def test_reference_pickle_reads_tensors_and_arrays(tmp_path):
    p = str(tmp_path / "plain.pkl")
    want = {"t": torch.randn(3, 2), "p": torch.nn.Parameter(torch.ones(2)),
            "a": np.arange(4, dtype=np.float32), "s": np.float32(2.5),
            "ns": argparse.Namespace(k=1), "dt": torch.float32}
    with open(p, "wb") as f:
        pickle.dump(want, f)
    got = ttx.load_reference_pickle(p)
    assert torch.equal(got["t"], want["t"]) and torch.equal(got["p"],
                                                            want["p"])
    np.testing.assert_array_equal(got["a"], want["a"])
    assert got["s"] == 2.5 and got["ns"].k == 1 and got["dt"] is torch.float32


def test_encoder_pt_with_easydict_args_loads(tmp_path):
    class EasyDict(dict):
        pass
    EasyDict.__module__, EasyDict.__qualname__ = "dnnlib.util", "EasyDict"
    mod = types.ModuleType("dnnlib.util")
    mod.EasyDict = EasyDict
    pkg = types.ModuleType("dnnlib")
    pkg.util = mod
    sys.modules["dnnlib"], sys.modules["dnnlib.util"] = pkg, mod
    try:
        p = str(tmp_path / "enc.pt")
        torch.save({"model_state": {"w": torch.ones(2)},
                    "args": EasyDict(model_name="conv", width=64)}, p)
    finally:
        del sys.modules["dnnlib"], sys.modules["dnnlib.util"]
    got = ttx.load_torch_file(p)
    assert got["args"] == {"model_name": "conv", "width": 64}


# ---------------------------------------------------------------------------
# Discriminator conversion
# ---------------------------------------------------------------------------

def _torch_disc_flat(params, ch4):
    """A JAX-layout D tree -> the reference's state-dict names/layouts."""
    flat = {}
    for path, a in _leaves(params).items():
        key = path.replace("/", ".")
        if path == "b4/fc/weight":
            out_f = a.shape[1]
            a = a.T.reshape(out_f, 4, 4, ch4).transpose(0, 3, 1, 2) \
                .reshape(out_f, ch4 * 16)
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        flat[key] = np.ascontiguousarray(a)
    return flat


@pytest.fixture(scope="module", params=[("resnet", 0), ("orig", 0),
                                        ("resnet", 4)],
                ids=["resnet", "orig", "resnet-c4"])
def disc(request):
    arch, c_dim = request.param
    cfg = tdisc.DiscriminatorConfig(
        c_dim=c_dim, img_resolution=32, img_channels=3, architecture=arch,
        channel_base=256, channel_max=16)
    gcfg = tgen.make_generator_config(img_resolution=4, channel_max=1,
                                      mapping_layers=1)
    trees = tckpt.init_native_params(gcfg, tckpt.GeoEncoderConfig(),
                                     seed=5, disc_cfg=cfg)
    flat = _torch_disc_flat(trees["disc_params"], cfg.channels(4))
    args = {"c_dim": c_dim}
    return {"cfg": cfg, "flat": flat, "args": args,
            "jcfg": jckpt.infer_discriminator_config(flat, args),
            "tcfg": tckpt.infer_discriminator_config(flat, args)}


def test_infer_discriminator_config_field_by_field(disc):
    assert dataclasses.asdict(disc["tcfg"]) == dataclasses.asdict(disc["jcfg"])
    assert disc["tcfg"] == disc["cfg"]


def test_converted_discriminator_bit_equal_and_same_logits(disc):
    want = jckpt.convert_discriminator_state(disc["flat"], disc["jcfg"])
    got = tckpt.convert_discriminator_state(disc["flat"], disc["tcfg"])
    assert_trees_equal(got, want)
    rng = np.random.RandomState(7)
    img = rng.randn(4, 32, 32, 3).astype(np.float32)
    c = rng.randn(4, 4).astype(np.float32) if disc["cfg"].c_dim else None
    with precision_mode("strict"):
        jl = jdisc.discriminator_apply(
            disc["jcfg"], jax.tree_util.tree_map(jnp.asarray, want),
            jnp.asarray(img), None if c is None else jnp.asarray(c))
    tl = tdisc.discriminator_apply(
        disc["tcfg"], tckpt.params_from_jax(got), torch.from_numpy(img),
        None if c is None else torch.from_numpy(c))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


# ---------------------------------------------------------------------------
# TF-legacy StyleGAN2 pickles
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tf_pickle(tmp_path_factory):
    """A 32-px 'skip' / 'orig'-head TF pickle from seeded (asymmetric)
    weights, built as ``tests/test_checkpoint.py`` builds its TF pickle."""
    kw = dict(z_dim=8, w_dim=8, img_resolution=32, color_format="orig",
              architecture="skip", channel_base=128, channel_max=16,
              mapping_layers=2)
    cfg = jgen.make_generator_config(**kw)
    trees = tckpt.init_native_params(tgen.make_generator_config(**kw),
                                     _small_encoder(), seed=3)
    rng = np.random.RandomState(4)
    state = dict(trees["gen_state"], w_avg=rng.randn(8).astype(np.float32))
    params = jax.tree_util.tree_map(
        lambda a: a + np.asarray(0.2 * rng.randn(*a.shape), np.float32)
        if a.ndim < 2 else a, trees["gen_params"])   # non-zero biases, gains
    tfl = jtc.TestTFLegacyConversion()
    flat = tfl._torch_flat_from_params(cfg, params, state)
    flat["mapping.w_avg"] = np.asarray(state["w_avg"])
    tf_params = tfl._tf_params_from_torch_flat(flat, cfg)
    net_state = {
        "version": 4,
        "static_kwargs": {
            "latent_size": 8, "dlatent_size": 8, "resolution": 32,
            "num_channels": 3, "mapping_layers": 2, "fmap_base": 64,
            "fmap_max": 16, "architecture": "skip", "conv_clamp": 256},
        "components": {}, "variables": list(tf_params.items()),
    }

    class FakeNetwork:
        def __reduce__(self):
            return (jtc._tf_reconstruct, (net_state,))

    mods = {"dnnlib": types.ModuleType("dnnlib"),
            "dnnlib.tflib": types.ModuleType("dnnlib.tflib"),
            "dnnlib.tflib.network": types.ModuleType("dnnlib.tflib.network")}
    mods["dnnlib.tflib.network"].Network = jtc._tf_reconstruct
    sys.modules.update(mods)
    try:
        p = str(tmp_path_factory.mktemp("tf") / "tf-network.pkl")
        with open(p, "wb") as f:
            pickle.dump((FakeNetwork(), FakeNetwork(), FakeNetwork()), f)
    finally:
        for k in mods:
            del sys.modules[k]
    return {"path": p, "jax": jckpt.convert_tf_generator_pkl(p),
            "torch": tckpt.convert_tf_generator_pkl(p, device="cpu")}


def test_tf_generator_config_and_parameters_bit_equal(tf_pickle):
    jc, jp, js = tf_pickle["jax"]
    tc, tp, ts = tf_pickle["torch"]
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.synthesis.architecture == "skip"
    assert tc.synthesis.color_format == "orig"
    assert_trees_equal(tckpt.params_to_jax(tp), jp)
    assert_trees_equal(tckpt.params_to_jax(ts), js)


@pytest.mark.parametrize("psi", [1.0, 0.7])
def test_tf_generator_renders_as_the_jax_conversion(tf_pickle, psi):
    jc, jp, js = tf_pickle["jax"]
    tc, tp, ts = tf_pickle["torch"]
    z = np.random.RandomState(5).randn(2, 8).astype(np.float32)
    with precision_mode("strict"):
        want, _, _ = jgen.generator_apply(
            jc, jax.tree_util.tree_map(jnp.asarray, jp),
            jax.tree_util.tree_map(jnp.asarray, js), z=jnp.asarray(z),
            truncation_psi=psi, noise_mode="const")
    got, _ = tgen.generator_apply(tc, tp, ts, z=torch.from_numpy(z),
                                  truncation_psi=psi, noise_mode="const")
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# The converter CLI; its outputs load in the JAX package
# ---------------------------------------------------------------------------

def test_convert_snapshot_cli(snapshot, tmp_path):
    dst = str(tmp_path / "bundle.pkl")
    tconv.main(["--kind", "snapshot", "--src", snapshot["path"],
                "--dst", dst])
    j = jckpt.load_native(dst)
    assert dataclasses.asdict(j.gen_cfg) == dataclasses.asdict(
        snapshot["jax"].gen_cfg)
    assert_trees_equal(j.gen_params, snapshot["jax"].gen_params)
    assert_trees_equal(j.enc_state, snapshot["jax"].enc_state)


def test_convert_encoder_cli(snapshot, tmp_path):
    dst = str(tmp_path / "ae.pkl")
    tconv.main(["--kind", "encoder", "--src", snapshot["pt"], "--dst", dst])
    cfg, params, state = jae.load_ae_checkpoint(dst)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        snapshot["jax"].enc_cfg)
    assert_trees_equal(params, snapshot["jax"].enc_params)
    assert_trees_equal(state, snapshot["jax"].enc_state)


def test_convert_tf_cli(tf_pickle, tmp_path):
    dst = str(tmp_path / "tfgen.pkl")
    tconv.main(["--kind", "tf", "--src", tf_pickle["path"], "--dst", dst])
    with open(dst, "rb") as f:
        payload = pickle.load(f)
    jc, jp, js = tf_pickle["jax"]
    assert payload["magic"] == "brushstroke_engine_tpu.tf_generator.v1"
    assert payload["gen_cfg"] == dataclasses.asdict(jc)
    assert_trees_equal(payload["gen_params"], jp)
    cfg, params, _ = tckpt.load_tf_generator(dst, device="cpu")
    assert cfg == tf_pickle["torch"][0]
    assert_trees_equal(tckpt.params_to_jax(params), jp)


def test_convert_library_cli(tmp_path):
    src, dst = str(tmp_path / "lib.pkl"), str(tmp_path / "lib_np.pkl")
    styles = {"a": torch.randn(5, 8),
              "b": {"w": torch.randn(5, 8),
                    "noise": {"b8.conv0.noise_const": torch.randn(8, 8)}}}
    with open(src, "wb") as f:
        pickle.dump(styles, f)
    tconv.main(["--kind", "library", "--src", src, "--dst", dst])
    from brushstroke_engine_tpu.engine.library import WBrushLibrary
    lib = WBrushLibrary.from_file(dst)
    np.testing.assert_array_equal(lib.styles["a"], styles["a"].numpy())
    np.testing.assert_array_equal(
        lib.styles["b"]["noise"]["b8.conv0.noise_const"],
        styles["b"]["noise"]["b8.conv0.noise_const"].numpy())


# ---------------------------------------------------------------------------
# A fault of the reference, pinned in both halves
# ---------------------------------------------------------------------------

def test_infer_generator_config_counts_cat_positional_channels_as_geometry():
    """``infer_generator_config`` reads no positional encoding: a snapshot
    trained with 'sine:4' injected in 'cat' mode after the 8-px block has 4
    more conv0 inputs at b16, which both packages count as geometry
    (``ROADMAP.md`` §3, open in the reference)."""
    cfg = tgen.make_generator_config(
        z_dim=8, w_dim=8, img_resolution=16, geom_feature_resolutions=(8,),
        geom_feature_channels=(6,), channel_base=128, channel_max=16,
        mapping_layers=2, positional_encoding="sine:4",
        posenc_inject_resolutions=(1,))
    trees = tckpt.init_native_params(cfg, tckpt.GeoEncoderConfig(), seed=1)
    flat = {}
    for path, a in _leaves(trees["gen_params"]).items():
        key = path.replace("/", ".")
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        elif key.endswith("const") and a.ndim == 3:
            a = a.transpose(2, 0, 1)
        flat[key] = a
    args = {"positional_encoding": "sine:4", "posenc_inject_resolutions": "1"}
    jc = jckpt.infer_generator_config(flat, args)
    tc = tckpt.infer_generator_config(flat, args)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for c in (jc, tc):
        assert c.positional_encoding is None
        assert c.synthesis.geom_feature_channels == (6 + 4,)


# ---------------------------------------------------------------------------
# Reference-layout writers (utils/reference_layout.py): seeded trees written
# as the reference writes them convert back to the same bits in both
# packages
# ---------------------------------------------------------------------------

RL_ENCODERS = {
    "sauto-legacy": dict(kind="sauto", preproc="-11inverse", pre_filters=4,
                         down_filters=(8,), post_filters=(6,),
                         up_filters=(8, 4)),
    "sauto-v2": dict(kind="sauto", preproc="inverse", pre_filters=4,
                     down_filters=(8,), post_filters=(6,), up_filters=(8, 4),
                     decoder_pre_filters=5, neg_slope=0.2, out_channels=3),
    "conv": dict(kind="conv", preproc="-11inverse", img_width=32,
                 emb_channel=4, channel_factor=2, num_layers=2),
}


@pytest.mark.parametrize("enc_name", sorted(RL_ENCODERS))
def test_reference_layout_snapshot_round_trip(enc_name, tmp_path):
    from brushstroke_engine_torch.models.geo_encoder import GeoEncoderConfig
    from brushstroke_engine_torch.utils import reference_layout as rl
    enc_cfg = GeoEncoderConfig(**RL_ENCODERS[enc_name])
    gen_cfg = tgen.make_generator_config(
        z_dim=8, w_dim=8, img_resolution=32,
        geom_feature_resolutions=(enc_cfg.featuremap_resolution(32, 0),),
        geom_feature_channels=(enc_cfg.feature_channels(0),),
        channel_base=256, channel_max=16, mapping_layers=2)
    dcfg = tdisc.DiscriminatorConfig(c_dim=0, img_resolution=32,
                                     img_channels=3, architecture="orig",
                                     channel_base=256, channel_max=16)
    trees = tckpt.init_native_params(gen_cfg, enc_cfg, seed=4,
                                     disc_cfg=dcfg)
    p = str(tmp_path / "snap.pkl")
    rl.write_reference_snapshot(
        p, rl.generator_state_dict(gen_cfg, trees["gen_params"],
                                   trees["gen_state"]),
        {"color_format": "triad", "geom_inject_resolutions": [0]},
        encoder={"args": rl.encoder_args(enc_cfg),
                 "model_state": rl.encoder_state_dict(
                     enc_cfg, trees["enc_params"], trees["enc_state"])},
        disc_flat=rl.discriminator_state_dict(dcfg, trees["disc_params"]))
    jb = jckpt.convert_reference_snapshot(p)
    tb = tckpt.load_engine_bundle(p, device="cpu")
    assert tb.gen_cfg == gen_cfg and tb.enc_cfg == enc_cfg
    for k in ("gen_params", "gen_state", "enc_params", "enc_state"):
        assert_trees_equal(tckpt.params_to_jax(getattr(tb, k)), trees[k])
        assert_trees_equal(getattr(jb, k), trees[k])
    d_flat = ttx.flatten_module_state(ttx.load_reference_pickle(p)["D"])
    assert tckpt.infer_discriminator_config(d_flat, {}) == dcfg
    assert_trees_equal(tckpt.convert_discriminator_state(d_flat, dcfg),
                       trees["disc_params"])


def test_reference_layout_tf_round_trip(tmp_path):
    from brushstroke_engine_torch.utils import reference_layout as rl
    cfg = tgen.make_generator_config(
        z_dim=8, w_dim=8, img_resolution=32, color_format="orig",
        architecture="skip", channel_base=128, channel_max=16,
        mapping_layers=2, conv_clamp=None)
    trees = tckpt.init_native_params(cfg, _small_encoder(), seed=6)
    p = str(tmp_path / "tf.pkl")
    rl.write_tf_pickle(p, rl.generator_state_dict(
        cfg, trees["gen_params"], trees["gen_state"]), cfg)
    jc, jp, js = jckpt.convert_tf_generator_pkl(p)
    tc, tp, ts = tckpt.tf_generator_trees(p)
    assert tc == cfg and dataclasses.asdict(jc) == dataclasses.asdict(cfg)
    for got in (tp, jp):
        assert_trees_equal(got, trees["gen_params"])
    for got in (ts, js):
        assert_trees_equal(got, trees["gen_state"])


def _small_encoder():
    from brushstroke_engine_torch.models.geo_encoder import GeoEncoderConfig
    return GeoEncoderConfig(pre_filters=2, down_filters=(2,),
                            post_filters=(2,), up_filters=(2,))
