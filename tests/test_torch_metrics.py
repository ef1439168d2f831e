"""The port's metrics against the JAX package's on the CPU, strict f32 (TF32
off): LPIPS, the Lab color metrics, the transparency and background /
across-geometry LPIPS metrics with the JAX package's draws fed in, both FID
detectors, the feature statistics, FID / KID / IS, and the forger metric
loop and FID on one small engine.

Tolerances (set before the runs):
  * weights drawn from the same numpy seeds: bit-equal;
  * LPIPS, the detectors' features, the Lab and transparency metrics: 1e-4
    relative + 1e-5 abs (f32 convolutions summed in other orders);
  * the image resize in front of LPIPS and Inception: 2e-5 abs (a triangle
    kernel's weights, normalized in another order);
  * numpy on both sides (feature statistics, Frechet distance, KID, IS):
    1e-12 relative;
  * the metric loop (with and without the stitching metrics) and FID over
    an engine's renders, which agree with the JAX package's to ~1e-5: 1e-3
    relative + 1e-4 abs, and LAB_E% (a count of pixels past a threshold)
    within one pixel's share of the batch.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.engine import brush as jbrush
from brushstroke_engine_tpu.engine import library as jlib
from brushstroke_engine_tpu.metrics import color as jcolor
from brushstroke_engine_tpu.metrics import fid as jfid
from brushstroke_engine_tpu.metrics import geom as jgeom
from brushstroke_engine_tpu.metrics import inception as jinc
from brushstroke_engine_tpu.metrics import lpips as jlpips
from brushstroke_engine_tpu.metrics import metric_main as jmm
from brushstroke_engine_tpu.metrics import stroke_generator as jsg
from brushstroke_engine_tpu.ops.precision import set_precision_mode as jset
from brushstroke_engine_torch.engine import brush as tbrush
from brushstroke_engine_torch.engine import library as tlib
from brushstroke_engine_torch.metrics import color as tcolor
from brushstroke_engine_torch.metrics import fid as tfid
from brushstroke_engine_torch.metrics import geom as tgeom
from brushstroke_engine_torch.metrics import inception as tinc
from brushstroke_engine_torch.metrics import lpips as tlpips
from brushstroke_engine_torch.metrics import metric_main as tmm
from brushstroke_engine_torch.metrics import stroke_generator as tsg
from brushstroke_engine_torch.ops.precision import set_precision_mode as tset
from tests.torch_helpers import small_model

RTOL, ATOL = 1e-4, 1e-5
LOOP_RTOL, LOOP_ATOL = 1e-3, 1e-4


@pytest.fixture(autouse=True)
def _strict():
    jset("strict")
    tset("strict")
    yield


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _images(seed, b, h, w, c=3):
    return np.random.RandomState(seed).uniform(
        -1, 1, (b, h, w, c)).astype(np.float32)


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

def test_lpips_random_init_weights_bit_equal():
    j = jlpips.LPIPSModel.random_init(0)
    t = tlpips.LPIPSModel.random_init(0, device="cpu")
    for jc, tc in zip(j.convs, t.convs):
        np.testing.assert_array_equal(
            tc["weight"].numpy(),
            np.transpose(np.asarray(jc["weight"]), (3, 2, 0, 1)))
        np.testing.assert_array_equal(tc["bias"].numpy(), jc["bias"])
    for jl, tl in zip(j.lins, t.lins):
        np.testing.assert_array_equal(tl.numpy(), jl)


@pytest.mark.parametrize("size", [32, 64, 20])
def test_lpips_batched_matches_jax(size):
    """32 and 64 px, and 20 px, which both packages upsample to 32."""
    x, y = _images(1, 3, size, size), _images(2, 3, size, size)
    want = jlpips.lpips_batched(jnp.asarray(x), jnp.asarray(y),
                                jlpips.LPIPSModel.random_init(0))
    model = tlpips.LPIPSModel.random_init(0, device="cpu")
    got = tlpips.lpips_batched(_t(x), _t(y), model)
    assert got.shape == (3,) and bool((got > 0).all())
    _close(got, want)
    # The default model on the CPU is the same fallback.
    _close(tlpips.lpips_batched(_t(x), _t(y)), want)


@pytest.mark.parametrize("shape,out", [((2, 20, 24, 3), (32, 32)),
                                       ((2, 128, 128, 3), (299, 299)),
                                       ((2, 330, 310, 3), (299, 299)),
                                       ((2, 64, 64, 3), (32, 32))])
def test_resize_matches_jax_image_resize(shape, out):
    """Sizes that grow and sizes that shrink (antialiased in both)."""
    x = np.random.RandomState(3).rand(*shape).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (shape[0], *out, 3), "bilinear")
    got = tlpips.resize_bilinear(_t(x).permute(0, 3, 1, 2), *out)
    _close(got.permute(0, 2, 3, 1), want, rtol=0, atol=2e-5)


def _fake_lpips_state():
    rng = np.random.RandomState(9)
    state, cin = {}, 3
    slices = ["net.slice1.0", "net.slice2.3", "net.slice3.6",
              "net.slice4.8", "net.slice5.10"]
    for i, (name, (cout, k, _s, _p)) in enumerate(zip(slices,
                                                     jlpips._ALEX_PLAN)):
        state[f"{name}.weight"] = (0.05 * rng.randn(cout, cin, k, k)) \
            .astype(np.float32)
        state[f"{name}.bias"] = (0.1 * rng.randn(cout)).astype(np.float32)
        state[f"lin{i}.model.1.weight"] = np.abs(
            rng.randn(1, cout, 1, 1)).astype(np.float32) / cout
        cin = cout
    return state


def test_lpips_from_torch_state_matches_jax():
    state = _fake_lpips_state()
    j = jlpips.LPIPSModel.from_torch_state(state)
    t = tlpips.LPIPSModel.from_torch_state(state, device="cpu")
    x, y = _images(4, 2, 48, 48), _images(5, 2, 48, 48)
    _close(tlpips.lpips_batched(_t(x), _t(y), t),
           jlpips.lpips_batched(jnp.asarray(x), jnp.asarray(y), j))
    with pytest.raises(ValueError, match="lpips"):
        tlpips.LPIPSModel.from_torch_state(
            {k: v for k, v in state.items() if "lin4" not in k},
            device="cpu")


def test_default_models_are_kept_per_device(monkeypatch):
    """A CPU caller gets CPU weights, whatever another device cached."""
    monkeypatch.setattr(tlpips, "_DEFAULT_MODELS", {})
    monkeypatch.setattr(tfid, "_DEFAULTS", {})
    fake = tlpips.LPIPSModel.random_init(1, device="cpu")
    fake_key = torch.device("meta")
    tlpips._DEFAULT_MODELS[fake_key] = fake
    m = tlpips.get_default_model("cpu")
    assert m is not fake and m.device.type == "cpu"
    assert tlpips.get_default_model(torch.device("cpu")) is m
    d = tfid.get_default_extractor("cpu")
    assert d.kind == "random" and d.device.type == "cpu"
    assert tfid.default_detector_kind("cpu") == "random"
    other = tfid.InceptionFeatures.random_init(3, device="cpu")
    tfid.set_default_extractor(other)
    assert tfid.get_default_extractor("cpu") is other


# ---------------------------------------------------------------------------
# Color and geometry metrics
# ---------------------------------------------------------------------------

def _render_and_geom(seed, b=4, w=32):
    rng = np.random.RandomState(seed)
    rgba = rng.rand(b, w, w, 4).astype(np.float32)
    geom = np.ones((b, w, w, 1), np.float32)
    geom[:, 8:20, 6:26] = 0.0                          # a stroke
    rgba[..., 3] = np.where(geom[..., 0] < 0.5, 0.9 + 0.1 * rgba[..., 3],
                            0.05 * rgba[..., 3])
    return rgba, geom


def test_lab_metrics_match_jax():
    rgba, geom = _render_and_geom(0)
    colors = np.random.RandomState(1).rand(4, 3).astype(np.float32)
    want = jcolor.compute_lab_metrics(jnp.asarray(colors), jnp.asarray(rgba),
                                      jnp.asarray(geom))
    got = tcolor.compute_lab_metrics(colors, _t(rgba), _t(geom))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], msg=k)
    lab_j = jcolor.rgb2lab(jnp.asarray(rgba[..., :3]))
    _close(tcolor.rgb2lab(_t(rgba[..., :3])), lab_j, atol=1e-4)


def test_transparency_metrics_match_jax():
    rgba, geom = _render_and_geom(2)
    want = jgeom.compute_transparency_metrics(jnp.asarray(rgba),
                                              jnp.asarray(geom))
    got = tgeom.compute_transparency_metrics(_t(rgba), _t(geom))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], msg=k)
    _close(tgeom.gaussian_smoothing(_t(rgba)),
           jgeom.gaussian_smoothing(jnp.asarray(rgba)))


def _jax_uniform_bg_draws(key, b, w, same_style):
    """The patch corners and permutation that
    ``compute_uniform_bg_lpips_metric(rng=key)`` draws in the JAX package."""
    pw = tgeom.uniform_bg_patch_width(w)
    k1, k2, k3 = jax.random.split(key, 3)

    def corner(k):
        return (int(jax.random.randint(k, (), 0, w - pw + 1)),
                int(jax.random.randint(jax.random.fold_in(k, 1), (), 0,
                                       w - pw + 1)))

    return {"p0": corner(k1), "p1": corner(k2),
            "perm": _t(np.asarray(jax.random.permutation(k3, b)))
            if same_style else None}


@pytest.mark.parametrize("same_style", [False, True])
def test_uniform_bg_lpips_with_jax_draws(same_style):
    rgba, geom = _render_and_geom(3, w=48)
    rgba[..., 3] *= 0.3
    key = jax.random.PRNGKey(11)
    want = jgeom.compute_uniform_bg_lpips_metric(
        jnp.asarray(rgba), jnp.asarray(geom), same_style=same_style,
        rng=key, key_suffix="x")
    got = tgeom.compute_uniform_bg_lpips_metric(
        _t(rgba), _t(geom), same_style=same_style, key_suffix="x",
        draws=_jax_uniform_bg_draws(key, 4, 48, same_style))
    assert set(got) == {"LPIPS_UNIFORM_BG_x"}
    assert want["LPIPS_UNIFORM_BG_x"] > 0
    _close(got["LPIPS_UNIFORM_BG_x"], want["LPIPS_UNIFORM_BG_x"])


def test_lpips_across_geo_with_jax_perm():
    rgba, _ = _render_and_geom(4)
    key = jax.random.PRNGKey(5)
    want = jgeom.compute_lpips_across_geo(jnp.asarray(rgba), rng=key)
    got = tgeom.compute_lpips_across_geo(
        _t(rgba), perm=np.asarray(jax.random.permutation(key, 4)))
    _close(got["LPIPS_ACROSS_GEO"], want["LPIPS_ACROSS_GEO"])


def test_stitching_metrics_match_jax():
    rng = np.random.RandomState(6)
    res = {k: rng.uniform(-1, 1, (2, 48, 48, 3)).astype(np.float32)
           for k in ("fake1", "fake1_composite", "fake2", "fake2_composite")}
    want = jgeom.compute_stitching_metrics(
        {k: jnp.asarray(v) for k, v in res.items()}, 4)
    got = tgeom.compute_stitching_metrics({k: _t(v) for k, v in res.items()},
                                          4)
    for k in want:
        _close(got[k], want[k], msg=k)


# ---------------------------------------------------------------------------
# Detectors and statistics
# ---------------------------------------------------------------------------

def test_random_detector_features_match_jax():
    j = jfid.InceptionFeatures.random_init(0)
    t = tfid.InceptionFeatures.random_init(0, device="cpu")
    for jc, tc in zip(j.convs, t.convs):
        np.testing.assert_array_equal(
            tc["weight"].numpy(),
            np.transpose(np.asarray(jc["weight"]), (3, 2, 0, 1)))
    u8 = np.random.RandomState(7).randint(0, 256, (3, 40, 40, 3)) \
        .astype(np.uint8)
    for images in (u8, u8.astype(np.float32) / 127.5 - 1.0):
        want = jfid.extract_features(jnp.asarray(images), j)
        got = tfid.extract_features(images, t)
        assert got.shape == (3, tfid.FEATURE_DIM)
        _close(got, want)


def test_inception_v3_features_match_jax():
    j = jinc.InceptionV3.random_init(0)
    t = tinc.InceptionV3.random_init(0, device="cpu")
    assert t.param_count() == j.param_count() == jinc.PARAM_COUNT
    name = "Mixed_6b.branch7x7_2"
    np.testing.assert_array_equal(
        t.params[name]["w"].numpy(),
        np.transpose(np.asarray(j.params[name]["w"]), (3, 2, 0, 1)))
    u8 = np.random.RandomState(8).randint(0, 256, (2, 64, 64, 3)) \
        .astype(np.uint8)
    want = np.asarray(jinc.inception_features(j, jnp.asarray(u8)))
    got = tinc.inception_features(t, u8)
    assert got.shape == (2, tinc.POOL_DIM)
    _close(got, want, atol=1e-5 * float(np.abs(want).max()))
    for images, rng in ((u8, "tf"), (u8[..., :1], "torchvision")):
        _close(tinc.preprocess(images, rng).permute(0, 2, 3, 1),
               jinc.preprocess(jnp.asarray(images), rng), rtol=0, atol=2e-5)


def test_inception_v3_layouts_convert_as_in_jax():
    """torchvision and the StyleGAN2-ADA TorchScript layouts, from one
    seeded fake state dict each."""
    rng = np.random.RandomState(12)
    tv, nv = {}, {}
    names = jinc._nvidia_name_map()
    for (name, cin, cout, (kh, kw), _s, _p) in jinc.CONVS:
        w = rng.randn(cout, cin, kh, kw).astype(np.float32)
        tv[f"{name}.conv.weight"] = w
        for k in ("weight", "bias", "running_mean"):
            tv[f"{name}.bn.{k}"] = rng.randn(cout).astype(np.float32)
        tv[f"{name}.bn.running_var"] = rng.rand(cout).astype(np.float32) + 1
        nv[f"layers.{names[name]}.conv.weight"] = w
        nv[f"layers.{names[name]}.beta"] = rng.randn(cout).astype(np.float32)
    for conv, state in (("from_torchvision_state", tv),
                        ("from_nvidia_state", nv)):
        j = getattr(jinc.InceptionV3, conv)(state)
        t = getattr(tinc.InceptionV3, conv)(state, device="cpu")
        assert (t.kind, t.bn_eps, t.count_include_pad,
                t.mixed_7c_pool_max) == (j.kind, j.bn_eps,
                                         j.count_include_pad,
                                         j.mixed_7c_pool_max)
        for name in j.params:
            for k in ("scale", "bias", "mean", "var"):
                np.testing.assert_array_equal(t.params[name][k].numpy(),
                                              j.params[name][k])
            np.testing.assert_array_equal(
                t.params[name]["w"].numpy(),
                np.transpose(j.params[name]["w"], (3, 2, 0, 1)))


def test_load_detector_reads_a_torch_file(tmp_path):
    j = jinc.InceptionV3.random_init(1)
    state = {}
    for (name, *_rest) in jinc.CONVS:
        p = j.params[name]
        state[f"{name}.conv.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(p["w"], (3, 2, 0, 1))))
        state[f"{name}.bn.weight"] = torch.from_numpy(p["scale"])
        state[f"{name}.bn.bias"] = torch.from_numpy(p["bias"])
        state[f"{name}.bn.running_mean"] = torch.from_numpy(p["mean"])
        state[f"{name}.bn.running_var"] = torch.from_numpy(p["var"])
    path = str(tmp_path / "inception.pt")
    torch.save(state, path)
    t = tfid.load_detector(path, device="cpu")
    assert t.kind == "inception_v3" and t.mixed_7c_pool_max
    np.testing.assert_array_equal(
        t.params["Conv2d_1a_3x3"]["w"].numpy(),
        state["Conv2d_1a_3x3.conv.weight"].numpy())


def test_feature_stats_fid_kid_is_match_jax():
    rng = np.random.RandomState(13)
    real = rng.randn(40, 16)
    gen = rng.randn(40, 16) * 1.2 + 0.3
    sj, st = jfid.FeatureStats(30), tfid.FeatureStats(30)
    for i in range(0, 40, 8):
        sj.append(real[i:i + 8])
        st.append(_t(real[i:i + 8]))
    assert st.num_items == sj.num_items == 30 and st.is_full
    gj, gt = jfid.FeatureStats(), tfid.FeatureStats()
    gj.append(gen)
    gt.append(gen)
    for a, b in zip(st.get_mean_cov() + gt.get_mean_cov(),
                    sj.get_mean_cov() + gj.get_mean_cov()):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    np.testing.assert_allclose(
        tfid.compute_fid_from_feature_stats(st, gt),
        jfid.compute_fid_from_feature_stats(sj, gj), rtol=1e-12)
    np.testing.assert_allclose(
        tfid.kernel_inception_distance(real, gen, num_subsets=4,
                                       max_subset_size=20),
        jfid.kernel_inception_distance(real, gen, num_subsets=4,
                                       max_subset_size=20), rtol=1e-12)
    np.testing.assert_allclose(tfid.inception_score(gen, 4),
                               jfid.inception_score(gen, 4), rtol=1e-12)


# ---------------------------------------------------------------------------
# The metric loop and FID over one small engine
# ---------------------------------------------------------------------------

def _engines():
    m = small_model(seed=2)
    (jgen, jenc), (tgen, tenc) = m["jax_cfg"], m["cfg"]
    j = jbrush.TriadGanPaintEngine(
        jgen, m["jax"]["gen_params"], m["jax"]["gen_state"], jenc,
        m["jax"]["enc_params"], m["jax"]["enc_state"],
        geom_inject_resolutions=(0, 1))
    t = tbrush.TriadGanPaintEngine(
        tgen, m["torch"]["gen_params"], m["torch"]["gen_state"], tenc,
        m["torch"]["enc_params"], m["torch"]["enc_state"],
        geom_inject_resolutions=(0, 1), device="cpu")
    return j, t


def _geom_batches(n, b=4, w=40):
    """uint8 triband batches (wider than the patch: both centre-crop)."""
    from brushstroke_engine_torch.train.dataset import \
        SyntheticGeometryDataset
    ds = SyntheticGeometryDataset(w, size=n * b, seed=5)
    return [np.stack([ds[i * b + k] for k in range(b)]) for i in range(n)]


def _jax_loop_draws(seed, n_batches, b, w, stitch=False):
    """What ``paint_engine_metric_loop`` draws per batch in the JAX package,
    as the port's ``metric_draws`` dicts (with ``stitch``, each batch's
    canvas positions of the stitching render under ``"stitch"``)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_batches):
        key, k1, k2, k3 = jax.random.split(key, 4)
        out.append({
            "bg_multicolor": _jax_uniform_bg_draws(k1, b, w, False),
            "bg_same": _jax_uniform_bg_draws(k2, b, w, True),
            "across_geo": np.asarray(jax.random.permutation(k3, b))})
        if stitch:
            key, ks = jax.random.split(key)
            k_pos = jax.random.split(ks, 3)[0]
            out[-1]["stitch"] = {"positions1": np.asarray(
                jax.random.randint(k_pos, (b, 2), 0, w - 1))}
    return out


def test_paint_engine_metric_loop_matches_jax(tmp_path):
    jeng, teng = _engines()
    geoms = _geom_batches(3)
    jgen = jsg.PaintStrokeGenerator(4, jeng, jsg.RandomState(0))
    tgen = tsg.PaintStrokeGenerator(4, teng, tsg.RandomState(0))
    jgen.set_geometry_source_from_iterator(iter(geoms), 4)
    tgen.set_geometry_source_from_iterator(iter(geoms), 4)
    want = jmm.paint_engine_metric_loop(
        jgen, jlib.RandomBrushLibrary(3, 16), nbatches_per_style=1)
    got = tmm.paint_engine_metric_loop(
        tgen, tlib.RandomBrushLibrary(3, 16), nbatches_per_style=1,
        eval_output_dir=str(tmp_path), draws=_jax_loop_draws(0, 3, 4, 32))
    assert set(got) == set(want) == {
        "LAB_E%", "LAB_L2", "BG_CLARITY_MEAN", "FG_OPACITY_MEDIAN",
        "LPIPS_UNIFORM_BG_multicolor", "LPIPS_UNIFORM_BG",
        "LPIPS_ACROSS_GEO"}
    for k in want:
        if k == "LAB_E%":
            # One pixel of the smallest foreground, over the batch.
            atol = 100.0 / (4 * float((geoms[0][..., 1] < 128).sum(
                axis=(1, 2)).clip(1).min()))
            assert abs(got[k] - want[k]) <= atol, (got[k], want[k])
        else:
            _close(got[k], want[k], LOOP_RTOL, LOOP_ATOL, k)
    assert {"style_metrics.txt", "summary_metrics.txt", "style_ws.pkl"} <= \
        {p.name for p in tmp_path.iterdir()}
    # With a stitcher (it raised before the stitching was ported): the
    # stitching metrics join the loop's, from the JAX package's draws --
    # the first crop from the generator's RandomState on both sides, the
    # second from a global ``random`` seeded like the port's own stream,
    # the canvas positions replayed from the JAX key.
    from brushstroke_engine_tpu.train.stitching import RandomStitcher as JSt
    from brushstroke_engine_torch.train.stitching import RandomStitcher as TSt
    full = _geom_batches(2, w=48)
    jgen = jsg.PaintStrokeGenerator(4, jeng, jsg.RandomState(1))
    tgen = tsg.PaintStrokeGenerator(4, teng, tsg.RandomState(1))
    jgen.set_geometry_source_from_iterator(iter(geoms), 4)
    tgen.set_geometry_source_from_iterator(iter(geoms), 4)
    draws = _jax_loop_draws(1, 2, 4, 32, stitch=True)
    random.seed(1)
    want = jmm.paint_engine_metric_loop(
        jgen, jlib.RandomBrushLibrary(2, 16), nbatches_per_style=1,
        fullres_geom_iterator=iter(full),
        stitcher=JSt(crop_margin=2, min_overlap=8))
    got = tmm.paint_engine_metric_loop(
        tgen, tlib.RandomBrushLibrary(2, 16), nbatches_per_style=1,
        fullres_geom_iterator=iter(full),
        stitcher=TSt(crop_margin=2, min_overlap=8), draws=draws)
    assert set(got) == set(want) and {"STITCH_LPIPS", "STITCH_L1"} <= \
        set(got)
    for k in ("STITCH_LPIPS", "STITCH_L1"):
        _close(got[k], want[k], LOOP_RTOL, LOOP_ATOL, k)


def test_forger_compute_fid_matches_jax():
    jeng, teng = _engines()
    geoms = _geom_batches(2)
    real = [np.random.RandomState(20 + i).randint(0, 256, (4, 32, 32, 3))
            .astype(np.uint8) for i in range(2)]
    jgen = jsg.PaintStrokeGenerator(4, jeng, jsg.RandomState(3))
    tgen = tsg.PaintStrokeGenerator(4, teng, tsg.RandomState(3))
    jgen.set_geometry_source_from_iterator(iter(geoms), 4)
    tgen.set_geometry_source_from_iterator(iter(geoms), 4)
    detector_j = jfid.InceptionFeatures.random_init(0)
    jfid.set_default_extractor(detector_j)
    try:
        want = jmm.forger_compute_fid(jgen, real, num_items=8)
    finally:
        jfid.set_default_extractor(None)
    got = tmm.forger_compute_fid(tgen, real, num_items=8)
    assert np.isfinite(got) and got > 0
    _close(got, want, LOOP_RTOL, LOOP_ATOL)
    # The generated statistics: the same strokes in both packages.
    assert tgen.engine.render_mode == "full"
