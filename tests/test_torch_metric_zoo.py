"""The port's metric zoo against the JAX package's on the CPU, strict f32:
the VGG16 detector of precision / recall, the k-th neighbour distances, the
precision / recall scores, the perceptual path length, the stitching sheet,
the PNG reader that needs no Pillow, and the four CLIs (``calc_metrics``,
``metric_main``, ``fid_from_images``, ``visualize_stitching``).

Small shapes: 32 px, B <= 4, the slim VGG16 (and a torchvision-layout state
dict at the slim widths), seeded numpy inputs and asymmetric weights.

Tolerances (set before the runs):
  * VGG16 features: 1e-4 of the largest feature (f32 convolutions and
    products summed in other orders);
  * k-th neighbour squared distances: 1e-5 relative;
  * precision and recall: exactly equal, on clustered features whose
    pairwise distances are far apart from each other;
  * PPL per-sample distances d = LPIPS / epsilon^2: 1e-4 relative at
    epsilon 1e-2 and 2e-2 at the default 1e-4 (dividing by epsilon^2 = 1e-8
    magnifies every rounding of the two renders), each plus the f32 floor
    of LPIPS itself: LPIPS sums squared differences of unit-normalized
    features, each rounded to ~u = 2^-24 of its size, so two renders whose
    features differ by |df| ~ sqrt(LPIPS) carry a relative error ~u /
    sqrt(LPIPS); the bound adds 8 u sqrt(d) / epsilon.  The small random
    generator moves little with w (d ~ 1e-4..1e-1 here, LPIPS down to
    ~7e-12 at epsilon 1e-4), where that floor exceeds both relative bounds
    (first runs: 5.7e-4 relative at epsilon 1e-2 for d = 6.5e-4, 2.6e-2 at
    1e-4 for d = 7e-4);
  * the stitching sheet's rows at the correct positions: 1 LSB;
  * the PNG reader: the arrays Pillow reads, bit for bit.
"""

import json
import os
import random
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brushstroke_engine_tpu.engine import brush as jbrush
from brushstroke_engine_tpu.metrics import ppl as jppl
from brushstroke_engine_tpu.metrics import pr as jpr
from brushstroke_engine_tpu.models.geo_encoder import geo_encoder_encode as \
    jencode
from brushstroke_engine_tpu.ops.precision import set_precision_mode as jset
from brushstroke_engine_tpu.viz import visualize as jviz
from brushstroke_engine_torch.engine import brush as tbrush
from brushstroke_engine_torch.metrics import ppl as tppl
from brushstroke_engine_torch.metrics import pr as tpr
from brushstroke_engine_torch.models.geo_encoder import geo_encoder_encode \
    as tencode
from brushstroke_engine_torch.ops.precision import set_precision_mode as tset
from brushstroke_engine_torch.tools import (
    calc_metrics, fid_from_images, metric_main, visualize_stitching,
)
from brushstroke_engine_torch.train.dataset import ImageFolderDataset
from brushstroke_engine_torch.utils.checkpoint import EngineBundle, \
    save_native
from brushstroke_engine_torch.utils.img_proc import read_png, write_png
from brushstroke_engine_torch.viz import visualize as tviz
from tests.torch_helpers import small_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _strict():
    jset("strict")
    tset("strict")
    yield


# ---------------------------------------------------------------------------
# Precision / recall
# ---------------------------------------------------------------------------

def _torchvision_slim_state(seed):
    """A torchvision ``vgg16`` state dict (OIHW convs, classifier.0/.3) at
    the slim widths, with asymmetric seeded weights and biases."""
    rng = np.random.RandomState(seed)
    state, cin, idx = {}, 3, 0
    for spec in tpr._VGG_PLAN:
        if spec == "M":
            idx += 1
            continue
        cout = int(spec) // 8
        state[f"features.{idx}.weight"] = (rng.randn(cout, cin, 3, 3) * np.sqrt(
            2.0 / (9 * cin))).astype(np.float32)
        state[f"features.{idx}.bias"] = (rng.randn(cout) * 0.1).astype(
            np.float32)
        cin, idx = cout, idx + 2
    fin = cin * 49
    for i, fout in ((0, 48), (3, 40)):
        state[f"classifier.{i}.weight"] = (rng.randn(fout, fin) * np.sqrt(
            2.0 / fin)).astype(np.float32)
        state[f"classifier.{i}.bias"] = (rng.randn(fout) * 0.1).astype(
            np.float32)
        fin = fout
    return state


@pytest.mark.parametrize("source", ["random", "torch_state"])
@pytest.mark.parametrize("images", ["uint8_32px", "float_224px"])
def test_vgg16_features_match_jax(source, images):
    rng = np.random.RandomState(5)
    if images == "uint8_32px":
        x = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    else:
        x = rng.rand(2, 224, 224, 3).astype(np.float32)
    if source == "random":
        jm, tm = jpr.VGG16Features.random_init(3), \
            tpr.VGG16Features.random_init(3)
        assert tm.kind == jm.kind == "vgg16_random"
    else:
        state = _torchvision_slim_state(4)
        jm = jpr.VGG16Features.from_torch_state(state)
        tm = tpr.VGG16Features.from_torch_state(
            {k: torch.from_numpy(v) for k, v in state.items()})
        assert tm.kind == jm.kind == "vgg16"
    for a, b in zip(tm.convs + tm.fcs, jm.convs + jm.fcs):
        for k in ("weight", "bias"):
            np.testing.assert_array_equal(a[k], b[k])
    want = np.asarray(jpr.vgg16_extract_features(jnp.asarray(x), jm))
    got = tpr.vgg16_extract_features(x, tm, device="cpu").numpy()
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_kth_sq_matches_jax():
    rng = np.random.RandomState(6)
    feats = rng.randn(37, 12).astype(np.float32)
    for k, bs in ((1, 5), (3, 16), (5, 64)):
        want = jpr._kth_sq(feats, k, bs)
        got = tpr._kth_sq(torch.from_numpy(feats), k, bs).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def _clustered(seed, n, centers):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, len(centers), n)
    return (centers[idx] + rng.randn(n, centers.shape[1]) * 0.3).astype(
        np.float32)


def test_compute_pr_equals_jax_on_clustered_features():
    centers = np.random.RandomState(7).randn(6, 16).astype(np.float32) * 10
    real = _clustered(8, 40, centers[:5])
    gen = _clustered(9, 33, centers[1:])
    # Distances far apart: the coverage predicate has a wide margin.
    d = ((real[:, None] - gen[None]) ** 2).sum(-1)
    assert np.min(np.abs(d[:, :, None] - d[:, None, :])
                  + np.eye(33) * 1e9) > 1e-3
    for k, bs in ((3, 7), (1, 64)):
        want = jpr.compute_pr(real, gen, nhood_size=k, row_batch_size=bs)
        got = tpr.compute_pr(real, gen, nhood_size=k, row_batch_size=bs,
                             device="cpu")
        assert got == want, (k, got, want)
        assert 0 < got[0] < 1 and 0 < got[1] < 1


# ---------------------------------------------------------------------------
# Perceptual path length
# ---------------------------------------------------------------------------

def _engines(m):
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


@pytest.fixture(scope="module")
def model():
    return small_model(seed=5)


@pytest.mark.parametrize("space", ["w", "z"])
def test_ppl_distances_match_jax(model, space, monkeypatch):
    jeng, teng = _engines(model)
    geom = (np.random.RandomState(2).rand(1, 32, 32, 1) > 0.5).astype(
        np.float32)
    jf = jencode(jeng.enc_cfg, jeng.enc_params, jeng.enc_state,
                 jnp.asarray(geom), res=[0, 1])
    tf = tencode(teng.enc_cfg, teng.enc_params, teng.enc_state,
                 torch.from_numpy(geom), res=[0, 1])
    seen = []
    inner = jppl.lpips_batched
    monkeypatch.setattr(jppl, "lpips_batched",
                        lambda a, b: seen.append(np.asarray(inner(a, b)))
                        or seen[-1])
    u = 2.0 ** -24
    for eps, rtol in ((1e-2, 1e-4), (1e-4, 2e-2)):
        seen.clear()
        want_ppl = jppl.compute_ppl(jeng, jf, num_samples=6, epsilon=eps,
                                    space=space, batch=4, seed=3)
        want = np.concatenate(seen) / eps ** 2
        got = tppl.ppl_distances(teng, tf, num_samples=6, epsilon=eps,
                                 space=space, batch=4, seed=3)
        assert got.shape == (6,) and np.all(got > 0)
        bound = rtol * want + 8 * u * np.sqrt(want) / eps
        assert np.all(np.abs(got - want) <= bound), (eps, got, want)
        got_ppl = tppl.compute_ppl(teng, tf, num_samples=6, epsilon=eps,
                                   space=space, batch=4, seed=3)
        assert abs(got_ppl - want_ppl) <= rtol * want_ppl + 8 * u * np.sqrt(
            want_ppl) / eps, (eps, got_ppl, want_ppl)


# ---------------------------------------------------------------------------
# The stitching sheet
# ---------------------------------------------------------------------------

def test_visualize_stitching_matches_jax(model, tmp_path):
    jeng, teng = _engines(model)
    jv = jviz.TrainingVisualizer(width=32, num_fixed_styles=2, seed=1)
    tv = tviz.TrainingVisualizer(width=32, num_fixed_styles=2, seed=1)
    jv.init(16)
    tv.init(16)
    want = jv.visualize_stitching(str(tmp_path / "j"), jeng, "t")
    got = tv.visualize_stitching(str(tmp_path / "t"), teng, "t")
    assert got.shape == want.shape == (64, 64, 3)
    # The top row renders at the correct canvas positions (0, 0), (0, 16).
    top = np.abs(got[:32].astype(int) - want[:32].astype(int))
    assert top.max() <= 1
    assert not np.array_equal(got[:32], got[32:])
    with open(tmp_path / "t" / "stitching_t.png", "rb") as f:
        assert np.array_equal(read_png(f.read()), got)


# ---------------------------------------------------------------------------
# Reading PNGs without Pillow
# ---------------------------------------------------------------------------

def test_image_folder_reads_pngs_without_pillow(tmp_path, monkeypatch):
    import PIL.Image
    rng = np.random.RandomState(9)
    imgs = {"gray.png": rng.randint(0, 256, (20, 24), np.uint8),
            "rgb.png": rng.randint(0, 256, (20, 24, 3), np.uint8),
            "rgba.png": rng.randint(0, 256, (20, 24, 4), np.uint8)}
    for name, a in imgs.items():
        PIL.Image.fromarray(a).save(tmp_path / name, optimize=True)
    write_png(str(tmp_path / "zlib.png"), imgs["rgb.png"])
    want = {}
    for channels in (1, 3, 4):
        ds = ImageFolderDataset(str(tmp_path), 16, channels=channels)
        want[channels] = {n: ds._read(n) for n in ds.names}
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    for channels in (1, 3, 4):
        ds = ImageFolderDataset(str(tmp_path), 16, channels=channels)
        assert set(ds.names) == set(want[channels]) and len(ds.names) == 4
        for n in ds.names:
            assert np.array_equal(ds._read(n), want[channels][n]), \
                (channels, n)


# ---------------------------------------------------------------------------
# The CLIs on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bundle_and_styles(model, tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo")
    t = model["torch"]
    gen_cfg, enc_cfg = model["cfg"]
    path = str(root / "bundle.pkl")
    save_native(path, EngineBundle(
        gen_cfg, t["gen_params"], t["gen_state"], enc_cfg, t["enc_params"],
        t["enc_state"], geom_inject_resolutions=(0, 1)))
    folders = []
    for k in range(2):
        rng = np.random.RandomState(30 + k)
        d = root / f"styles{k}"
        for i in range(8):
            write_png(str(d / f"{i:02d}.png"),
                      rng.randint(0, 256, (36, 40, 3), np.uint8))
        folders.append(str(d))
    return path, folders, root


def test_calc_metrics_cli_on_cpu(bundle_and_styles, capsys):
    bundle, (styles, _), root = bundle_and_styles
    out_path = str(root / "zoo.json")
    out = calc_metrics.main([
        "--gan_checkpoint", bundle, "--data", styles, "--metrics",
        "fid,fid_fadecanvas,kid,is,pr,ppl_w,ppl_z", "--num_items", "8",
        "--batch_size", "4", "--device", "cpu", "--out", out_path])
    values = {"fid", "fid_fadecanvas", "kid", "is", "precision", "recall",
              "ppl_w", "ppl_z"}
    assert set(out) == values | {"detector", "seconds"}
    assert all(np.isfinite(out[k]) for k in values)
    assert out["detector"] == "random"
    assert {"gen_images", "gen_features", "real_features"} | {
        "fid", "fid_fadecanvas", "kid", "is", "pr", "ppl_w", "ppl_z"} == \
        set(out["seconds"])
    with open(out_path) as f:
        assert json.loads(f.read()) == out
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


def _manifest(root, **proto):
    p = {"metrics": "is,pr", "num_items": 8, "batch_size": 4, "seed": 0,
         "detector": "random"}
    p.update(proto)
    path = str(root / f"manifest_{len(os.listdir(root))}.json")
    with open(path, "w") as f:
        json.dump({"protocol": p, "recorded": {
            "round": 3, "precision": 0.25, "is": 1.0}}, f)
    return path


def test_calc_metrics_manifest_pins_and_checks(bundle_and_styles):
    bundle, (styles, _), root = bundle_and_styles
    base = ["--gan_checkpoint", bundle, "--data", styles, "--device", "cpu"]
    out = calc_metrics.main(base + ["--manifest", _manifest(root)])
    assert set(out["vs_recorded"]) == {"precision", "is"}
    assert out["vs_recorded"]["is"] == round(out["is"] - 1.0, 6)
    # A flag the manifest pins, passed with another value: an error; the
    # pinned value itself is accepted.
    with pytest.raises(SystemExit) as e:
        calc_metrics.main(base + ["--num_items", "5", "--manifest",
                                  _manifest(root)])
    assert e.value.code == 2
    calc_metrics.main(base + ["--batch_size", "4", "--manifest",
                              _manifest(root, metrics="is")])
    with pytest.raises(SystemExit, match="detector kind"):
        calc_metrics.main(base + ["--manifest",
                                  _manifest(root, detector="inception_v3")])
    with pytest.raises(ValueError, match="unknown metric"):
        calc_metrics.main(base + ["--metrics", "fid,nope"])


def test_metric_main_cli_with_stitching(bundle_and_styles, capsys):
    bundle, _, root = bundle_and_styles
    out_dir = root / "metric_main"
    random.seed(0)
    summary = metric_main.main([
        "--gan_checkpoint", bundle, "--eval_output_dir", str(out_dir),
        "--library", "rand2", "--batch_size", "4", "--enable_stitching",
        "--device", "cpu"])
    assert {"STITCH_LPIPS", "STITCH_L1", "LPIPS_ACROSS_GEO"} <= set(summary)
    assert all(np.isfinite(v) for v in summary.values())
    assert {"style_metrics.txt", "summary_metrics.txt", "style_ws.pkl",
            "all_summary.txt"} == set(os.listdir(out_dir))
    with open(out_dir / "all_summary.txt") as f:
        head, line = f.read().splitlines()
    assert head.split() == sorted(summary) and len(line.split()) == len(
        summary)
    assert capsys.readouterr().out.strip().endswith(line.strip())


def test_fid_from_images_cli_with_pr(bundle_and_styles, capsys):
    _, (a, b), _ = bundle_and_styles
    out = fid_from_images.main(["--images0", a, "--images1", b,
                                "--resolution", "32", "--batch_size", "4",
                                "--pr", "--device", "cpu"])
    assert set(out) == {"fid", "detector", "precision", "recall"}
    assert np.isfinite(out["fid"]) and 0 <= out["precision"] <= 1
    text = capsys.readouterr().out
    assert "FID:" in text and "precision:" in text and "recall:" in text


def test_visualize_stitching_cli(bundle_and_styles):
    bundle, _, root = bundle_and_styles
    paths = visualize_stitching.main([
        "--gan_checkpoint", bundle, "--output_dir", str(root / "sheets"),
        "--num_styles", "2", "--device", "cpu"])
    assert [os.path.basename(p) for p in paths] == [
        "stitching_style0.png", "stitching_style1.png"]
    for p in paths:
        with open(p, "rb") as f:
            assert read_png(f.read()).shape == (64, 64, 3)
