"""The port's W-space tools (``tools/latent.py``), the clarity finetune
(``tools/clarity.py``), the CLIP style optimizer and the seven CLIs of the
brush-creation workflow against the JAX package on the CPU, with the 32-px
test generator of ``tests/torch_helpers.py``.

The CLIs run in process on the same files: the JAX package's scripts
(``scripts/*.py``, its ``main`` with ``sys.argv`` set) and the port's
(``tools/*.py`` with ``--device cpu``).  The port's projection gets the JAX
package's w-noise draws (``tests.torch_helpers.jax_draws``), since its own
come from a torch generator.  Every JAX optimization runs once.

Tolerances: 1e-5 (relative and absolute) for single evaluations (W vectors,
embeddings, scores); uint8 sheets within 1 LSB; multi-step optimizations
1e-4 relative plus Adam's lr bound (``tests/test_torch_projection.py``).
"""

import contextlib
import io
import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brushstroke_engine_tpu.engine import brush as jbrush
from brushstroke_engine_tpu.ops.precision import precision_mode
from brushstroke_engine_tpu.tools import clarity as jclarity
from brushstroke_engine_tpu.tools import clip_search as jcs
from brushstroke_engine_tpu.tools import latent as jlatent
from brushstroke_engine_torch.engine import brush as tbrush
from brushstroke_engine_torch.ops.precision import set_precision_mode
from brushstroke_engine_torch.tools import (
    clarity as tclarity, clip_search as tcs, clip_search_main,
    get_ws_main, latent as tlatent, make_synthetic_media, opt_clarity_main,
    project_main, projection as tproj, seed_expand, visualize_pca_main,
)
from brushstroke_engine_torch.utils import reference_layout as rl
from brushstroke_engine_torch.utils.checkpoint import EngineBundle, \
    save_native
from brushstroke_engine_torch.utils.img_proc import read_png
from tests.torch_helpers import assert_optimized_close, jax_draws, \
    run_script, small_model

set_precision_mode("strict")

TOL = dict(rtol=1e-5, atol=1e-5)
QUERY = "a dark ink stroke"
MERGES = rl.bpe_merges_for(["a", "dark", "ink", "stroke"])
# One head of 64 (the converters take width // 64 heads), image 32 px (the
# generator's, so no resize), one layer per tower.
CLIP_WIDTHS = dict(embed_dim=16, image_resolution=32, vision_patch=8,
                   vision_width=64, vision_layers=1, text_width=64,
                   text_layers=1, context_length=16,
                   vocab_size=512 + len(MERGES) + 2)


@pytest.fixture(scope="module")
def model():
    return small_model(seed=3)


def _engines(model):
    jgen, jenc = model["jax_cfg"]
    tgen, tenc = model["cfg"]
    j = jbrush.TriadGanPaintEngine(
        jgen, model["jax"]["gen_params"], model["jax"]["gen_state"], jenc,
        model["jax"]["enc_params"], model["jax"]["enc_state"],
        geom_inject_resolutions=(0, 1))
    t = tbrush.TriadGanPaintEngine(
        tgen, model["torch"]["gen_params"], model["torch"]["gen_state"], tenc,
        model["torch"]["enc_params"], model["torch"]["enc_state"],
        geom_inject_resolutions=(0, 1), device="cpu")
    return j, t


def geometry_batches(batch=2, width=32, seed=0):
    rng = np.random.RandomState(seed)
    while True:
        g = np.ones((batch, width, width, 1), np.float32)
        y = rng.randint(4, width - 12)
        g[:, y:y + 8, 4:width - 4] = 0.0
        yield g


def test_w_stats_and_seeds_equal_jax(model):
    j, t = _engines(model)
    w_avg, w_std = tlatent.get_w_stats(t.gen_cfg, t.gen_params["mapping"],
                                       num_samples=700, seed=2)
    jw_avg, jw_std = jlatent.get_w_stats(j.gen_cfg, j.gen_params["mapping"],
                                         num_samples=700, seed=2)
    np.testing.assert_allclose(w_avg, jw_avg, **TOL)
    np.testing.assert_allclose(w_std, jw_std, **TOL)
    seeds = [1, 5, 9, 12]
    np.testing.assert_allclose(tlatent.ws_for_seeds(t, seeds),
                               jlatent.ws_for_seeds(j, seeds), **TOL)
    np.testing.assert_allclose(tlatent.seed_grid(t, 5, grid=3, seed=1),
                               jlatent.seed_grid(j, 5, grid=3, seed=1),
                               **TOL)
    ws = jlatent.ws_for_seeds(j, list(range(12)))[:, 0, :]
    for got, want in zip(tlatent.pca_directions(ws, 4),
                         jlatent.pca_directions(ws, 4)):
        np.testing.assert_array_equal(got, want)


# The default clarity objective without its L1 term, whose subgradient at
# the start point the two packages take differently (see below).
CLARITY_LOSSES = "0.5*iou_inv(uvs)+0.5*iou(u)+50*lpips(fake_orig)"


def test_optimize_style_clarity_equals_jax(model):
    """The IoU terms and LPIPS against the frozen render, with the style's
    own noise textures, 3 steps."""
    j, t = _engines(model)
    w0 = jlatent.ws_for_seeds(j, [7])
    rng = np.random.RandomState(4)
    noise = {k: rng.randn(*np.asarray(v).shape).astype(np.float32)
             for k, v in j.gen_state["noise"].items()}
    cfg = tclarity.ClarityConfig(num_steps=3, losses=CLARITY_LOSSES)
    with precision_mode("strict"):
        want = jclarity.optimize_style_clarity(
            j, w0, geometry_batches(), jclarity.ClarityConfig(
                num_steps=3, losses=CLARITY_LOSSES),
            noise_buffers={k: jnp.asarray(v) for k, v in noise.items()})
    got = tclarity.optimize_style_clarity(t, w0, geometry_batches(), cfg,
                                          noise_buffers=noise)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert_optimized_close(got["w"], want["w"], 3 * cfg.learning_rate)
    assert not np.allclose(got["w"], w0)


def test_clarity_l1_term_at_the_start_point(model):
    """``l1(fake_orig)`` alone is at its minimum (0) where the optimization
    starts.  The port renders the frozen and the current W bit-equal there,
    so the term's subgradient is 0 and the style stays.  The JAX package's
    jitted step renders them with rounding differences (~1e-7), whose
    signs, times 50 and normalized by Adam, move the style by a step."""
    j, t = _engines(model)
    w0 = jlatent.ws_for_seeds(j, [7])
    cfg = dict(num_steps=2, losses="50*l1(fake_orig)")
    with precision_mode("strict"):
        want = jclarity.optimize_style_clarity(
            j, w0, geometry_batches(), jclarity.ClarityConfig(**cfg))
    got = tclarity.optimize_style_clarity(
        t, w0, geometry_batches(), tclarity.ClarityConfig(**cfg))
    assert got["loss"] == 0.0
    np.testing.assert_array_equal(got["w"], w0)
    assert want["loss"] > 0.0
    assert np.abs(want["w"] - w0).max() > 0.5 * 0.01


def test_clip_style_optimizer_equals_jax(model, monkeypatch):
    """Hashing backbone (the JAX package's image weights carried across,
    its word seeds replaced by the port's stable ones), noise optimized,
    3 steps: w, noise and both losses."""
    j, t = _engines(model)
    jb = jcs.HashingBackbone(0, 32)
    tb = tcs.HashingBackbone(0, 32, device="cpu", conv=np.asarray(jb._conv),
                             proj=np.asarray(jb._proj))
    monkeypatch.setattr(jcs, "hash", lambda key: tcs.word_seed(*key),
                        raising=False)
    w0 = jlatent.ws_for_seeds(j, [3])
    cfg = tcs.ClipOptConfig(num_steps=3, optimize_noise=True)
    with precision_mode("strict"):
        want = jcs.ClipStyleOptimizer(
            j, jb, jcs.ClipOptConfig(**cfg.__dict__)).optimize(
            QUERY, w0, geometry_batches(), seed=1)
    got = tcs.ClipStyleOptimizer(t, tb, cfg).optimize(
        QUERY, w0, geometry_batches(), seed=1)
    for key in ("loss", "clip_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    lr_total = 3 * cfg.learning_rate
    assert_optimized_close(got["w"], want["w"], lr_total)
    assert list(got["noise"]) == sorted(want["noise"])
    for k, v in want["noise"].items():
        assert_optimized_close(got["noise"][k], v, lr_total)


def _run_port(cli, argv):
    """The port's CLI ``main`` on the CPU (the media maker, numpy only, has
    no device flag); returns its result and standard output."""
    argv = [str(a) for a in argv]
    if cli is not make_synthetic_media:
        argv += ["--device", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = cli.main(argv)
    return result, out.getvalue()


@pytest.fixture(scope="module")
def workflow(tmp_path_factory, model):
    """The brush-creation workflow through both packages' CLIs: media,
    projection of two targets, the clarity finetune, CLIP search with
    --optimize, W dumps, the seed grid and the PCA sweeps."""
    root = tmp_path_factory.mktemp("workflow")
    tgen, tenc = model["cfg"]
    tt = model["torch"]
    bundle = str(root / "bundle.pkl")
    save_native(bundle, EngineBundle(
        tgen, tt["gen_params"], tt["gen_state"], tenc, tt["enc_params"],
        tt["enc_state"], geom_inject_resolutions=(0, 1)))
    clip_w, clip_bpe = str(root / "clip.pt"), str(root / "bpe.txt.gz")
    torch.save(rl.clip_state_dict(seed=2, widths=CLIP_WIDTHS), clip_w)
    rl.write_bpe_merges(clip_bpe, MERGES)
    out = {"root": root}
    for pkg in ("jax", "port"):
        (root / pkg).mkdir()
    media = ["--num_images", 2, "--resolution", 48, "--seed", 7]
    out["media"] = (
        run_script("make_synthetic_media",
                    ["--output_dir", root / "jax" / "media"] + media),
        _run_port(make_synthetic_media,
                  ["--output_dir", root / "port" / "media"] + media))
    targets = sorted(str(p) for p in (root / "port" / "media").iterdir())

    num_ws, w_dim = tgen.num_ws, tgen.w_dim
    draws = jax_draws(0, 3, 100, (1, num_ws, w_dim), n=2)
    proj = ["--gan_checkpoint", bundle, "--target_image", *targets,
            "--num_steps", 3, "--num_patches", 2, "--l1_fg_weight", 0.5]
    run_script("project_main", proj + ["--output_dir", root / "jax" / "proj"])
    parallel = tproj.project_parallel
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tproj, "project_parallel",
                   lambda *a, **k: parallel(*a, draws=draws, **k))
        out["proj"] = _run_port(
            project_main, proj + ["--output_dir", root / "port" / "proj"])
    out["skip"] = _run_port(project_main, proj + [
        "--output_dir", root / "port" / "proj", "--skip_existing"])

    library = str(root / "jax" / "proj" / "ALL_projected_styles.pkl")
    clar = ["--gan_checkpoint", bundle, "--library", library,
            "--num_steps", 2, "--batch_size", 2, "--losses", CLARITY_LOSSES]
    run_script("opt_clarity_main",
                clar + ["--output_dir", root / "jax" / "opt"])
    _run_port(opt_clarity_main,
              clar + ["--output_dir", root / "port" / "opt"])

    search = ["--gan_checkpoint", bundle, "--library", library,
              "--query", QUERY, "--top_k", 2, "--optimize",
              "--num_steps", 2, "--clip_weights", clip_w,
              "--clip_bpe", clip_bpe]
    out["search"] = (
        run_script("clip_search_main",
                    search + ["--output_dir", root / "jax" / "clip"]),
        _run_port(clip_search_main,
                  search + ["--output_dir", root / "port" / "clip"]))
    out["hashing"] = _run_port(clip_search_main, [
        "--gan_checkpoint", bundle, "--library", library, "--query", QUERY,
        "--output_dir", root / "port" / "hashing"])

    for pkg, run in (("jax", run_script), ("port", None)):
        d = root / pkg
        specs = [
            ("get_ws_main", get_ws_main,
             ["--seeds", "0-5", "--output_file", d / "ws.bin"]),
            ("seed_expand", seed_expand,
             ["--seed", 7, "--grid", 2, "--output_dir", d / "grid"]),
            ("visualize_pca_main", visualize_pca_main,
             ["--num_seeds", 12, "--num_components", 2, "--num_steps", 2,
              "--output_dir", d / "pca"]),
        ]
        for name, cli, argv in specs:
            argv = ["--gan_checkpoint", bundle] + argv
            if run:
                run(name, argv)
            else:
                _run_port(cli, argv)
    return out


def _png(path):
    with open(path, "rb") as f:
        return read_png(f.read()).astype(np.int32)


def _pkl(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_make_synthetic_media_cli_equals_jax(workflow):
    root = workflow["root"]
    names = sorted(os.listdir(root / "jax" / "media"))
    assert names == sorted(os.listdir(root / "port" / "media")) \
        and len(names) == 2
    for n in names:
        np.testing.assert_array_equal(_png(root / "port" / "media" / n),
                                      _png(root / "jax" / "media" / n))


def test_project_main_cli_equals_jax(workflow):
    """Both targets projected in one parallel run: the npz per style and
    the aggregate library; ``--skip_existing`` skips both."""
    root = workflow["root"]
    got_lib = _pkl(root / "port" / "proj" / "ALL_projected_styles.pkl")
    want_lib = _pkl(root / "jax" / "proj" / "ALL_projected_styles.pkl")
    assert sorted(got_lib) == sorted(want_lib) and len(got_lib) == 2
    lr_total = sum(tproj._lr_schedule(
        tproj.ProjectionConfig(num_steps=3), s) for s in range(3))
    for name in want_lib:
        got = np.load(root / "port" / "proj" / f"{name}.npz")
        want = np.load(root / "jax" / "proj" / f"{name}.npz")
        assert sorted(got.files) == sorted(want.files)
        assert int(got["step"]) == int(want["step"])
        np.testing.assert_allclose(got["bg"], want["bg"], **TOL)
        for key in want.files:
            if key not in ("step", "bg"):
                assert_optimized_close(got[key], want[key], lr_total)
        assert_optimized_close(got_lib[name]["w"], want_lib[name]["w"],
                               lr_total)
    result, _ = workflow["skip"]
    assert result == {}


def test_opt_clarity_cli_equals_jax(workflow):
    root = workflow["root"]
    got = _pkl(root / "port" / "opt" / "OPT_ALL_projected_styles.pkl")
    want = _pkl(root / "jax" / "opt" / "OPT_ALL_projected_styles.pkl")
    assert sorted(got) == sorted(want) and len(got) == 2
    for name, entry in want.items():
        assert_optimized_close(got[name]["w"], entry["w"], 2 * 0.01)
        assert sorted(got[name]["noise"]) == sorted(entry["noise"])
        for k, v in entry["noise"].items():
            np.testing.assert_array_equal(got[name]["noise"][k], v)


def _top_lines(stdout):
    lines = stdout.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("Top"))
    rows = [ln.split(":") for ln in lines[start + 1:]
            if ln.startswith("  ")]
    return [(k.strip(), float(v)) for k, v in rows]


def test_clip_search_cli_equals_jax(workflow):
    """The CLIP backbone over the same checkpoint: the backbone line, the
    dictionary, the ranking and scores, and the optimized style."""
    root = workflow["root"]
    want_out, (got_res, got_out) = workflow["search"]
    assert got_out.splitlines()[0] == want_out.splitlines()[0] \
        == "Backbone kind: clip"
    want_top, got_top = _top_lines(want_out), _top_lines(got_out)
    assert [k for k, _ in got_top] == [k for k, _ in want_top]
    np.testing.assert_allclose([s for _, s in got_top],
                               [s for _, s in want_top], atol=1e-4)
    np.testing.assert_allclose(
        _pkl(root / "port" / "clip" / "style_dict.pkl")["features"],
        _pkl(root / "jax" / "clip" / "style_dict.pkl")["features"], **TOL)
    key = QUERY.replace(" ", "_")
    got = _pkl(root / "port" / "clip" / f"CLIP_{key}.pkl")
    want = _pkl(root / "jax" / "clip" / f"CLIP_{key}.pkl")
    assert list(got) == list(want) == [key]
    assert_optimized_close(got[key]["w"], want[key]["w"], 2 * 0.02)
    res, out = workflow["hashing"]
    assert res["backbone"] == "hashing" and "NOT semantic" in out


def test_w_space_clis_equal_jax(workflow):
    """get_ws_main's float64 dump, seed_expand's grid and the PCA sweeps."""
    root = workflow["root"]
    np.testing.assert_allclose(
        np.fromfile(root / "port" / "ws.bin", np.float64),
        np.fromfile(root / "jax" / "ws.bin", np.float64), **TOL)
    sheets = [("grid", "seed7_grid.png"), ("pca", "pca_0.png"),
              ("pca", "pca_1.png")]
    for sub, name in sheets:
        got = _png(root / "port" / sub / name)
        want = _png(root / "jax" / sub / name)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1
