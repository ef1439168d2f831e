"""The port's render slice against the JAX package on the CPU: render_core,
the triad paint engine (render_stroke, render_batch, UVS mapping), native
bundles, the device rule of the entry points, and the import boundary.

Tolerances: 2e-5 abs on RGBA/uvs/colors in [0, 1] (f32 sums reordered
through encoder, mapping and 13 synthesis layers); the sfactor within 1e-4
relative (it is 1 / a k-th largest value, so it carries the relative error
of one uvs entry); uint8 patches within 1 LSB (rounding of values that
differ by ~1e-6 can flip the last bit).
"""

import dataclasses
import os
import pkgutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import brushstroke_engine_torch
from brushstroke_engine_tpu.engine import brush as jbrush
from brushstroke_engine_tpu.engine.render import render_core as jrender_core
from brushstroke_engine_tpu.ops.precision import precision_mode
from brushstroke_engine_tpu.utils.checkpoint import EngineBundle, save_native
from brushstroke_engine_torch.engine import brush as tbrush
from brushstroke_engine_torch.engine.canvas import PaintingHelper
from brushstroke_engine_torch.engine.device_canvas import (
    DevicePaintSession, init_canvas_state,
)
from brushstroke_engine_torch.engine.render import render_core
from brushstroke_engine_torch.engine.stylize import stylize_image_ondevice
from brushstroke_engine_torch.metrics import fid as tfid
from brushstroke_engine_torch.metrics import inception as tinc
from brushstroke_engine_torch.metrics import lpips as tlpips
from brushstroke_engine_torch.metrics.stroke_generator import \
    PaintStrokeGenerator
from brushstroke_engine_torch.tools import (
    bench_serve, clip_model, clip_search, clip_search_main, get_ws_main,
    opt_clarity_main, paint_image, project_main, seed_expand,
    visualize_pca_main,
)
from brushstroke_engine_torch.tools import train as ttrain
from brushstroke_engine_torch.train.eval_hooks import make_eval_hooks
from brushstroke_engine_torch.train.loop import TrainingLoop
from brushstroke_engine_torch.viz.visualize import TrainingVisualizer
from brushstroke_engine_torch.ui import core as ui_core
from brushstroke_engine_torch.ui import server as ui_server
from brushstroke_engine_torch.ops.precision import set_precision_mode
from brushstroke_engine_torch.utils import checkpoint as tckpt
from tests.torch_helpers import small_model

set_precision_mode("strict")

TOL = dict(rtol=1e-5, atol=2e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _stroke_patch(width=32):
    patch = np.zeros((width, width, 4), np.uint8)
    for i in range(width):
        patch[max(0, i - 3):i + 3, i, 3] = 255
    patch[width // 3:width // 2, 2:width - 2, 3] = 200
    return patch


@pytest.mark.parametrize("style", ["z", "ws"])
@pytest.mark.parametrize("mode", ["clear", "full"])
def test_render_core(model, style, mode):
    rng = np.random.RandomState(11)
    gen_cfg = model["cfg"][0]
    b = 2
    geom = (rng.rand(b, 32, 32, 1) > 0.5).astype(np.float32)
    z = rng.randn(b, 16).astype(np.float32) if style == "z" else None
    ws = rng.randn(b, gen_cfg.num_ws, 16).astype(np.float32) \
        if style == "ws" else None
    positions = np.array([[5, 70], [301, 13]], np.int32)
    noise_buffers = {"b8.conv0.noise_const":
                     rng.randn(8, 8).astype(np.float32),
                     "b32.conv1.noise_const":
                     rng.randn(32, 32).astype(np.float32)}
    override = rng.rand(b, 3, 3).astype(np.float32)
    mask = np.array([[[1.0, 0.0, 1.0]]], np.float32)
    sfactor = np.float32(1.7)

    def j(a):
        return None if a is None else jnp.asarray(a)

    with precision_mode("strict"):
        want = jrender_core(
            *model["jax_cfg"], (0, 1), mode, (), "triad",
            *(model["jax"][k] for k in ("gen_params", "gen_state",
                                        "enc_params", "enc_state")),
            j(geom), j(z), j(ws), j(positions),
            {k: j(v) for k, v in noise_buffers.items()}, j(override),
            j(mask), None, j(sfactor))
    got = render_core(
        *model["cfg"], (0, 1), mode, (), "triad",
        *(model["torch"][k] for k in ("gen_params", "gen_state",
                                      "enc_params", "enc_state")),
        geom, z, ws, positions, noise_buffers, override, mask, None, sfactor,
        device="cpu")
    for k in ("rgba", "uvs", "colors", "raw_img"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)


def test_render_stroke_uint8_and_sfactor(model):
    jeng, teng = _engines(model)
    patch = _stroke_patch()
    for mode in ("clear", "full"):
        jeng.set_render_mode(mode)
        teng.set_render_mode(mode)
        outs = []
        for eng, brush in ((jeng, jbrush), (teng, tbrush)):
            opts = brush.GanBrushOptions(
                primary_color=np.array([200, 30, 90], np.uint8))
            opts.set_style(eng.random_style(5), style_id=5)
            opts.set_position(x=37, y=250)
            opts.enable_uvs_mapping = True
            opts.debug = mode == "full"
            with precision_mode("strict"):
                outs.append(eng.render_stroke(patch, None, opts))
        (j_rgba, j_debug), (t_rgba, t_debug) = outs
        assert t_rgba.dtype == np.uint8 and t_rgba.shape == (32, 32, 4)
        diff = np.abs(j_rgba.astype(int) - t_rgba.astype(int))
        assert diff.max() <= 1, f"{mode}: max uint8 diff {diff.max()}"
        if mode == "full":     # the debug contact sheet
            assert t_debug.shape == j_debug.shape
            assert np.abs(j_debug.astype(int) - t_debug.astype(int)).max() \
                <= 1
    np.testing.assert_allclose(teng.uvs_mapper.sfactors[5],
                               jeng.uvs_mapper.sfactors[5], rtol=1e-4)


def test_render_batch(model):
    jeng, teng = _engines(model)
    rng = np.random.RandomState(12)
    geoms = (rng.rand(3, 32, 32, 1) > 0.5).astype(np.float32)
    outs = []
    for eng, brush in ((jeng, jbrush), (teng, tbrush)):
        opts_list = []
        for i in range(3):
            o = brush.GanBrushOptions(
                secondary_color=np.array([10, 20, 250], np.uint8)
                if i == 1 else None)
            o.set_style(eng.random_style(100 + i))
            o.set_position(x=9 * i, y=40 + i)
            opts_list.append(o)
        with precision_mode("strict"):
            outs.append(eng.render_batch(geoms, opts_list)["rgba"])
    np.testing.assert_allclose(outs[1].numpy(), np.asarray(outs[0]), **TOL)


def test_load_native_bundle_written_by_jax(model, tmp_path):
    jgen, jenc = model["jax_cfg"]
    path = str(tmp_path / "bundle.pkl")
    save_native(path, EngineBundle(
        gen_cfg=jgen, gen_params=model["jax"]["gen_params"],
        gen_state=model["jax"]["gen_state"], enc_cfg=jenc,
        enc_params=model["jax"]["enc_params"],
        enc_state=model["jax"]["enc_state"], color_format="triad",
        geom_inject_resolutions=(0, 1)))
    bundle = tckpt.load_native(path, device="cpu")
    assert (bundle.gen_cfg, bundle.enc_cfg) == model["cfg"]
    assert bundle.geom_inject_resolutions == (0, 1)
    got = jax.tree_util.tree_leaves_with_path(bundle.gen_params)
    want = jax.tree_util.tree_leaves_with_path(model["torch"]["gen_params"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert torch.equal(g, w)
    engine = tbrush.TriadGanPaintEngine(
        bundle.gen_cfg, bundle.gen_params, bundle.gen_state, bundle.enc_cfg,
        bundle.enc_params, bundle.enc_state,
        geom_inject_resolutions=bundle.geom_inject_resolutions, device="cpu")
    opts = tbrush.GanBrushOptions()
    opts.set_style(engine.random_style(1))
    rgba, _ = engine.render_stroke(_stroke_patch(), None, opts)
    assert rgba.shape == (32, 32, 4)


def test_entry_points_need_cuda_unless_cpu(model, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tgen, tenc = model["cfg"]
    trees = [model["torch"][k] for k in ("gen_params", "gen_state",
                                         "enc_params", "enc_state")]
    with pytest.raises(RuntimeError, match="CUDA"):
        tbrush.TriadGanPaintEngine(tgen, *trees[:2], tenc, *trees[2:])
    with pytest.raises(RuntimeError, match="CUDA"):
        tckpt.load_native(str(tmp_path / "missing.pkl"))
    with pytest.raises(RuntimeError, match="CUDA"):
        render_core(tgen, tenc, (0, 1), "clear", (), "triad", *trees,
                    np.ones((1, 32, 32, 1), np.float32),
                    np.zeros((1, 16), np.float32), None, None, None, None,
                    None, None, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbrush.PaintEngineFactory.create(str(tmp_path / "missing.pkl"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tbrush.PaintEngineFactory.create(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_canvas_state(64, 64, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        paint_image.main(["--gan_checkpoint", str(tmp_path / "b.pkl"),
                          "--geo_image", str(tmp_path / "g.npy"),
                          "--output_dir", str(tmp_path)])
    # The server: its core, the tornado shell, its CLI and the bench.
    for make in (lambda: ui_core.create_core(),
                 lambda: ui_server.create_server(None, None),
                 lambda: ui_server.run_main(["--no_warmup"]),
                 lambda: bench_serve.main(["--paths", "helper"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # The brush-creation CLIs and the CLIP backbones.
    bundle = str(tmp_path / "b.pkl")
    for cli, argv in (
            (project_main, ["--target_image", "t.png", "--output_dir", "o"]),
            (opt_clarity_main, ["--library", "l.pkl", "--output_dir", "o"]),
            (clip_search_main, ["--query", "ink", "--output_dir", "o"]),
            (get_ws_main, ["--output_file", "ws.bin"]),
            (seed_expand, ["--seed", "1", "--output_dir", "o"]),
            (visualize_pca_main, ["--output_dir", "o"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--gan_checkpoint", bundle] + argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        clip_search.HashingBackbone()
    with pytest.raises(RuntimeError, match="CUDA"):
        clip_model.load_openai_clip(str(tmp_path / "clip.pt"))
    engine = tbrush.TriadGanPaintEngine(tgen, *trees[:2], tenc, *trees[2:],
                                        geom_inject_resolutions=(0, 1),
                                        device="cpu")
    assert engine.device.type == "cpu"
    # Sessions, helpers and stylizers run where their engine does.
    session = DevicePaintSession(engine, 64, 64, feature_blending_level=2)
    assert session.canvas.features.device.type == "cpu"
    helper = PaintingHelper(engine, style_seed=0)
    helper.make_new_canvas(64, 64, feature_blending=2)
    opts = helper.default_brush_options()
    helper.render_stroke(_stroke_patch(), None, opts, meta={"x": 0, "y": 0})
    assert helper.feature_canvas.features.device.type == "cpu"
    out = stylize_image_ondevice(engine, np.ones((40, 40), np.float32), opts,
                                 overlap_margin=4, crop_margin=4,
                                 feature_blending_level=2, batch_size=2)
    assert out.shape == (56, 56, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        ui_core.create_core(paint_engine=engine)
    assert ui_core.create_core(paint_engine=engine,
                               device="cpu").engine is engine

    # Training: the CLI, the loop, the metric models and the stroke
    # generator.  The eval hooks and the visualizer run where the loop's
    # engine does: a CUDA loop without CUDA fails its hook (counted), a CPU
    # engine renders the sheets on the CPU.
    for entry in (ttrain.main, ttrain.build):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(["--outdir", str(tmp_path / "runs"), "--dry-run"])
    cfg = ttrain.setup_config(ttrain.build_parser().parse_args(
        ["--outdir", "x", "--output_resolution", "32"]))[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainingLoop(cfg, {}, {}, None, None, run_dir=str(tmp_path / "t"))
    for make in (tlpips.get_default_model, tlpips.LPIPSModel.random_init,
                 tfid.get_default_extractor,
                 tfid.InceptionFeatures.random_init,
                 tinc.InceptionV3.random_init,
                 lambda: tfid.extract_features(
                     np.zeros((1, 8, 8, 3), np.uint8)),
                 lambda: PaintStrokeGenerator.create(
                     None, str(tmp_path / "missing.pkl"), 4, seed=0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert tlpips.get_default_model("cpu").device.type == "cpu"
    # The metric zoo and the stitching tools.
    from brushstroke_engine_torch.metrics import pr as tpr
    from brushstroke_engine_torch.tools import (
        calc_metrics, fid_from_images, metric_main as tmetric_main,
        visualize_stitching,
    )
    bundle = str(tmp_path / "missing.pkl")
    for make in (
            lambda: calc_metrics.main(["--gan_checkpoint", bundle]),
            lambda: tmetric_main.main(["--gan_checkpoint", bundle,
                                       "--eval_output_dir", str(tmp_path)]),
            lambda: visualize_stitching.main(["--gan_checkpoint", bundle,
                                              "--output_dir",
                                              str(tmp_path)]),
            lambda: fid_from_images.main(["--images0", str(tmp_path),
                                          "--images1", str(tmp_path)]),
            lambda: tpr.compute_pr(np.zeros((4, 2)), np.zeros((4, 2))),
            lambda: tpr.vgg16_extract_features(
                np.zeros((1, 8, 8, 3), np.uint8),
                tpr.VGG16Features.random_init(0))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()

    # The fused trainer's banks and the round-5 tools.
    from brushstroke_engine_torch.tools import (
        diagnose_color_control, drive_brush_server,
        fetch_and_verify_weights, visualize_main,
    )
    from brushstroke_engine_torch.train.device_dataset import \
        build_device_banks
    u8 = np.zeros((2, 8, 8, 3), np.uint8)
    for make in (
            lambda: build_device_banks(u8, u8),
            lambda: visualize_main.main(["--gan_checkpoint", bundle,
                                         "--output_dir", str(tmp_path)]),
            lambda: diagnose_color_control.main([bundle, "--out",
                                                 str(tmp_path)]),
            lambda: drive_brush_server.main([
                "--gan_checkpoint", bundle, "--libraries", "L:rand2:x",
                "--out_dir", str(tmp_path)]),
            lambda: fetch_and_verify_weights.main(["--clip_bpe", bundle])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()

    cuda_loop = types.SimpleNamespace(
        device=torch.device("cuda"),
        cfg=dataclasses.replace(cfg, gen_cfg=tgen, enc_cfg=tenc),
        state={"g_ema": trees[0], "w_avg": trees[1]["w_avg"],
               "noise": trees[1]["noise"]},
        enc_params=trees[2], enc_state=trees[3],
        run_dir=str(tmp_path / "h"), cur_tick=0, cur_nimg=0,
        hook_failure_counts={})
    make_eval_hooks(image_snapshot_ticks=1).on_tick(cuda_loop, {})
    assert cuda_loop.hook_failure_counts == {"viz": 1}
    viz = TrainingVisualizer(width=32)
    viz.init(tgen.z_dim)
    viz.do_visualize(str(tmp_path / "viz"), engine, "000000")
    assert len(os.listdir(tmp_path / "viz")) == 3


def test_port_imports_neither_jax_nor_the_jax_package():
    names = [m.name for m in pkgutil.walk_packages(
        brushstroke_engine_torch.__path__, "brushstroke_engine_torch.")]
    for mod in ("engine.brush", "engine.areas", "engine.canvas",
                "engine.device_canvas", "engine.library", "engine.mapper",
                "engine.stylize", "tools.paint_image",
                "ops.warp", "models.discriminator",
                "train.augment", "train.dataset", "train.losses",
                "train.loop", "train.state", "train.steps", "utils.img_proc",
                "tools.profile_render", "tools.profile_train",
                "tools.tune_kernels", "flagship", "ui.core", "ui.protocol",
                "ui.server", "tools.bench_serve", "metrics.lpips",
                "metrics.color", "metrics.geom", "metrics.inception",
                "metrics.fid", "metrics.stroke_generator",
                "metrics.metric_main", "viz.visualize", "train.eval_hooks",
                "tools.train", "utils.weights", "utils.torch_extract",
                "models.positional", "utils.reference_layout",
                "train.train_autoencoder",
                "tools.train_autoencoder", "tools.convert_checkpoint",
                "train.stitching", "metrics.pr", "metrics.ppl",
                "tools.calc_metrics", "tools.metric_main",
                "tools.fid_from_images", "tools.visualize_stitching",
                "tools.latent", "tools.projection", "tools.clarity",
                "tools.clip_model", "tools.clip_search",
                "tools.project_main", "tools.opt_clarity_main",
                "tools.clip_search_main", "tools.get_ws_main",
                "tools.seed_expand", "tools.visualize_pca_main",
                "tools.make_synthetic_media", "native",
                "tools.create_splines", "tools.prep_geom_data",
                "tools.dataset_tool", "tools.patch_augment",
                "tools.reformat_triband_data_main",
                "tools.make_synthetic_styles", "train.device_dataset",
                "train.fused", "tools.visualize_main",
                "tools.diagnose_color_control", "tools.drive_brush_server",
                "tools.plot_colors", "tools.fetch_and_verify_weights"):
        assert f"brushstroke_engine_torch.{mod}" in names, mod
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'brushstroke_engine_tpu')))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
