"""The port's stylize path against the JAX package on the CPU: the host
tools (crop grid, padding, geometry reading with Otsu, compositing on
white), the feature-window gather and scatter, the three stylizers
(sequential through PaintingHelper, checkerboard waves assembled on the
host, waves with the canvas on the device) with and without feature
blending, the 'nonempty' mode, empty geometry, color override, a W style
with noise buffers and UVS mapping, and the ``tools/paint_image.py`` CLI.

Tolerances: uint8 canvases within 1 LSB (f32 renders that differ by ~1e-6
can round across a step); feature windows within 1e-5 abs; crops, padding
and geometry exactly equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brushstroke_engine_tpu.engine import brush as jbrush
from brushstroke_engine_tpu.engine import canvas as jcanvas
from brushstroke_engine_tpu.engine import stylize as jst
from brushstroke_engine_tpu.ops.precision import set_precision_mode as jset
from brushstroke_engine_tpu.utils.checkpoint import EngineBundle, save_native
from brushstroke_engine_torch.data.curves import random_spline_stroke
from brushstroke_engine_torch.engine import brush as tbrush
from brushstroke_engine_torch.engine import canvas as tcanvas
from brushstroke_engine_torch.engine import stylize as tst
from brushstroke_engine_torch.ops.precision import set_precision_mode
from tests.torch_helpers import small_model

jset("strict")
set_precision_mode("strict")

# overlap_margin 4 at 32 px: stride 24; tile origins 0, 24, 48 (no x or y
# that is 17, 21, 25 or 29 modulo 32, where the JAX package's jitted noise
# is off: tests/test_torch_canvas.py::test_wrapped_noise_positions).
KW = dict(overlap_margin=4, crop_margin=4)


def u8_close(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def model():
    return small_model(seed=8)


@pytest.fixture(scope="module")
def pair(model):
    jgen, jenc = model["jax_cfg"]
    tgen, tenc = model["cfg"]
    j = jbrush.TriadGanPaintEngine(
        jgen, model["jax"]["gen_params"], model["jax"]["gen_state"], jenc,
        model["jax"]["enc_params"], model["jax"]["enc_state"],
        geom_inject_resolutions=(0, 1))
    t = tbrush.TriadGanPaintEngine(
        tgen, model["torch"]["gen_params"], model["torch"]["gen_state"],
        tenc, model["torch"]["enc_params"], model["torch"]["enc_state"],
        geom_inject_resolutions=(0, 1), device="cpu")
    return j, t


def make_geom(width=70, seed=0):
    return random_spline_stroke(np.random.default_rng(seed), width,
                                radius=4.0)


def opts_pair(pair, seed, color=None):
    out = []
    for eng, brush in zip(pair, (jbrush, tbrush)):
        o = brush.GanBrushOptions()
        o.set_style(eng.random_style(seed), seed)
        if color is not None:
            o.set_color(0, np.asarray(color, np.uint8))
        out.append(o)
    return out


def run(renderer, pair, geom, opts, **kw):
    outs = []
    for eng, st, canvas, o in zip(pair, (jst, tst), (jcanvas, tcanvas),
                                  opts):
        if renderer == "sequential":
            outs.append(st.stylize_image(canvas.PaintingHelper(eng, 0), geom,
                                         o, **KW, **kw))
        elif renderer == "batched":
            outs.append(st.stylize_image_batched(eng, geom, o, batch_size=4,
                                                 **KW, **kw))
        else:
            outs.append(st.stylize_image_ondevice(eng, geom, o, batch_size=4,
                                                  **KW, **kw))
    return outs


# ----- host tools -----

@pytest.mark.parametrize("shape,pw,om,mode", [
    ((128, 96), 32, 4, "all"), ((80, 80), 32, 8, "all"),
    ((100, 70), 32, 4, "all"), ((80, 80), 32, 4, "nonempty")])
def test_crops_and_padding(shape, pw, om, mode):
    geom = np.ones(shape, np.float32)
    geom[30:40, 10:60] = 0.0
    tp, ts = tst.pad_geometry(geom, pw, om)
    jp, js = jst.pad_geometry(geom, pw, om)
    assert ts == js
    np.testing.assert_array_equal(tp, jp)
    crops = tst.generate_stitching_crops(tp.shape, pw, om, geom=tp, mode=mode)
    assert crops == jst.generate_stitching_crops(jp.shape, pw, om, geom=jp,
                                                 mode=mode)
    cov = np.zeros(tp.shape, bool)
    for (y, x, h, w) in crops:
        cov[y:y + h, x:x + w] = True
    assert cov.all() if mode == "all" else cov.any()


@pytest.mark.parametrize("kind", ["rgba", "rgb", "gray255", "gray01"])
@pytest.mark.parametrize("binarize", [True, False])
def test_read_geometry_image_and_composite(kind, binarize):
    rng = np.random.RandomState(3)
    img = {"rgba": rng.randint(0, 256, (20, 24, 4)),
           "rgb": rng.randint(0, 256, (20, 24, 3)),
           "gray255": rng.randint(0, 256, (20, 24)),
           "gray01": rng.rand(20, 24)}[kind]
    img = img.astype(np.float64 if kind == "gray01" else np.uint8)
    np.testing.assert_array_equal(tst.read_geometry_image(img, binarize),
                                  jst.read_geometry_image(img, binarize))
    canvas = rng.randint(0, 256, (6, 7, 4)).astype(np.uint8)
    np.testing.assert_array_equal(tst.composite_on_white(canvas),
                                  jst.composite_on_white(canvas))


def test_feature_window_gather_and_scatter():
    """Windows of a 20 x 18 canvas, R = 8, that do not overlap (as the tiles
    of one wave), one of them overhanging (its start is clamped) and the
    last repeated as a chunk's padding is."""
    rng = np.random.RandomState(4)
    ffeat = rng.randn(1, 20, 18, 5).astype(np.float32)
    fmask = (rng.rand(20, 18) > 0.5).astype(np.float32)
    border = np.zeros((8, 8), np.float32)
    border[1:-1, 1:-1] = 1.0
    fys, fxs = [0, 0, 12, 15, 15], [0, 10, 0, 13, 13]
    jf, ja, ju = jst._gather_feature_windows(
        jnp.asarray(ffeat), jnp.asarray(fmask), jnp.asarray(fys),
        jnp.asarray(fxs), jnp.asarray(border))
    tf, ta, tu = tst._gather_feature_windows(
        torch.from_numpy(ffeat), torch.from_numpy(fmask), fys, fxs,
        torch.from_numpy(border))
    for g, w in ((tf, jf), (ta, ja), (tu, ju)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    new = rng.randn(5, 8, 8, 5).astype(np.float32)
    new[4] = new[3]
    upds = (rng.rand(5, 8, 8) > 0.3).astype(np.float32)
    upds[4] = upds[3]
    jfe, jma = jst._scatter_feature_windows(
        jnp.asarray(ffeat), jnp.asarray(fmask), jnp.asarray(new),
        jnp.asarray(upds), jnp.asarray(fys), jnp.asarray(fxs))
    tfe, tma = torch.from_numpy(ffeat.copy()), torch.from_numpy(fmask.copy())
    tst._scatter_feature_windows(tfe, tma, torch.from_numpy(new),
                                 torch.from_numpy(upds), fys, fxs)
    np.testing.assert_allclose(tfe.numpy(), np.asarray(jfe), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tma.numpy(), np.asarray(jma))


# ----- the three stylizers -----

@pytest.mark.parametrize("level", [0, 2])
@pytest.mark.parametrize("renderer", ["sequential", "batched", "ondevice"])
def test_stylizers(pair, renderer, level):
    geom = make_geom(seed=level)
    want, got = run(renderer, pair, geom, opts_pair(pair, 7),
                    feature_blending_level=level)
    assert got.shape == (80, 80, 4) and got[..., 3].max() > 0
    u8_close(got, want)


@pytest.mark.parametrize("renderer", ["batched", "ondevice"])
def test_stylizers_nonempty_color_and_white(pair, renderer):
    for eng in pair:
        eng.set_render_mode("full")
    try:
        geom = np.ones((70, 70), np.float32)
        geom[8:14, 5:30] = 0.0          # strokes in the top-left tiles only
        want, got = run(renderer, pair, geom,
                        opts_pair(pair, 8, color=[0, 255, 0]),
                        feature_blending_level=1, mode="nonempty",
                        on_white=True)
    finally:
        for eng in pair:
            eng.set_render_mode("clear")
    u8_close(got, want)
    assert (got[..., 3] == 255).all()
    empty = run(renderer, pair, np.ones((64, 64), np.float32),
                opts_pair(pair, 9), feature_blending_level=1,
                mode="nonempty")
    np.testing.assert_array_equal(empty[1], empty[0])
    assert empty[1][..., 3].max() == 0


def test_ondevice_w_style_noise_buffers_and_uvs(pair, model):
    rng = np.random.RandomState(5)
    ws = rng.randn(1, model["cfg"][0].num_ws, 16)
    noise = {"b16.conv1.noise_const": rng.randn(16, 16).astype(np.float32)}
    opts = []
    for brush in (jbrush, tbrush):
        o = brush.GanBrushOptions()
        o.set_style_w(ws, "proj0", custom_args={"noise_buffers": noise})
        o.enable_uvs_mapping = True
        opts.append(o)
    want, got = run("ondevice", pair, make_geom(seed=4), opts,
                    feature_blending_level=2)
    u8_close(got, want)


def test_paint_image_cli(pair, model, tmp_path):
    """The CLI on the CPU: a native bundle written by the JAX package, a PNG
    drawing, a seed library with style interpolation and a color preset;
    the PNG it writes equals the JAX package's on-device stylizer under the
    same style."""
    import PIL.Image
    from brushstroke_engine_tpu.engine.library import SeedBrushLibrary
    from brushstroke_engine_torch.tools import paint_image

    jgen, jenc = model["jax_cfg"]
    bundle = str(tmp_path / "bundle.pkl")
    save_native(bundle, EngineBundle(
        gen_cfg=jgen, gen_params=model["jax"]["gen_params"],
        gen_state=model["jax"]["gen_state"], enc_cfg=jenc,
        enc_params=model["jax"]["enc_params"],
        enc_state=model["jax"]["enc_state"], color_format="triad",
        geom_inject_resolutions=(0, 1)))
    geom = make_geom(seed=6)
    drawing = str(tmp_path / "drawing.png")
    PIL.Image.fromarray((geom * 255).astype(np.uint8)).save(drawing)
    out = paint_image.main([
        "--gan_checkpoint", bundle, "--geo_image", drawing,
        "--output_dir", str(tmp_path / "out"), "--library", "3,5",
        "--style_id", "3", "--style_id2", "5", "--style_blend_alpha", "0.3",
        "--color_mode", "2", "--overlap_margin", "4", "--crop_margin", "4",
        "--precision", "strict", "--device", "cpu"])
    assert out.endswith("drawing_style3_0.30__5_c2.png")
    got = np.asarray(PIL.Image.open(out))

    opts = jbrush.GanBrushOptions()
    SeedBrushLibrary([3, 5], jgen.z_dim).set_interpolated_style(
        "3", "5", 0.3, opts)
    opts.set_color(0, np.asarray([200, 50, 50], np.uint8))
    opts.set_color(1, np.asarray([250, 200, 100], np.uint8))
    img = np.asarray(PIL.Image.open(drawing))
    want = jst.stylize_image_ondevice(
        pair[0], jst.read_geometry_image(img), opts, **KW)
    u8_close(got, want)
