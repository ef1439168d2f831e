"""The JAX package's last public names, as the port has them, against the
JAX functions on the CPU: the two output heads no model config wires in
(``models/synthesis.py``: ``color_mapping_apply``, ``to_canvas_stroke_apply``;
their initialisers in ``utils/checkpoint.py``), ``metrics/color.py:
linear_to_srgb``, ``ops/filters.py:default_resample_filter``,
``train/steps.py:make_stitch_step`` (port against port: it delegates to
``g_stitch_step``, which ``tests/test_torch_stitching.py`` holds against
JAX), ``engine/library.py:ZipIcons`` and the runtime helpers of
``utils/util.py``.

Small sizes: 16 px, w_dim 16, in_ch 8; strict f32 on the JAX side, TF32 off
on the port's; inputs from ``numpy.RandomState``; parameters carried across
by ``params_from_jax``.  Tolerances (set before the runs):
  * ``color_mapping_apply``: 1e-6 abs with the tanh; without it 1e-6 of
    the output's peak where that exceeds 1 (three f32 FC layers, sums of at
    most 128 products in another order: a first run gave 1.43e-6 at a
    value of 4.03, 3 f32 ulps, against 1e-6 abs);
  * ``to_canvas_stroke_apply``: the image and every debug entry 1e-5 abs
    (an unnormalized 1x1 conv of 8 channels: values of a few units before
    the tanh and softmax);
  * ``linear_to_srgb``: 1e-6 abs (the same f32 power);
    ``default_resample_filter``: equal;
  * ``make_stitch_step``: bit-equal to ``g_stitch_step`` (the same calls);
  * the ``utils/util.py`` helpers: equal outputs, messages and exceptions.
"""

import argparse
import logging
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.engine import library as jlib
from brushstroke_engine_tpu.metrics import color as jcolor
from brushstroke_engine_tpu.models import synthesis as jsyn
from brushstroke_engine_tpu.ops import filters as jfilters
from brushstroke_engine_tpu.ops.precision import precision_mode as jpm
from brushstroke_engine_tpu.utils import util as jutil
from brushstroke_engine_torch.engine import library as tlib
from brushstroke_engine_torch.metrics import color as tcolor
from brushstroke_engine_torch.models import synthesis as tsyn
from brushstroke_engine_torch.ops import filters as tfilters
from brushstroke_engine_torch.ops.precision import set_precision_mode
from brushstroke_engine_torch.train import state as tstate
from brushstroke_engine_torch.train import steps as tsteps
from brushstroke_engine_torch.train import stitching as tst
from brushstroke_engine_torch.utils import checkpoint as tck
from brushstroke_engine_torch.utils import util as tutil
from brushstroke_engine_torch.utils.checkpoint import params_from_jax
from brushstroke_engine_torch.utils.util import tree_leaves
from tests.torch_train_helpers import B, RES, _batch, _train_cfgs

W_DIM, IN_CH, OUT_CH, PX = 16, 8, 3, 16


@pytest.fixture(autouse=True)
def _strict():
    set_precision_mode("strict")
    with jpm("strict"):
        yield


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _shapes(tree):
    return jax.tree_util.tree_map(np.shape, tree)


# ---------------------------------------------------------------------------
# The two heads
# ---------------------------------------------------------------------------

def _color_mapping_tree(source):
    if source == "jax_init":
        return _np_tree(jsyn.color_mapping_init(jax.random.PRNGKey(0),
                                                w_dim=W_DIM))
    return tck.color_mapping_init(np.random.RandomState(0), W_DIM)


def _canvas_tree(source):
    if source == "jax_init":
        tree = _np_tree(jsyn.to_canvas_stroke_init(
            jax.random.PRNGKey(1), in_ch=IN_CH, out_ch=OUT_CH, w_dim=W_DIM))
    else:
        tree = tck.to_canvas_stroke_init(np.random.RandomState(1), IN_CH,
                                         OUT_CH, W_DIM)
    # Non-zero biases, so the carried-across biases count.
    rng = np.random.RandomState(2)
    tree["bias"] = rng.randn(*tree["bias"].shape).astype(np.float32)
    tree["color_bias"] = rng.randn(9).astype(np.float32) * 0.3
    return tree


def test_port_initialisers_draw_the_jax_shapes():
    assert _shapes(_color_mapping_tree("port_init")) \
        == _shapes(_color_mapping_tree("jax_init"))
    assert _shapes(tck.color_mapping_init(np.random.RandomState(0), W_DIM,
                                          (8,))) == _shapes(_np_tree(
        jsyn.color_mapping_init(jax.random.PRNGKey(0), W_DIM, (8,))))
    assert _shapes(_canvas_tree("port_init")) \
        == _shapes(_canvas_tree("jax_init"))
    p = tck.to_canvas_stroke_init(np.random.RandomState(1), IN_CH, OUT_CH,
                                  W_DIM)
    np.testing.assert_array_equal(p["affine"]["bias"], 1.0)
    assert not p["bias"].any() and not p["color_bias"].any()


@pytest.mark.parametrize("source", ["jax_init", "port_init"])
@pytest.mark.parametrize("normalize", [True, False])
def test_color_mapping_apply_matches_jax(source, normalize):
    tree = _color_mapping_tree(source)
    w = np.random.RandomState(3).randn(4, W_DIM).astype(np.float32)
    want = np.asarray(jsyn.color_mapping_apply(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(w),
        normalize=normalize))
    got = tsyn.color_mapping_apply(params_from_jax(tree), torch.from_numpy(w),
                                   normalize=normalize)
    assert got.shape == (4, 3, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want).max()))
    if normalize:
        assert float(got.abs().max()) <= 1.0
    else:
        assert float(got.abs().max()) > 1.0     # the tanh is really off


@pytest.mark.parametrize("source", ["jax_init", "port_init"])
@pytest.mark.parametrize("conv_clamp", [None, 0.5])
def test_to_canvas_stroke_apply_matches_jax(source, conv_clamp):
    tree = _canvas_tree(source)
    rng = np.random.RandomState(4)
    x = rng.randn(2, PX, PX, IN_CH).astype(np.float32)
    w = rng.randn(2, W_DIM).astype(np.float32)
    want, want_dbg = jsyn.to_canvas_stroke_apply(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
        jnp.asarray(w), conv_clamp=conv_clamp)
    got, dbg = tsyn.to_canvas_stroke_apply(
        params_from_jax(tree), torch.from_numpy(x), torch.from_numpy(w),
        conv_clamp=conv_clamp)
    assert got.shape == (2, PX, PX, OUT_CH)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)
    assert set(dbg) == set(want_dbg) == {"colors", "uvs", "canvas",
                                         "alpha_fg"}
    for k in want_dbg:
        assert dbg[k].shape == want_dbg[k].shape, k
        np.testing.assert_allclose(_np(dbg[k]), np.asarray(want_dbg[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(_np(dbg["uvs"]).sum(-1), 1.0, atol=1e-6)
    alpha = _np(dbg["alpha_fg"])
    assert alpha.min() >= 0.0 and alpha.max() <= 1.0
    assert np.abs(_np(dbg["canvas"])).max() <= 1.0
    if conv_clamp is not None:
        # The clamp engages: the canvas stays within tanh(clamp).
        assert np.abs(_np(dbg["canvas"])).max() <= np.tanh(conv_clamp) + 1e-6
        free, _ = tsyn.to_canvas_stroke_apply(
            params_from_jax(tree), torch.from_numpy(x), torch.from_numpy(w))
        assert not torch.equal(free, got)


# ---------------------------------------------------------------------------
# Colour, filter, icon store
# ---------------------------------------------------------------------------

def test_linear_to_srgb_matches_jax():
    grid = np.concatenate([
        [-0.5, -1e-9, 0.0, 1e-6, 0.0031307, 0.0031308, 0.0031309, 0.004,
         0.04045, 0.5, 0.999, 1.0, 1.0 + 1e-6, 1.5, 7.0],
        np.linspace(-0.2, 1.2, 257)]).astype(np.float32)
    want = np.asarray(jcolor.linear_to_srgb(jnp.asarray(grid)))
    got = tcolor.linear_to_srgb(torch.from_numpy(grid))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6)
    # Both branches and the clamp are reached.
    assert np.all(_np(got)[grid <= 0] == 0) and np.all(_np(got)[grid >= 1]
                                                       == want[grid >= 1])
    x = torch.linspace(0, 1, 32)
    np.testing.assert_allclose(
        _np(tcolor.linear_to_srgb(tcolor.srgb_to_linear(x))), _np(x),
        atol=1e-5)


def test_default_resample_filter_equals_jax():
    got, want = tfilters.default_resample_filter(), \
        jfilters.default_resample_filter()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tfilters.setup_filter([1, 3, 3, 1]))


def test_zip_icons_is_the_icon_store():
    assert tlib.ZipIcons is tlib.IconStore
    assert jlib.ZipIcons is jlib.IconStore


# ---------------------------------------------------------------------------
# make_stitch_step
# ---------------------------------------------------------------------------

STITCH_LOSSES = "1.0*gan(fake)+1.0*gan(fake_composite)+1.0*l1(patch)"


def _stitch_setup(**kw):
    m, _, tcfg = _train_cfgs(None, stitch_interval=4,
                             stitch_phase_losses=STITCH_LOSSES, **kw)
    _, geom, _, zs = _batch(5)
    f1 = tsteps.encode_geometry(tcfg, m["torch"]["enc_params"],
                                m["torch"]["enc_state"],
                                torch.from_numpy(geom))
    f2 = [torch.flip(f, dims=(2,)) for f in f1]
    state = tstate.init_train_state(
        tcfg, 0, g_params=m["torch"]["gen_params"],
        g_state=m["torch"]["gen_state"], device="cpu")
    pos = torch.from_numpy(np.random.RandomState(7).randint(
        0, RES - 1, size=(B, 2)))
    return tcfg, state, f1, f2, torch.from_numpy(zs[0]), pos


def _assert_same_step(got, want):
    (gs, gstats), (ws, wstats) = got, want
    assert set(gstats) == set(wstats)
    for k in wstats:
        assert torch.equal(gstats[k], wstats[k]), k
    assert set(gs) == set(ws)
    for k in ws:
        a, b = tree_leaves(gs[k]), tree_leaves(ws[k])
        assert len(a) == len(b), k
        for x, y in zip(a, b):
            if isinstance(y, torch.Tensor):
                assert torch.equal(x, y), k
            else:
                assert x == y, k


@pytest.mark.parametrize("batch_gpu", [None, 2])
def test_make_stitch_step_equals_g_stitch_step(batch_gpu):
    """The JAX argument order (``rng``, ``ema_beta`` positional,
    ``positions1``) gives the step a direct ``g_stitch_step`` call takes on
    the same state and draws; with two ``batch_gpu`` rounds each round
    takes its half of ``positions1``."""
    cfg, state, f1, f2, z, pos = _stitch_setup(batch_gpu=batch_gpu)
    crop1, crop2 = (2, 3, RES, RES), (7, 0, RES, RES)
    stitcher = tst.RandomStitcher(3, 12)
    draws = {"positions1": pos} if batch_gpu is None else \
        [{"positions1": pos[:2]}, {"positions1": pos[2:]}]
    want = tsteps.g_stitch_step(cfg, state, f1, f2, z, crop1, crop2,
                                ema_beta=0.5, draws=draws, stitcher=stitcher)
    step = tsteps.make_stitch_step(cfg, stitcher=stitcher)
    got = step(state, f1, f2, z, crop1, crop2, None, 0.5, positions1=pos)
    _assert_same_step(got, want)
    assert float(got[1]["Loss/forger/Gstitch/l1_patch"]) > 0


def test_make_stitch_step_default_stitcher_and_draws():
    """Without a stitcher the step makes the default one once; ``draws``
    passes through as ``g_stitch_step`` takes it."""
    cfg, state, f1, f2, z, pos = _stitch_setup()
    crop1, crop2 = (0, 0, RES, RES), (5, 6, RES, RES)
    want = tsteps.g_stitch_step(cfg, state, f1, f2, z, crop1, crop2,
                                draws={"positions1": pos})
    got = tsteps.make_stitch_step(cfg)(state, f1, f2, z, crop1, crop2,
                                       draws={"positions1": pos})
    _assert_same_step(got, want)


# ---------------------------------------------------------------------------
# utils/util.py: the cases of tests/test_infra.py::TestUtil through both
# ---------------------------------------------------------------------------

UTILS = pytest.mark.parametrize("util", [jutil, tutil], ids=["jax", "port"])


def _outcome(fn, *args, **kwargs):
    """(result, None) or (None, (exception type, message))."""
    try:
        return fn(*args, **kwargs), None
    except Exception as e:            # noqa: BLE001 (compared, not hidden)
        return None, (type(e), str(e))


def test_easydict_both():
    out = []
    for util in (jutil, tutil):
        d = util.EasyDict(a=1)
        d.b = 2
        assert d.a == 1 and d["b"] == 2
        del d.a
        out.append((dict(d), _outcome(getattr, d, "a"),
                    _outcome(delattr, d, "zz")))
    assert out[0] == out[1]
    assert out[1][1][1][0] is AttributeError
    from brushstroke_engine_torch.utils import torch_extract
    assert torch_extract.EasyDict is tutil.EasyDict


def test_construct_class_by_name_both():
    for util in (jutil, tutil):
        od = util.construct_class_by_name(
            [("a", 1)], class_name="collections.OrderedDict")
        assert od["a"] == 1
    assert tutil.get_obj_by_name("os.path.join") is \
        jutil.get_obj_by_name("os.path.join")
    for name in ("collections.NoSuchThing", "no_such_module_x.y"):
        assert _outcome(tutil.get_obj_by_name, name) \
            == _outcome(jutil.get_obj_by_name, name)


def test_format_time_both():
    for s in (0, 5, 59.4, 59.6, 65, 3599, 3600, 3700, 86399, 86400,
              2 * 86400 + 3700, 1e6):
        assert tutil.format_time(s) == jutil.format_time(s), s
    assert tutil.format_time(5) == "5s"
    assert tutil.format_time(65) == "1m 05s"
    assert tutil.format_time(3700) == "1h 01m"


def test_timer_both(monkeypatch):
    out = []
    for util in (jutil, tutil):
        clock = iter([10.0, 12.5, 20.0, 21.0])
        monkeypatch.setattr(util.time, "time", lambda: next(clock))
        t = util.Timer()
        out.append((t.tick(), t.peek(), t.tick()))
    assert out[0] == out[1] == (2.5, 7.5, 8.5)


def test_logger_tees_and_restores_stdout(tmp_path, capsys):
    texts = []
    for name, util in (("jax", jutil), ("port", tutil)):
        before = sys.stdout
        log = util.Logger(str(tmp_path / f"{name}.txt"))
        assert sys.stdout is log
        print("hello", 3)
        log.flush()
        log.close()
        assert sys.stdout is before
        texts.append((tmp_path / f"{name}.txt").read_text())
    assert texts[0] == texts[1] == "hello 3\n"
    assert capsys.readouterr().out == "hello 3\n" * 2
    log = tutil.Logger()               # no file: stdout only
    print("x")
    log.close()
    assert capsys.readouterr().out == "x\n"


def test_log_setup_and_flag_both():
    root = logging.getLogger()
    saved = root.handlers[:], root.level
    got = []
    try:
        for util in (jutil, tutil):
            root.handlers = []
            util.default_log_setup(level=logging.WARNING)
            (h,) = root.handlers
            got.append((root.level, type(h), h.stream is sys.stdout,
                        h.formatter._fmt))
            p = argparse.ArgumentParser()
            util.add_log_level_flag(p)
            got.append((p.parse_args([]).log_level,
                        p.parse_args(["--log_level", "10"]).log_level))
    finally:
        root.handlers, _ = saved
        root.setLevel(saved[1])
    assert got[:2] == got[2:]
    assert got[1] == (logging.INFO, 10)


_ROW = re.compile(r"^  (\S+)\s+(\(.*?\))\s+([\d,]+)$")


def _summary(util, params, capsys, **kw):
    total = util.print_param_summary(params, "toy", **kw)
    return total, capsys.readouterr().out


def test_print_param_summary_both(capsys):
    toy = {"layer": {"weight": np.zeros((4, 5)), "bias": np.zeros(5)}}
    for params in (toy, {"a": [np.zeros((2, 3)), {"x": 1.0}],
                         "b": np.zeros(())}):
        assert _summary(tutil, params, capsys) \
            == _summary(jutil, params, capsys)
    assert _summary(tutil, toy, capsys)[1].startswith("toy parameters: 25")
    lin = torch.nn.Linear(5, 4)
    total, text = _summary(tutil, lin, capsys)
    assert total == 24 and "weight" in text and "(4, 5)" in text


def test_print_param_summary_on_carried_across_parameters(capsys):
    """The generator's JAX tree against the port's tensors from it: the same
    rows (name and count; the shape in each package's layout), the same
    total and the same cut at ``max_rows``."""
    from tests.torch_helpers import small_model
    m = small_model(seed=3)
    tree = m["np"]["gen_params"]
    port = params_from_jax(tree)
    jt, jtext = _summary(jutil, tree, capsys, max_rows=10 ** 6)
    pt, ptext = _summary(tutil, port, capsys, max_rows=10 ** 6)
    assert jt == pt > 0
    jrows = [_ROW.match(r).groups() for r in jtext.splitlines()[1:]]
    prows = [_ROW.match(r).groups() for r in ptext.splitlines()[1:]]
    assert [(n, c) for n, _, c in jrows] == [(n, c) for n, _, c in prows]
    leaves = dict(_leaves(port))
    for name, shape, _ in prows:
        assert shape == str(tuple(leaves[name].shape)), name
    cut = [_summary(u, t, capsys) for u, t in ((jutil, tree), (tutil, port))]
    assert cut[0][1].splitlines()[-1] == cut[1][1].splitlines()[-1] \
        and "more tensors" in cut[0][1].splitlines()[-1]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


def test_assert_shape_both():
    cases = [((2, 3, 4), (2, None, 4)), ((2, 3), (2, 4)), ((2, 3), (2, 3, 1)),
             ((5,), (None,)), ((1, 2), (1, 3))]
    for shape, ref in cases:
        a = _outcome(jutil.assert_shape, np.zeros(shape), ref)
        b = _outcome(tutil.assert_shape, torch.zeros(shape), ref)
        assert a == b, (shape, ref)
    assert _outcome(tutil.assert_shape, torch.zeros(2, 3), (2, 4))[1] == (
        AssertionError, "Wrong size for dimension 1: got 3, expected 4")


def test_profiled_function_both():
    @jutil.profiled_function
    def f(x):
        return x * 2

    @tutil.profiled_function
    def g(x):
        return x * 2

    assert float(f(jnp.float32(3.0))) == float(g(torch.tensor(3.0))) == 6.0
    assert f.__name__ == "f" and g.__name__ == "g"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        g(torch.ones(3))
    assert "g" in {e.key for e in prof.key_averages()}


def test_open_url_both(tmp_path):
    import hashlib
    p = tmp_path / "a.bin"
    p.write_bytes(b"hi")
    url = "https://example.com/model.pt"
    for util in (jutil, tutil):
        with util.open_url(str(p)) as f:
            assert f.read() == b"hi"
        with util.open_url(f"file://{p}") as f:
            assert f.read() == b"hi"
    assert _outcome(tutil.open_url, url, cache_dir=str(tmp_path)) \
        == _outcome(jutil.open_url, url, cache_dir=str(tmp_path))
    assert _outcome(tutil.open_url, url,
                    cache_dir=str(tmp_path))[1][0] is FileNotFoundError
    digest = hashlib.sha256(url.encode()).hexdigest()[:16]
    (tmp_path / f"{digest}-model.pt").write_bytes(b"weights")
    for util in (jutil, tutil):
        with util.open_url(url, cache_dir=str(tmp_path)) as f:
            assert f.read() == b"weights"


def test_log_tensor_both(caplog):
    logger = logging.getLogger("t")
    arr = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    msgs = []
    for util, t in ((jutil, arr), (tutil, arr), (tutil, torch.from_numpy(arr)),
                    (jutil, np.ones((2, 3))), (tutil, torch.ones(2, 3,
                                                             dtype=torch.float64))):
        caplog.clear()
        with caplog.at_level(logging.DEBUG, "t"):
            util.log_tensor(t, "x", logger, print_stats=True)
        msgs.append(caplog.records[-1].getMessage())
    assert msgs[0] == msgs[1] == msgs[2]
    assert msgs[3] == msgs[4] and "shape (2, 3)" in msgs[3]
    caplog.clear()
    with caplog.at_level(logging.DEBUG, "t"):
        tutil.log_tensor(torch.ones(2, dtype=torch.bfloat16), "y", logger,
                         print_stats=True)
        tutil.log_tensor(arr, "z", logger, level=logging.DEBUG - 1)
    (rec,) = caplog.records
    assert rec.getMessage() == \
        "y: shape (2,) dtype bfloat16 min 1.0000 max 1.0000 mean 1.0000"


def test_suite_runs_torch_on_one_thread():
    """``tests/torch_helpers.py``'s policy holds inside a test."""
    assert torch.get_num_threads() == 1
