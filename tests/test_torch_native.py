"""The port's native stroke rasterizer (``brushstroke_engine_torch/native.py``)
against the JAX package's and against the port's numpy form.

Both packages compile the same C++ with the same g++ flags, so their
strokes, blurs and triband images must be bit-equal.  The numpy form sums
distances in f64 from f64 points where the C++ reads f32 points, so the two
forms agree to 1e-4 (the bound of ``tests/test_native.py``); measured
differences are ~1e-5."""

import ctypes
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from brushstroke_engine_tpu import native as jnative
from brushstroke_engine_torch import native
from brushstroke_engine_torch.data import curves
from tests.torch_helpers import REPO, jax_native


@pytest.fixture(scope="module", autouse=True)
def libs():
    assert native.available(), native.load_error()
    jax_native()


def _polyline(seed, width):
    rng = np.random.default_rng(seed)
    pts = curves.random_spline_points(rng, width).astype(np.float32)
    return pts, float(rng.uniform(0.7, width / 8))


@pytest.mark.parametrize("width", [48, 192])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stroke_is_bit_equal_to_the_jax_package_s(width, seed):
    pts, radius = _polyline(seed, width)
    for soft in (1.0, 0.6):
        got = native.draw_stroke_native(width, pts, radius, soft)
        want = jnative.draw_stroke_native(width, pts, radius, soft)
        assert got.dtype == np.float32 and got.shape == (width, width)
        assert got.min() < 0.5
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sigma", [0.0, 1.3, 2.0])
def test_blur_and_triband_are_bit_equal_to_the_jax_package_s(sigma):
    img = np.random.default_rng(4).random((40, 33)).astype(np.float32)
    np.testing.assert_array_equal(native.gaussian_blur_native(img, sigma),
                                  jnative.gaussian_blur_native(img, sigma))
    np.testing.assert_array_equal(
        native.triband_native(img, sigma, 0.4),
        jnative.triband_native(img, sigma, 0.4))


@pytest.mark.parametrize("width", [48, 192])
def test_draw_stroke_routes_to_native_within_1e4_of_numpy(width):
    pts, radius = _polyline(7, width)
    got = curves.draw_stroke(width, pts.astype(np.float64), radius)
    np.testing.assert_array_equal(
        got, native.draw_stroke_native(width, pts, radius))
    want = curves.draw_stroke_numpy(width, pts.astype(np.float64), radius)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_one_point_strokes_take_numpy(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a one-point stroke reached the native path")

    monkeypatch.setattr(native, "draw_stroke_native", refuse)
    pts = np.array([[20.5, 11.25]])
    got = curves.draw_stroke(48, pts, 3.0)
    np.testing.assert_array_equal(got, curves.draw_stroke_numpy(48, pts, 3.0))
    assert got.min() == 0.0


def test_without_g_plus_plus_the_numpy_form_draws_and_says_why(
        tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(native, "SO_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "SRC_PATH", str(tmp_path / "missing.cpp"))
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert not native.available()
    assert "g++ failed" in native.load_error()
    assert any("numpy" in r.getMessage() for r in caplog.records)
    assert native.draw_stroke_native(48, np.zeros((2, 2)), 2.0) is None
    pts, radius = _polyline(3, 48)
    np.testing.assert_array_equal(
        curves.draw_stroke(48, pts, radius),
        curves.draw_stroke_numpy(48, pts, radius))
    assert os.listdir(tmp_path) == []


def test_concurrent_builds_leave_one_loadable_library(tmp_path):
    """Two processes build into one path at once; each loads what it
    built, and the path then holds one whole library and no temp file."""
    so = str(tmp_path / "build" / "libbse_stroke_raster.so")
    code = (
        "import numpy as np\n"
        "from brushstroke_engine_torch import native\n"
        f"native.SO_PATH = {so!r}\n"
        "native.build()\n"
        "out = native.draw_stroke_native(32, np.array([[4., 4.], "
        "[28., 20.]], np.float32), 3.0)\n"
        "print('ok', float(out.min()))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        assert out.startswith("ok 0.0"), out
    assert os.listdir(tmp_path / "build") == ["libbse_stroke_raster.so"]
    assert ctypes.CDLL(so).bse_draw_stroke
