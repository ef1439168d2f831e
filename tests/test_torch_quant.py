"""The port's static int8 serving (``ops/quant.py``, ``ops/int8_conv.py``)
and its kernel build cache (``utils/compile_cache.py``) against the JAX
package on the CPU.

Small shapes: 32 px, the 5 quantized conv sites of ``small_model``'s
generator.  Tolerances (set before the runs):
  * ``quantized_conv`` on the same numpy inputs, f32 and bf16, dynamic and
    static scales: bit-equal (the int32 accumulator is exact in both; the
    scales, the division, the half-to-even rounding and the epilogue are
    the same f32 operations);
  * ``modulated_conv2d`` under int8: 1e-5 relative + 1e-6 abs of the JAX
    output (the conv is exact; the style and demodulation products are f32
    in another order);
  * ``enable_int8_serving``: the JAX engine's site count, scales within
    1e-5 relative;
  * the int8 render: PSNR > 25 dB against float in both packages (the JAX
    gate), and the port's int8 render against the JAX int8 render within 1
    LSB and PSNR >= INT8_PARITY_DB, which must lie at least 10 dB above
    the int8-vs-float PSNR (38.2 dB when this was written);
  * int8 off: the float render bit-equal to a render that never had int8;
  * a flush's rows (B = 8) against the rows alone (B = 1), both packages:
    1e-6 in float; in int8 10 dB above the int8-vs-float PSNR per row (a
    first run: one row of eight stepped, by up to 4 LSB in the JAX engine and
    1 in the port, 24 values each), and in the port, where no site flips a
    quantized value, 1e-6 and 0 LSB; each site's activation within 1e-5 of
    its amax until a flip, and each site row-exact (bit-equal).
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brushstroke_engine_tpu.engine import brush as jbrush
from brushstroke_engine_tpu.ops import quant as jquant
from brushstroke_engine_tpu.ops.conv import modulated_conv2d as jmodconv
from brushstroke_engine_tpu.ops.precision import precision_mode as jpm
from brushstroke_engine_tpu.utils import compile_cache as jcache
from brushstroke_engine_torch import native
from brushstroke_engine_torch.engine import brush as tbrush
from brushstroke_engine_torch.ops import cuda_build
from brushstroke_engine_torch.ops import quant, setup_filter
from brushstroke_engine_torch.ops.conv import modulated_conv2d
from brushstroke_engine_torch.ops.int8_conv import (
    int8_conv, int8_conv_plain, int8_epilogue_plain,
)
from brushstroke_engine_torch.ops.precision import set_precision_mode
from brushstroke_engine_torch.utils import compile_cache
from tests.torch_helpers import small_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT8_PARITY_DB = 55.0
SITES = 5        # b4.conv1, b8/b16/b32.conv1, torgb of small_model


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine, JAX scales, port scales), calibrated once,
    strict f32 on both sides."""
    set_precision_mode("strict")
    m = small_model(seed=3)
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
    with jpm("strict"):
        js = j.enable_int8_serving()
    ts = t.enable_int8_serving()
    return j, t, js, ts


def _patch(w=32):
    patch = np.zeros((w, w, 4), np.uint8)
    for i in range(w):
        patch[max(0, i - 3):i + 3, i, 3] = 255
    patch[w // 3:w // 2, 2:w - 2, 3] = 200
    return patch


def _opts(brush, eng, uvs=True):
    opts = brush.GanBrushOptions()
    opts.set_style(eng.random_style(7), 7)
    opts.set_position(x=37, y=250)
    opts.enable_uvs_mapping = uvs
    return opts


def _psnr(a, b):
    mse = np.mean((a.astype(np.float32) / 255.0
                   - b.astype(np.float32) / 255.0) ** 2)
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def _float_render(eng, opts):
    scales, eng._int8_scales = eng._int8_scales, None
    try:
        return eng.render_stroke(_patch(), None, opts)[0]
    finally:
        eng._int8_scales = scales


# ---------------------------------------------------------------------------
# quantized_conv and the gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scales", ["dynamic", "static"])
@pytest.mark.parametrize("padding", [((1, 1), (1, 1)), ((0, 0), (0, 0)),
                                     ((-1, 2), (1, -1))])
def test_quantized_conv_is_bit_equal_to_jax(dtype, scales, padding):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 7, 5).astype(np.float32) * 3
    w = rng.randn(6, 5, 3, 3).astype(np.float32) * 0.2
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    jw = jnp.asarray(w.transpose(2, 3, 1, 0)).astype(jdt)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    if scales == "static":
        with jquant.static_scales([0.021]):
            want = jquant.quantized_conv(jx, jw, padding)
        with quant.static_scales([0.021]):
            got = quant.quantized_conv(tx, tw, padding)
            assert quant.sites_consumed() == 1
    else:
        want = jquant.quantized_conv(jx, jw, padding)
        got = quant.quantized_conv(tx, tw, padding)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_gate_excludes_strided_dilated_grouped():
    x = torch.zeros((1, 8, 8, 4), dtype=torch.bfloat16)
    with quant.int8_inference():
        assert quant.quantizable(x, (1, 1), (1, 1), 1)
        assert not quant.quantizable(x, (2, 2), (1, 1), 1)
        assert not quant.quantizable(x, (1, 1), (2, 2), 1)
        assert not quant.quantizable(x, (1, 1), (1, 1), 4)
        assert not quant.quantizable(torch.zeros((1, 8, 8, 4),
                                                 dtype=torch.int8),
                                     (1, 1), (1, 1), 1)
        assert not quant.quantizable(torch.zeros((8, 8, 4)), (1, 1),
                                     (1, 1), 1)
    assert not quant.quantizable(x, (1, 1), (1, 1), 1)      # flag off


def test_modulated_conv2d_int8_matches_jax_and_is_close_to_float():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 8, 8, 6).astype(np.float32)
    w = (rng.randn(3, 3, 6, 9) * 0.2).astype(np.float32)          # HWIO
    s = (rng.rand(3, 6) + 0.5).astype(np.float32)
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())         # OIHW
    want_f = modulated_conv2d(torch.from_numpy(x), tw, torch.from_numpy(s),
                              padding=1)
    with quant.int8_inference():
        got = modulated_conv2d(torch.from_numpy(x), tw, torch.from_numpy(s),
                               padding=1)
    with jquant.int8_inference():
        want = jmodconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                        padding=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    rel = float(torch.linalg.norm(got - want_f) / torch.linalg.norm(want_f))
    assert 0 < rel < 0.02, rel


@pytest.mark.parametrize("up", [1, 2])
def test_int8_leaves_the_resampled_path_untouched(up):
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 8, 8, 4).astype(np.float32))
    w = torch.from_numpy((rng.randn(4, 4, 3, 3) * 0.3).astype(np.float32))
    s = torch.from_numpy((rng.rand(2, 4) + 0.5).astype(np.float32))
    f = setup_filter([1, 3, 3, 1])
    kw = dict(up=up, padding=1 if up == 1 else 0,
              resample_filter=f if up == 2 else None)
    want = modulated_conv2d(x, w, s, **kw)
    with quant.int8_inference():
        got = modulated_conv2d(x, w, s, **kw)
    if up == 2:
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) > 0


def test_static_scales_exhaustion_raises():
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 8, 8, 4).astype(
        np.float32))
    w = torch.from_numpy((np.random.RandomState(1).randn(4, 4, 3, 3)
                          * 0.1).astype(np.float32))
    pad = ((1, 1), (1, 1))
    with quant.static_scales([0.01]):
        quant.quantized_conv(x, w, pad)
        with pytest.raises(RuntimeError, match="exhausted"):
            quant.quantized_conv(x, w, pad)


def test_calibration_records_one_amax_per_site():
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 8, 4).astype(
        np.float32))
    w = torch.ones((4, 4, 3, 3)) * 0.1
    with quant.calibration() as amax:
        y = quant.quantized_conv(x, w, ((1, 1), (1, 1)))
        quant.quantized_conv(y, w, ((1, 1), (1, 1)))
    assert amax == [float(x.abs().max()), float(y.abs().max())]
    assert quant.calibrated_scales() == [a / 127.0 for a in amax]
    assert not quant.quantizable(x, (1, 1), (1, 1), 1)


def test_int8_conv_plain_equals_an_int64_reference():
    rng = np.random.RandomState(5)
    for (b, h, w, i, o, k) in ((2, 7, 6, 3, 5, 3), (1, 4, 4, 1, 3, 1),
                               (1, 6, 6, 130, 2, 3)):
        xq = rng.randint(-127, 128, (b, h, w, i)).astype(np.int8)
        wq = rng.randint(-127, 128, (o, i, k, k)).astype(np.int8)
        want = np.zeros((b, h - k + 1, w - k + 1, o), np.int64)
        for ky in range(k):
            for kx in range(k):
                want += np.einsum(
                    "bhwi,oi->bhwo",
                    xq[:, ky:ky + h - k + 1, kx:kx + w - k + 1].astype(
                        np.int64), wq[:, :, ky, kx].astype(np.int64))
        got = int8_conv_plain(torch.from_numpy(xq), torch.from_numpy(wq))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        # The CPU entry point is the plain version, with and without scales.
        s_x = torch.rand(b) + 0.1
        s_w = torch.rand(o) + 0.1
        assert torch.equal(int8_conv(torch.from_numpy(xq),
                                     torch.from_numpy(wq)), got)
        for dt in (torch.float32, torch.bfloat16):
            assert torch.equal(
                int8_conv(torch.from_numpy(xq), torch.from_numpy(wq), s_x,
                          s_w, dt),
                int8_epilogue_plain(got, s_x, s_w, dt))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def test_calibration_matches_the_jax_engine(engines):
    _, _, js, ts = engines
    assert len(ts) == len(js) == SITES
    np.testing.assert_allclose(ts, js, rtol=1e-5)


def test_int8_render_against_jax_and_float(engines):
    j, t, _, _ = engines
    with jpm("strict"):
        j_q = j.render_stroke(_patch(), None, _opts(jbrush, j))[0]
        j_f = _float_render(j, _opts(jbrush, j))
    t_q = t.render_stroke(_patch(), None, _opts(tbrush, t))[0]
    # With UVS mapping on, one render consumes exactly the calibrated
    # sites: the clarity pass (sfactor_core) stays in float.
    assert quant.sites_consumed() == SITES
    t_f = _float_render(t, _opts(tbrush, t))
    gap = _psnr(t_q, t_f)
    assert 25.0 < gap and 25.0 < _psnr(j_q, j_f)
    assert INT8_PARITY_DB >= gap + 10.0, gap
    assert np.abs(t_q.astype(int) - j_q.astype(int)).max() <= 1
    assert _psnr(t_q, j_q) >= INT8_PARITY_DB
    assert np.any(t_q != t_f)


# Canvas positions of the batch rows, off x or y = 17, 21, 25, 29 (mod 32),
# where the JAX package's jitted noise reads wrong texels on the CPU.
ROW_POS = ((37, 250), (66, 8), (100, 40), (131, 72), (160, 104), (194, 136),
           (226, 168), (259, 200))


def _row_opts(brush, eng, i):
    opts = brush.GanBrushOptions()
    opts.set_style(eng.random_style(20 + i), 20 + i)
    opts.set_position(x=ROW_POS[i][0], y=ROW_POS[i][1])
    opts.enable_uvs_mapping = False
    return opts


def _rows_rgba(eng, brush, geoms, rows, int8=True):
    """``render_batch`` of ``geoms[rows]`` with :func:`_row_opts`, in int8
    under the engine's static scales or in float, as float32 numpy."""
    scales = eng._int8_scales
    if not int8:
        eng._int8_scales = None
    try:
        with jpm("strict"):
            out = eng.render_batch(geoms[rows], [_row_opts(brush, eng, i)
                                                 for i in range(8)][rows])
    finally:
        eng._int8_scales = scales
    return np.asarray(out["rgba"].numpy() if brush is tbrush
                      else out["rgba"])


def _u8(a):
    return np.clip(np.round(a * 255), 0, 255).astype(int)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_int8_batched_rows_against_single_rows(engines, package):
    """A flush's rows against the same rows rendered alone (B = 8 against
    B = 1), in the JAX engine and in the port alike.  In float they agree
    within 1e-6: the batch changes only the f32 rounding of the convs and
    matmuls.  In int8 that rounding can carry an activation across a
    rounding boundary of the int8 grid, and the row then steps by a few
    LSB; each int8 row is held by the rule the card's served-vs-replay
    check uses, 10 dB above the int8-vs-float PSNR."""
    j, t, _, _ = engines
    eng, brush = (j, jbrush) if package == "jax" else (t, tbrush)
    geoms = (np.random.RandomState(11).rand(8, 32, 32, 1) > 0.5).astype(
        np.float32)
    out = {}
    for mode in ("float", "int8"):
        batch = _rows_rgba(eng, brush, geoms, slice(0, 8), mode == "int8")
        single = np.concatenate([
            _rows_rgba(eng, brush, geoms, slice(i, i + 1), mode == "int8")
            for i in range(8)])
        assert batch.shape == single.shape == (8, 32, 32, 4)
        out[mode] = batch, single
    np.testing.assert_allclose(*out["float"], rtol=0, atol=1e-6)
    gap = min(_psnr(_u8(out["int8"][0][i]), _u8(out["float"][0][i]))
              for i in range(8))
    assert gap > 25.0
    for i in range(8):
        assert _psnr(*(_u8(a[i]) for a in out["int8"])) >= gap + 10.0, i


def test_int8_batch_steps_come_from_float_rounding_upstream(engines):
    """Where the port's int8 rows at B = 8 and B = 1 part: every site's
    activation at B = 8 is its B = 1 activation to f32 rounding (1e-5 of
    the site's calibrated amax) until a quantized value flips; the site
    itself is row-exact (its B = 8 output bit-equal, row by row, to the
    same rows alone); and a row in which no site flips a value renders
    within 1e-6 and 0 LSB of its single-row render."""
    _, t, _, ts = engines
    geoms = (np.random.RandomState(11).rand(8, 32, 32, 1) > 0.5).astype(
        np.float32)
    seen, real = [], quant.quantized_conv

    def spy(x, w, padding, source=None):
        seen.append((x.detach().clone(), w, padding, source))
        return real(x, w, padding, source)

    def run(rows):
        seen.clear()
        quant.quantized_conv = spy
        try:
            rgba = _rows_rgba(t, tbrush, geoms, rows)
        finally:
            quant.quantized_conv = real
        return rgba, list(seen)

    batch, sites = run(slice(0, 8))
    singles = [run(slice(i, i + 1)) for i in range(8)]
    assert len(sites) == SITES
    upstream = np.zeros(8, bool)        # a row flipped at an earlier site
    for k, (x, w, padding, source) in enumerate(sites):
        alone = torch.cat([s[1][k][0] for s in singles])
        q = [torch.clamp(torch.round(v / ts[k]), -127, 127)
             for v in (x, alone)]
        flips = (q[0] != q[1]).flatten(1).any(1).numpy()
        diff = (x - alone).abs().flatten(1).amax(1).numpy()
        assert np.all(diff[~upstream] <= 1e-5 * ts[k] * 127), (k, diff)
        upstream |= flips
        with quant.static_scales([ts[k]]):
            whole = quant.quantized_conv(x, w, padding, source)
        for i in range(8):
            with quant.static_scales([ts[k]]):
                row = quant.quantized_conv(x[i:i + 1], w, padding, source)
            assert torch.equal(row, whole[i:i + 1]), (k, i)
    single = np.concatenate([s[0] for s in singles])
    assert (~upstream).any()
    for i in np.flatnonzero(~upstream):
        np.testing.assert_allclose(batch[i], single[i], rtol=0, atol=1e-6)
        assert np.abs(_u8(batch[i]) - _u8(single[i])).max() == 0


def test_int8_off_renders_the_float_render_bit_equal(engines):
    _, t, _, _ = engines
    m = small_model(seed=3)
    tgen, tenc = m["cfg"]
    never = tbrush.TriadGanPaintEngine(
        tgen, m["torch"]["gen_params"], m["torch"]["gen_state"], tenc,
        m["torch"]["enc_params"], m["torch"]["enc_state"],
        geom_inject_resolutions=(0, 1), device="cpu")
    want = never.render_stroke(_patch(), None, _opts(tbrush, never))[0]
    np.testing.assert_array_equal(_float_render(t, _opts(tbrush, t)), want)
    rng = np.random.RandomState(3)
    geoms = (rng.rand(2, 32, 32, 1) > 0.5).astype(np.float32)
    opts = [_opts(tbrush, t, uvs=False) for _ in range(2)]
    scales, t._int8_scales = t._int8_scales, None
    try:
        got = t.render_batch(geoms, opts)["rgba"]
    finally:
        t._int8_scales = scales
    assert torch.equal(got, never.render_batch(geoms, opts)["rgba"])


def test_two_threads_keep_their_own_int8_state(engines):
    """One thread renders under the static scales while another renders
    in float with the same weights: each gets its serial result."""
    _, t, _, _ = engines
    m = small_model(seed=3)
    tgen, tenc = m["cfg"]
    flt = tbrush.TriadGanPaintEngine(
        tgen, m["torch"]["gen_params"], m["torch"]["gen_state"], tenc,
        m["torch"]["enc_params"], m["torch"]["enc_state"],
        geom_inject_resolutions=(0, 1), device="cpu")
    rng = np.random.RandomState(8)
    geoms = (rng.rand(2, 32, 32, 1) > 0.5).astype(np.float32)

    def render(eng):
        return eng.render_batch(geoms, [_opts(tbrush, eng, uvs=False)
                                        for _ in range(2)])["rgba"]

    serial = {"q": render(t), "f": render(flt)}
    got, sites = {"q": [], "f": []}, {}
    barrier = threading.Barrier(2)

    def run(name, eng):
        barrier.wait()
        for _ in range(3):
            got[name].append(render(eng))
        sites[name] = quant.sites_consumed()

    threads = [threading.Thread(target=run, args=a)
               for a in (("q", t), ("f", flt))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name in ("q", "f"):
        assert len(got[name]) == 3
        for out in got[name]:
            assert torch.equal(out, serial[name]), name
    assert sites == {"q": SITES, "f": 0}
    assert not torch.equal(serial["q"], serial["f"])


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------

def test_int8_flag_parses_in_both_clis(engines, tmp_path):
    from brushstroke_engine_torch.ui.server import build_parser
    assert build_parser().parse_args(["--int8", "static"]).int8 == "static"
    assert build_parser().parse_args([]).int8 == "off"
    # The stylize CLI end to end on a seeded bundle: the engine it builds
    # calibrates before it renders.
    from brushstroke_engine_torch.tools import paint_image
    from brushstroke_engine_torch.utils.checkpoint import (
        EngineBundle, save_native,
    )
    m = small_model(seed=3)
    tgen, tenc = m["cfg"]
    t = m["torch"]
    bundle = str(tmp_path / "b.pkl")
    save_native(bundle, EngineBundle(
        tgen, t["gen_params"], t["gen_state"], tenc, t["enc_params"],
        t["enc_state"], geom_inject_resolutions=(0, 1)))
    drawing = np.full((40, 40), 255, np.uint8)
    drawing[18:22, 4:36] = 0
    np.save(tmp_path / "d.npy", drawing)
    calibrated = []
    real = tbrush.GanPaintEngine.enable_int8_serving

    def spy(self, *a, **k):
        calibrated.append(real(self, *a, **k))
        return calibrated[-1]

    tbrush.GanPaintEngine.enable_int8_serving = spy
    try:
        out = paint_image.main([
            "--gan_checkpoint", bundle, "--geo_image",
            str(tmp_path / "d.npy"), "--output_dir", str(tmp_path / "o"),
            "--int8", "static", "--device", "cpu", "--precision", "strict",
            "--overlap_margin", "8", "--crop_margin", "4"])
    finally:
        tbrush.GanPaintEngine.enable_int8_serving = real
    assert os.path.isfile(out)
    assert len(calibrated) == 1 and len(calibrated[0]) == SITES


def test_create_core_takes_the_int8_option(engines):
    from brushstroke_engine_torch.ui.core import create_core
    _, t, _, ts = engines
    m = small_model(seed=3)
    tgen, tenc = m["cfg"]
    eng = tbrush.TriadGanPaintEngine(
        tgen, m["torch"]["gen_params"], m["torch"]["gen_state"], tenc,
        m["torch"]["enc_params"], m["torch"]["enc_state"],
        geom_inject_resolutions=(0, 1), device="cpu")
    core = create_core(paint_engine=eng, device="cpu", int8="static")
    assert core.engine._int8_scales == ts
    with pytest.raises(ValueError, match="int8"):
        create_core(paint_engine=eng, device="cpu", int8="dynamic")


# ---------------------------------------------------------------------------
# The kernel build cache
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_cache(monkeypatch):
    monkeypatch.setattr(compile_cache, "_dir", None)
    monkeypatch.setattr(compile_cache, "_temp", None)
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(native, "SO_PATH", None)
    return compile_cache


def test_fingerprint_is_the_jax_function(fresh_cache):
    assert fresh_cache._host_fingerprint() == jcache._host_fingerprint()
    assert len(fresh_cache._host_fingerprint()) == 10


def test_cache_dir_default_override_and_opt_out(fresh_cache, monkeypatch,
                                               tmp_path):
    fp = fresh_cache._host_fingerprint()
    monkeypatch.delenv("BSE_XLA_CACHE_DIR", raising=False)
    assert fresh_cache.enable_persistent_cache() == \
        os.path.join(REPO, "build", fp)
    assert fresh_cache.build_dir() == os.path.join(REPO, "build", fp)
    assert fresh_cache.enable_persistent_cache(str(tmp_path / "a")) == \
        str(tmp_path / "a" / fp)
    monkeypatch.setenv("BSE_XLA_CACHE_DIR", str(tmp_path / "env"))
    assert fresh_cache.enable_persistent_cache() == \
        str(tmp_path / "env" / fp)
    assert os.path.isdir(tmp_path / "env" / fp)
    monkeypatch.setenv("BSE_XLA_CACHE_DIR", "")
    assert fresh_cache.enable_persistent_cache() is None
    tmp = fresh_cache.build_dir()
    assert os.path.isdir(tmp) and not tmp.startswith(REPO)
    assert fresh_cache.enable_persistent_cache() is None
    assert fresh_cache.build_dir() == tmp


def test_both_build_paths_follow_the_cache(fresh_cache, monkeypatch, tmp_path):
    """nvcc and g++ stubbed: each writes its output where it was told."""
    monkeypatch.setenv("BSE_XLA_CACHE_DIR", str(tmp_path))
    d = str(tmp_path / fresh_cache._host_fingerprint())
    calls = []

    class FakeProc:
        returncode = 0

        def __init__(self, argv, **kw):
            calls.append(argv)
            with open(argv[argv.index("-o") + 1], "w") as f:
                f.write("lib")

        def communicate(self):
            return "ptxas info", None

    def fake_run(argv, **kw):
        calls.append(argv)
        with open(argv[argv.index("-o") + 1], "w") as f:
            f.write("lib")

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    reports = cuda_build.build_all()
    assert set(reports) == set(cuda_build.SOURCES) >= {
        "fir4_epilogue", "warp_twopass", "int8_conv"}
    assert sorted(os.listdir(d)) == sorted(
        f"lib{n}.so" for n in cuda_build.SOURCES)
    assert cuda_build.build_all() == {}          # fresh: nothing rebuilt
    native.build()
    assert native.so_path() == os.path.join(d, "libbse_stroke_raster.so")
    assert os.path.isfile(native.so_path())
    assert all(c[0] in ("nvcc", "g++") for c in calls)
    assert len(calls) == len(cuda_build.SOURCES) + 1


def test_opt_out_leaves_no_library_behind(tmp_path):
    """A process with BSE_XLA_CACHE_DIR="" builds the rasterizer into its
    own temporary directory, which is gone after it exits."""
    code = ("from brushstroke_engine_torch import native\n"
            "from brushstroke_engine_torch.utils import compile_cache\n"
            "assert native.get_lib() is not None, native.load_error()\n"
            "print(compile_cache.build_dir())\n")
    env = dict(os.environ, BSE_XLA_CACHE_DIR="", TMPDIR=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    d = res.stdout.strip().splitlines()[-1]
    assert d.startswith(str(tmp_path)) and not os.path.exists(d)
    assert os.listdir(tmp_path) == []
