"""The port's FIR-epilogue op (plain version on the CPU) against the JAX
package's ``fir4_epilogue_reference`` and its interpret-mode Pallas kernel,
and the port's up=2 synthesis layer against JAX ``_synthesis_layer_apply``.

Tolerance 1e-5 (rel and abs) where both sides compute in f32: they differ
only in the order of the 16-term FIR sum.  Inputs up to 100x larger (the
no-clamp case) get 1e-3 abs, the same 1e-7-relative rounding at that scale.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from brushstroke_engine_tpu.models import synthesis as jsyn
from brushstroke_engine_tpu.ops import pallas_fir as pf
from brushstroke_engine_tpu.ops.precision import precision_mode
from brushstroke_engine_torch.models import synthesis as tsyn
from brushstroke_engine_torch.ops import fir_epilogue as tfir
from brushstroke_engine_torch.ops.filters import setup_filter
from brushstroke_engine_torch.ops.precision import set_precision_mode
from brushstroke_engine_torch.utils.checkpoint import params_from_jax

set_precision_mode("strict")


def make_inputs(seed, B=2, H=32, W=32, C=16, with_noise=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H + 3, W + 3, C).astype(np.float32)
    f = setup_filter([1, 3, 3, 1])
    d = (rng.rand(B, C) * 0.5 + 0.7).astype(np.float32)
    noise = rng.randn(B, H, W, 1).astype(np.float32) if with_noise else None
    bias = rng.randn(C).astype(np.float32)
    return x, f, d, noise, bias


def _jax(x, f, d, noise, bias, *args):
    return np.asarray(pf.fir4_epilogue_reference(
        jnp.asarray(x), f, jnp.asarray(d),
        None if noise is None else jnp.asarray(noise), jnp.asarray(bias),
        *args))


def _port(x, f, d, noise, bias, *args):
    t = torch.from_numpy
    return tfir.fir4_epilogue(
        t(x), f, t(d), None if noise is None else t(noise), t(bias),
        *args).numpy()


class TestFirEpiloguePlain:
    @pytest.mark.parametrize("case", ["no_noise", "noise", "nonseparable",
                                      "no_clamp"])
    def test_matches_jax_reference(self, case):
        x, f, d, noise, bias = make_inputs(
            seed=["no_noise", "noise", "nonseparable", "no_clamp"].index(case),
            with_noise=(case == "noise"))
        args = (1.4142, 256.0)
        tol = dict(rtol=1e-5, atol=1e-5)
        if case == "nonseparable":
            f = np.random.RandomState(7).randn(4, 4).astype(np.float32)
            args = (1.0, None)
        elif case == "no_clamp":
            bias = bias * 100
            args = (1.0, None)
            tol = dict(rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(_port(x, f, d, noise, bias, *args),
                                   _jax(x, f, d, noise, bias, *args), **tol)

    def test_matches_pallas_interpret(self):
        x, f, d, _, bias = make_inputs(seed=4)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(pf.fir4_epilogue(
                jnp.asarray(x), f, jnp.asarray(d), None, jnp.asarray(bias),
                1.4142, 256.0))
        got = _port(x, f, d, None, bias, 1.4142, 256.0)
        # The Pallas kernel applies the FIR as two rank-1 passes of SVD
        # factors, whose rounding differs from the 4x4 sum by ~1e-6 rel.
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_bf16_input_rounds_once(self):
        x, f, d, noise, bias = make_inputs(seed=5, with_noise=True)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        got = tfir.fir4_epilogue(xb, f, torch.from_numpy(d),
                                 torch.from_numpy(noise),
                                 torch.from_numpy(bias), 1.4142, 256.0,
                                 out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        want = _jax(xb.float().numpy(), f, d, noise, bias, 1.4142, 256.0)
        # f32 math on the bf16-rounded input, one rounding to bf16 at the
        # end: within half a bf16 ulp (at most 2^-8 relative).
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                                   atol=1e-6)

    def test_cpu_call_does_not_count_as_launch(self):
        before = tfir.fir4_epilogue.launches
        x, f, d, _, bias = make_inputs(seed=6, H=8, W=8, C=4)
        _port(x, f, d, None, bias, 1.0, None)
        assert tfir.fir4_epilogue.launches == before

    def test_rejects_non_4x4_filter(self):
        x, _, d, _, bias = make_inputs(seed=6, H=8, W=8, C=4)
        with pytest.raises(ValueError):
            _port(x, setup_filter([1, 2, 1]), d, None, bias, 1.0, None)


class TestSynthesisLayerUp2:
    @pytest.mark.parametrize("positions", [None, [[5, 37], [100, 3]]])
    def test_matches_jax_layer(self, positions):
        rng = np.random.RandomState(8)
        cfg_j = jsyn.SynthesisConfig(w_dim=8, img_resolution=32,
                                     channel_base=256, channel_max=16)
        cfg_t = tsyn.SynthesisConfig(w_dim=8, img_resolution=32,
                                     channel_base=256, channel_max=16)
        in_ch, out_ch, res = 12, 16, 16
        params = {
            "affine": {"weight": rng.randn(8, in_ch).astype(np.float32),
                       "bias": np.ones(in_ch, np.float32)},
            "weight": rng.randn(3, 3, in_ch, out_ch).astype(np.float32),
            "bias": rng.randn(out_ch).astype(np.float32),
            "noise_strength": np.float32(0.3),
        }
        x = rng.randn(2, res // 2, res // 2, in_ch).astype(np.float32)
        w = rng.randn(2, 8).astype(np.float32)
        tex = rng.randn(res, res).astype(np.float32)
        with precision_mode("strict"):
            want = np.asarray(jsyn._synthesis_layer_apply(
                cfg_j, {k: jnp.asarray(v) if not isinstance(v, dict) else
                        {kk: jnp.asarray(vv) for kk, vv in v.items()}
                        for k, v in params.items()},
                jnp.asarray(x), jnp.asarray(w), resolution=res, up=2,
                noise_const=jnp.asarray(tex),
                positions=None if positions is None
                else jnp.asarray(positions)))
        got = tsyn._synthesis_layer_apply(
            cfg_t, params_from_jax(params), torch.from_numpy(x),
            torch.from_numpy(w), resolution=res, up=2,
            noise_const=torch.from_numpy(tex),
            positions=None if positions is None else torch.tensor(positions))
        assert got.shape == want.shape == (2, res, res, out_ch)
        # A 108-term conv sum then the 16-term FIR, reordered: 1e-4 abs on
        # outputs of magnitude ~10.
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


class TestOffVectorPathShapes:
    """Shapes the CUDA kernel serves off its 16-byte path (C = 20 is a
    multiple of 4 but not of 8, C = 5 of neither; H != W; W narrower than a
    thread's column walk; one pixel): here the plain version against the
    JAX reference, on the card the kernel against the plain version."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", [(2, 13, 9, 20), (3, 5, 7, 5),
                                       (2, 6, 3, 24), (1, 1, 1, 8)])
    def test_plain_matches_jax_reference(self, shape, dtype):
        b, h, w, c = shape
        x, f, d, noise, bias = make_inputs(seed=9, B=b, H=h, W=w, C=c,
                                           with_noise=True)
        if dtype == "float32":
            got = _port(x, f, d, noise, bias, 1.4142, 256.0)
            want = _jax(x, f, d, noise, bias, 1.4142, 256.0)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            return
        xb = torch.from_numpy(x).to(torch.bfloat16)
        got = tfir.fir4_epilogue(xb, f, torch.from_numpy(d),
                                 torch.from_numpy(noise),
                                 torch.from_numpy(bias), 1.4142, 256.0)
        assert got.dtype == torch.bfloat16 and got.shape == shape
        want = _jax(xb.float().numpy(), f, d, noise, bias, 1.4142, 256.0)
        # One rounding to bf16 at the end: half a bf16 ulp.
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                                   atol=1e-6)


class TestTapsCache:
    def test_same_filter_same_object(self):
        f = setup_filter([1, 3, 3, 1])
        a = tfir.cached_taps(f)
        assert tfir.cached_taps(setup_filter([1, 3, 3, 1])) is a
        assert tfir.cached_taps(torch.from_numpy(f.copy())) is a
        np.testing.assert_array_equal(a, tfir.correlation_taps(f))
        assert not a.flags.writeable

    def test_other_filter_or_gain_other_taps(self):
        f = setup_filter([1, 3, 3, 1])
        a = tfir.cached_taps(f)
        g = np.random.RandomState(3).randn(4, 4).astype(np.float32)
        b = tfir.cached_taps(g)
        assert b is not a
        np.testing.assert_array_equal(b, g[::-1, ::-1] * np.float32(4.0))
        c = tfir.cached_taps(f, fir_gain=1.0)
        assert c is not a
        np.testing.assert_allclose(c * 4.0, a, rtol=1e-7)
        # The cache is by content: mutating the caller's filter afterwards
        # changes neither entry.
        f2 = f.copy()
        a2 = tfir.cached_taps(f2)
        f2[0, 0] = 99.0
        assert tfir.cached_taps(f2) is not a2
        np.testing.assert_array_equal(a2, a)

    def test_cached_taps_reject_non_4x4(self):
        with pytest.raises(ValueError):
            tfir.cached_taps(setup_filter([1, 2, 1]))

    def test_ctypes_taps_hold_the_same_16_floats(self):
        a = tfir.cached_taps(setup_filter([1, 3, 3, 1]))
        t16 = tfir._taps16(a.tobytes())
        assert tfir._taps16(a.tobytes()) is t16
        np.testing.assert_array_equal(np.array(list(t16), np.float32),
                                      a.ravel())
