"""Parity of the torch port's ops against the JAX package on the CPU.

The same numpy inputs go through each JAX op (strict f32) and its port
counterpart (TF32 off).  Tolerance 1e-5 abs/rel for f32 ops: both sides are
exact f32 arithmetic and differ only in summation order over at most a few
hundred terms of unit scale.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brushstroke_engine_tpu import ops as jops
from brushstroke_engine_tpu.ops.precision import precision_mode
from brushstroke_engine_torch import ops as tops
from brushstroke_engine_torch.ops.precision import set_precision_mode

set_precision_mode("strict")

TOL = dict(rtol=1e-5, atol=1e-5)


def rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def jax_run(fn, *args, **kw):
    with precision_mode("strict"):
        return np.asarray(fn(*args, **kw))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


class TestUpfirdn2d:
    @pytest.mark.parametrize("up,down,padding", [
        (1, 1, 0), (1, 1, 2), (2, 1, 1), (1, 2, 1), (2, 2, 2),
        (1, 1, [1, 2, 0, 3]), (2, 1, [-1, 2, 1, -1]), (1, 1, -1),
    ])
    @pytest.mark.parametrize("ftaps", [None, [1, 3, 3, 1], [1, 2, 1]])
    def test_upfirdn2d(self, up, down, padding, ftaps):
        rng = np.random.RandomState(0)
        x = rand(rng, 2, 8, 8, 3)
        f = tops.setup_filter(ftaps) if ftaps is not None else None
        want = jax_run(jops.upfirdn2d, jnp.asarray(x), f, up=up, down=down,
                       padding=padding)
        got = tops.upfirdn2d(t(x), f, up=up, down=down, padding=padding)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_gain_and_flip(self):
        rng = np.random.RandomState(1)
        x = rand(rng, 1, 6, 6, 2)
        fa = np.array([[0.0, 1.0], [2.0, 0.5]], np.float32)
        want = jax_run(jops.upfirdn2d, jnp.asarray(x), fa, padding=1,
                       flip_filter=True, gain=2.0)
        got = tops.upfirdn2d(t(x), fa, padding=1, flip_filter=True, gain=2.0)
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    @pytest.mark.parametrize("name", ["filter2d", "upsample2d",
                                      "downsample2d"])
    def test_wrappers(self, name):
        rng = np.random.RandomState(2)
        x = rand(rng, 2, 8, 8, 4)
        f = tops.setup_filter([1, 3, 3, 1])
        want = jax_run(getattr(jops, name), jnp.asarray(x), f)
        got = getattr(tops, name)(t(x), f)
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    @pytest.mark.parametrize("taps,kw", [
        ([1, 3, 3, 1], {}), ([1, 2, 1], {"gain": 4.0}), (None, {}),
        ([[1, 2], [3, 4]], {"flip_filter": True})])
    def test_setup_filter(self, taps, kw):
        np.testing.assert_array_equal(tops.setup_filter(taps, **kw),
                                      jops.setup_filter(taps, **kw))


class TestBiasAct:
    @pytest.mark.parametrize("act", sorted(tops.ACTIVATIONS))
    @pytest.mark.parametrize("clamp", [None, 0.7])
    def test_bias_act(self, act, clamp):
        rng = np.random.RandomState(3)
        x = rand(rng, 2, 5, 5, 6) * 2
        b = rand(rng, 6)
        want = jax_run(jops.bias_act, jnp.asarray(x), jnp.asarray(b),
                       act=act, clamp=clamp)
        got = tops.bias_act(t(x), t(b), act=act, clamp=clamp)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert tops.activation_gain(act) == jops.activation_gain(act)


def _hwio(w_oihw):
    return np.ascontiguousarray(np.transpose(w_oihw, (2, 3, 1, 0)))


class TestConv:
    @pytest.mark.parametrize("up,down,flip_weight", [
        (1, 1, True), (1, 1, False), (2, 1, False), (2, 1, True),
        (1, 2, True)])
    def test_conv2d_resample(self, up, down, flip_weight):
        rng = np.random.RandomState(4)
        x = rand(rng, 2, 8, 8, 5)
        w = rand(rng, 6, 5, 3, 3)
        f = tops.setup_filter([1, 3, 3, 1])
        want = jax_run(jops.conv2d_resample, jnp.asarray(x),
                       jnp.asarray(_hwio(w)), f=f, up=up, down=down,
                       padding=1, flip_weight=flip_weight)
        got = tops.conv2d_resample(t(x), t(w), f=f, up=up, down=down,
                                   padding=1, flip_weight=flip_weight)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("demodulate,with_noise,up", [
        (True, False, 1), (False, False, 1), (True, True, 1),
        (True, True, 2), (False, False, 2)])
    def test_modulated_conv2d(self, demodulate, with_noise, up):
        rng = np.random.RandomState(5)
        x = rand(rng, 2, 8, 8, 6)
        w = rand(rng, 7, 6, 3, 3)
        s = rand(rng, 2, 6) + 1.0
        out_res = 8 * up
        noise = rand(rng, 2, out_res, out_res, 1) if with_noise else None
        f = tops.setup_filter([1, 3, 3, 1])
        want = jax_run(
            jops.modulated_conv2d, jnp.asarray(x), jnp.asarray(_hwio(w)),
            jnp.asarray(s),
            noise=None if noise is None else jnp.asarray(noise), up=up,
            padding=1, resample_filter=f, demodulate=demodulate,
            flip_weight=(up == 1))
        got = tops.modulated_conv2d(
            t(x), t(w), t(s), noise=None if noise is None else t(noise),
            up=up, padding=1, resample_filter=f, demodulate=demodulate,
            flip_weight=(up == 1))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("act,clamp", [("relu", None), ("lrelu", 0.5),
                                           ("linear", None)])
    def test_up2_epilogue_matches_jax_chain(self, act, clamp):
        # The fused FIR epilogue against the JAX modulated conv + bias_act.
        rng = np.random.RandomState(9)
        x = rand(rng, 2, 8, 8, 6)
        w = rand(rng, 7, 6, 3, 3)
        s = rand(rng, 2, 6) + 1.0
        noise = rand(rng, 1, 16, 16, 1)
        b = rand(rng, 7)
        f = tops.setup_filter([1, 3, 3, 1])
        gain = tops.activation_gain(act)
        with precision_mode("strict"):
            y = jops.modulated_conv2d(
                jnp.asarray(x), jnp.asarray(_hwio(w)), jnp.asarray(s),
                noise=jnp.asarray(noise), up=2, padding=1, resample_filter=f,
                flip_weight=False)
            want = np.asarray(jops.bias_act(y, jnp.asarray(b), act=act,
                                            gain=gain, clamp=clamp))
        got = tops.modulated_conv2d(
            t(x), t(w), t(s), noise=t(noise), up=2, padding=1,
            resample_filter=f, flip_weight=False, bias=t(b), activation=act,
            act_gain=gain, clamp=clamp)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("kw,exc", [
        (dict(up=2, activation="tanh"), NotImplementedError),
        (dict(up=4), NotImplementedError),
        (dict(up=2, resample_filter=[1, 2, 1]), ValueError)])
    def test_up_path_raises_outside_kernel(self, kw, exc):
        # Every up-sampling conv runs the FIR-epilogue kernel; what it does
        # not take raises on every device instead of taking another route.
        rng = np.random.RandomState(10)
        kw = dict(kw, resample_filter=tops.setup_filter(
            kw.get("resample_filter", [1, 3, 3, 1])))
        with pytest.raises(exc):
            tops.modulated_conv2d(t(rand(rng, 1, 4, 4, 3)),
                                  t(rand(rng, 5, 3, 3, 3)),
                                  t(rand(rng, 1, 3)), padding=1,
                                  flip_weight=False, **kw)


class TestNoise:
    @pytest.mark.parametrize("r_l,r_img,pos", [
        (8, 32, [[3, 17]]),
        (16, 32, [[31, 5], [9, 30], [0, 0]]),
        (32, 32, [[1, 2], [130, 77]]),
        (16, 64, [[63, 1], [200, -5]]),
    ])
    def test_wrapped_const_noise(self, r_l, r_img, pos):
        rng = np.random.RandomState(6)
        tex = rand(rng, r_l, r_l)
        want = jax_run(jops.wrapped_const_noise, jnp.asarray(tex),
                       jnp.asarray(pos, jnp.int32), r_img)
        got = tops.wrapped_const_noise(t(tex), torch.tensor(pos), r_img)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
