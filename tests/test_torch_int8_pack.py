"""The int8 conv's packed weights, its quantizing entry and the per-site
weight cache (``ops/int8_conv.py``, ``ops/quant.py``) on the CPU.

Small shapes.  Tolerances: none -- every comparison is bit for bit.  The
packed layout round-trips exactly; the quantizing entry's plain version is
the unfused chain (quantize in f32, pad as int8, the int8 conv, the
epilogue, the weight quantized in the call) to the bit, at boundary values
``(k + 0.5) * s`` (the half-to-even rounding) and past ``+-127 * s`` (the
clamp); a cached weight gives the output of an uncached one.
"""

import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from brushstroke_engine_torch.ops import quant
from brushstroke_engine_torch.ops.conv import modulated_conv2d
from brushstroke_engine_torch.ops.int8_conv import (
    PackedWeight, int8_conv_plain, int8_conv_quantizing,
    int8_conv_quantizing_plain, int8_epilogue_plain, pack_weight,
    quant_mismatches, quantize_weight, unpack_weight,
)

# The flagship's site geometries (O, I, kh, kw) and odd ones.
WEIGHT_SHAPES = [(128, 128, 3, 3), (64, 64, 3, 3), (3, 64, 1, 1),
                 (5, 3, 3, 3), (17, 130, 3, 3), (1, 1, 1, 1), (9, 33, 3, 1)]
PADDINGS = [((1, 1), (1, 1)), ((0, 0), (0, 0)), ((-1, 2), (1, -1))]


@pytest.fixture(autouse=True)
def _empty_cache():
    quant._wcache.clear()
    yield
    quant._wcache.clear()


def _unfused_chain(x, w, padding, s_x):
    """The site's arithmetic step by step, unfused: the weight quantized
    in the call, the activation quantized in f32 and padded as int8."""
    xf, wf = x.float(), w.float()
    s_w = torch.clamp_min(wf.abs().amax(dim=(1, 2, 3)) / 127.0, 1e-12)
    xq = torch.clamp(torch.round(xf / s_x[:, None, None, None]), -127, 127)
    wq = torch.clamp(torch.round(wf / s_w[:, None, None, None]), -127, 127)
    (py0, py1), (px0, px1) = padding
    xq = F.pad(xq.to(torch.int8), [0, 0, px0, px1, py0, py1])
    acc = int8_conv_plain(xq.contiguous(), wq.to(torch.int8))
    return int8_epilogue_plain(acc, s_x, s_w, x.dtype)


def _boundary_activation(rng, shape, s):
    """Half the values exactly on (k + 0.5) * s, some past +-127 * s, the
    rest Gaussian (s: [B] powers of two, so the products are exact)."""
    s = np.asarray(s, np.float64).reshape(-1, 1, 1, 1)
    half = (rng.randint(-160, 160, shape) + 0.5) * s
    gauss = rng.randn(*shape) * 40 * s
    return np.where(rng.rand(*shape) < 0.5, half, gauss).astype(np.float32)


@pytest.mark.parametrize("shape", WEIGHT_SHAPES)
def test_packed_weight_round_trips_with_zero_padding(shape):
    o, i, kh, kw = shape
    rng = np.random.RandomState(o * 7 + i)
    wq = torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
    data = pack_weight(wq)
    o8, i32 = -(-o // 8) * 8, -(-i // 32) * 32
    assert data.dtype == torch.int8 and data.is_contiguous()
    assert tuple(data.shape) == (o8, kh * kw * i32)
    assert torch.equal(unpack_weight(data, shape), wq)
    grid = data.reshape(o8, kh, kw, i32)
    assert not grid[o:].any() and not grid[..., i:].any()
    # Row o, tap (ky, kx), channel c sits at o * K + (ky * kw + kx) * I32 + c.
    for (oo, c, ky, kx) in ((0, 0, 0, 0), (o - 1, i - 1, kh - 1, kw - 1)):
        assert data[oo, (ky * kw + kx) * i32 + c] == wq[oo, c, ky, kx]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_weight_is_the_unfused_quantization(dtype):
    rng = np.random.RandomState(1)
    w = torch.from_numpy(rng.randn(6, 5, 3, 3).astype(np.float32)).to(dtype)
    w[2] = 0.0                                   # the 1e-12 floor
    wp = quantize_weight(w)
    wf = w.float()
    s_w = torch.clamp_min(wf.abs().amax(dim=(1, 2, 3)) / 127.0, 1e-12)
    wq = torch.clamp(torch.round(wf / s_w[:, None, None, None]), -127, 127)
    assert torch.equal(wp.s_w, s_w) and wp.shape == (6, 5, 3, 3)
    assert torch.equal(unpack_weight(wp.data, wp.shape), wq.to(torch.int8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scales", ["per_sample", "static"])
@pytest.mark.parametrize("padding", PADDINGS)
def test_quantizing_entry_is_the_unfused_chain(dtype, scales, padding):
    rng = np.random.RandomState(3)
    s = [2.0 ** -5, 2.0 ** -7] if scales == "per_sample" else [2.0 ** -6]
    s_x = torch.tensor(s, dtype=torch.float32)
    x = torch.from_numpy(_boundary_activation(
        rng, (2, 9, 7, 5), s if scales == "per_sample" else s * 2)).to(dtype)
    w = torch.from_numpy((rng.randn(6, 5, 3, 3) * 0.2).astype(
        np.float32)).to(dtype)
    want = _unfused_chain(x, w, padding, s_x)
    wp = quantize_weight(w)
    got = int8_conv_quantizing(x, s_x, wp, padding)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(int8_conv_quantizing_plain(x, s_x, wp, padding,
                                                  dtype), want)
    # Values on the boundaries and past the clamp are there.
    q = (x.float() / s_x[:, None, None, None])
    assert bool(((q - q.floor()) == 0.5).any()) and bool((q.abs() > 127).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("padding", PADDINGS)
def test_quantized_conv_matches_the_unfused_chain(dtype, padding):
    """The whole site (dynamic and static scale, with and without a kept
    weight) against the unfused chain."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 8, 6, 4).astype(np.float32) * 3).to(
        dtype)
    w = torch.from_numpy((rng.randn(3, 4, 3, 3) * 0.2).astype(
        np.float32)).to(dtype)
    s_dyn = torch.clamp_min(x.float().abs().amax(dim=(1, 2, 3)) / 127.0,
                            1e-12)
    want = _unfused_chain(x, w, padding, s_dyn)
    assert torch.equal(quant.quantized_conv(x, w, padding), want)
    assert torch.equal(quant.quantized_conv(x, w, padding,
                                            source=(w, "t")), want)
    with quant.static_scales([0.03]):
        got = quant.quantized_conv(x, lambda: w, padding, source=(w, "t"))
    assert torch.equal(got, _unfused_chain(x, w, padding,
                                       torch.tensor([0.03])))


def test_weight_cache_reuses_its_entry_and_requantizes_in_place_changes():
    rng = np.random.RandomState(5)
    w = torch.from_numpy((rng.randn(4, 3, 3, 3) * 0.3).astype(np.float32))
    x = torch.from_numpy(rng.randn(1, 6, 6, 3).astype(np.float32))
    pad = ((1, 1), (1, 1))
    calls = []

    def make():
        calls.append(1)
        return w

    first = quant.site_weight(make, torch.float32, (w, False, True))
    again = quant.site_weight(make, torch.float32, (w, False, True))
    assert again is first and len(calls) == 1
    y0 = quant.quantized_conv(x, w, pad, source=(w, False, True))
    with torch.no_grad():
        w.mul_(-2.0)                      # bumps w._version
    y1 = quant.quantized_conv(x, w, pad, source=(w, False, True))
    assert torch.equal(y1, quant.quantized_conv(x, w, pad))   # uncached
    assert not torch.equal(y1, y0)
    # The call after the change made the new entry; it is served now.
    third = quant.site_weight(make, torch.float32, (w, False, True))
    assert third is not first and len(calls) == 1
    assert torch.equal(unpack_weight(third.data, third.shape),
                       unpack_weight(quantize_weight(w).data, (4, 3, 3, 3)))
    # A new storage under the same tensor (w.data = ...) too.
    w.data = w.data.clone() * 0.5
    fourth = quant.site_weight(make, torch.float32, (w, False, True))
    assert fourth is not third and len(calls) == 2


def test_weight_cache_keys_dtype_derivation_and_parameter_apart():
    rng = np.random.RandomState(6)
    w = torch.from_numpy((rng.randn(4, 3, 3, 3) * 0.3).astype(np.float32))
    v = w.clone()
    entries = {
        "f32": quant.site_weight(w, torch.float32, (w, False, True)),
        "bf16": quant.site_weight(w.bfloat16(), torch.bfloat16,
                                  (w, True, True)),
        "flip": quant.site_weight(w.flip([2, 3]), torch.float32,
                                  (w, False, False)),
        "other": quant.site_weight(v * 2, torch.float32, (v, False, True)),
    }
    assert len({id(e) for e in entries.values()}) == 4
    assert len(quant._wcache) == 4
    assert torch.equal(unpack_weight(entries["bf16"].data, (4, 3, 3, 3)),
                       unpack_weight(quantize_weight(w.bfloat16()).data,
                                     (4, 3, 3, 3)))
    assert quant.site_weight(None, torch.float32, (w, False, True)) \
        is entries["f32"]


def test_weight_cache_under_threads():
    """Two threads, each with its own parameter and dtype, quantize and hit
    the cache at once: each gets its own weight, and the outputs equal the
    uncached ones."""
    rng = np.random.RandomState(7)
    params = [torch.from_numpy((rng.randn(4, 3, 3, 3) * 0.3).astype(
        np.float32)) for _ in range(2)]
    x = torch.from_numpy(rng.randn(1, 6, 6, 3).astype(np.float32))
    pad = ((1, 1), (1, 1))
    dtypes = [torch.float32, torch.bfloat16]
    want = [quant.quantized_conv(x.to(dt), p.to(dt), pad)
            for p, dt in zip(params, dtypes)]
    got = [[], []]
    barrier = threading.Barrier(2)

    def run(k):
        barrier.wait()
        for _ in range(20):
            got[k].append(quant.quantized_conv(
                x.to(dtypes[k]), lambda: params[k].to(dtypes[k]), pad,
                source=(params[k], False, True)))

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k in range(2):
        assert len(got[k]) == 20
        assert all(torch.equal(y, want[k]) for y in got[k])
    assert len(quant._wcache) == 2


def test_modulated_conv2d_keeps_one_weight_per_parameter():
    """An int8 site quantizes its parameter once across calls with new
    styles, and the result equals a site that quantizes every call."""
    rng = np.random.RandomState(8)
    weight = torch.from_numpy((rng.randn(5, 4, 3, 3) * 0.2).astype(
        np.float32))
    x = torch.from_numpy(rng.randn(2, 8, 8, 4).astype(np.float32))
    outs = []
    with quant.int8_inference():
        for k in range(3):
            s = torch.from_numpy((rng.rand(2, 4) + 0.5).astype(np.float32))
            outs.append((modulated_conv2d(x, weight, s, padding=1), s))
        assert len(quant._wcache) == 1
        for y, s in outs:
            quant._wcache.clear()
            assert torch.equal(y, modulated_conv2d(x, weight, s, padding=1))


def test_kernel_only_entries_refuse_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        quant_mismatches(torch.tensor([0.01]))
    wp = quantize_weight(torch.ones(2, 3, 1, 1))
    assert isinstance(wp, PackedWeight)
    with pytest.raises(ValueError, match="unsupported device"):
        int8_conv_quantizing(torch.ones(1, 2, 2, 3, device="meta"),
                             torch.ones(1, device="meta"), wp,
                             ((0, 0), (0, 0)))
