"""The port's device banks (``train/device_dataset.py``) against the JAX
package's, on the CPU: the bank draw and its float conversion on the same
indices, the training-resolution crop, the stitch crop's range on a grid of
positions, widths, margins and overlaps, and the size guard with its
message.  Exact equality throughout: the same uint8 values go through the
same f32 conversions, and the crops are integer algebra.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.engine import areas as jareas
from brushstroke_engine_tpu.train import device_dataset as jdd
from brushstroke_engine_torch.parallel.distributed import (
    RankGroup, rank_context,
)
from brushstroke_engine_torch.parallel.mesh import make_mesh
from brushstroke_engine_torch.train import device_dataset as tdd


class _ArrayDS:
    def __init__(self, arr):
        self.arr = arr

    def __len__(self):
        return len(self.arr)

    def __getitem__(self, i):
        return self.arr[i]


def _banks(seed=0, ns=10, ng=7, r=8, hw=12):
    rng = np.random.RandomState(seed)
    return ((rng.rand(ns, r, r, 3) * 255).astype(np.uint8),
            (rng.rand(ng, hw, hw, 3) * 255).astype(np.uint8))


def test_sample_banks_equals_jax_on_the_same_indices():
    style, tri = _banks()
    key = jax.random.PRNGKey(3)
    js, jt = jdd.sample_banks(jnp.asarray(style), jnp.asarray(tri), key, 5)
    ks, kg = jax.random.split(key)
    idx = (np.asarray(jax.random.randint(ks, (5,), 0, 10)),
           np.asarray(jax.random.randint(kg, (5,), 0, 7)))
    ts, tt = tdd.sample_banks(torch.from_numpy(style), torch.from_numpy(tri),
                              5, draws=idx)
    assert ts.dtype == tt.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # Its own draws: uniform indices with replacement from the generator,
    # so equal generators give equal batches.
    a = tdd.sample_banks(torch.from_numpy(style), torch.from_numpy(tri), 64,
                         torch.Generator().manual_seed(1))
    b = tdd.sample_banks(torch.from_numpy(style), torch.from_numpy(tri), 64,
                         torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    rows = {tuple(np.round(x, 6).ravel()[:8]) for x in a[0].numpy()}
    assert len(rows) == 10          # 64 draws from 10 items hit every one


@pytest.mark.parametrize("crop", [(0, 0), (2, 3), (4, 4)])
def test_crop_tri_equals_jax(crop):
    _, tri = _banks(1)
    tri = tri.astype(np.float32) / 255.0
    c = np.asarray([crop[0], crop[1], 8, 8], np.int32)
    jin, jtruth = jdd.crop_tri(jnp.asarray(tri), jnp.asarray(c), 8)
    tin, ttruth = tdd.crop_tri(torch.from_numpy(tri), tuple(c), 8)
    assert tin.shape == (7, 8, 8, 1)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_array_equal(ttruth.numpy(), np.asarray(jtruth))


class _Bounds:
    """A ``random.Random`` stand-in that records ``randint``'s bounds."""

    def __init__(self):
        self.seen = []

    def randint(self, lo, hi):
        self.seen.append((lo, hi))
        return lo


GRID = [(y, x, res, margin, overlap)
        for y, x in ((0, 0), (3, 40), (40, 3), (64, 64))
        for res in (32, 64, 128) for margin in (0, 10)
        for overlap in (16, 50)]


@pytest.mark.parametrize("y,x,res,margin,overlap", GRID)
def test_crop2_range_is_the_jax_algebra(y, x, res, margin, overlap):
    """``rmin`` / ``rmax`` per axis equal the bounds the JAX stitcher draws
    between (``engine/areas.py``, the algebra the JAX ``gen_crops``
    mirrors), on a square image of res + 64."""
    width = res + 64
    rec = _Bounds()
    jareas.gen_overlapping_square_crop(width, (y, x, res, res), margin,
                                       overlap, rec)
    lo, hi = tdd.crop2_range((y, x), (width, width), res, margin, overlap)
    assert list(zip(lo, hi)) == rec.seen


@pytest.mark.parametrize("hw,res,margin,overlap", [
    ((96, 96), 32, 10, 50), ((192, 160), 128, 10, 50)])
def test_gen_crops_draws_inside_the_jax_range(hw, res, margin, overlap):
    """Both packages' draws stay within the same inclusive ranges (the JAX
    package draws on the device from keys, the port on the host from a
    numpy stream)."""
    keys = jax.random.split(jax.random.PRNGKey(0), 256)
    jc1, jc2 = jax.vmap(lambda k: jdd.gen_crops(k, hw, res, True, margin,
                                                overlap))(keys)
    jc1, jc2 = np.asarray(jc1), np.asarray(jc2)
    rng = np.random.default_rng(0)
    tc = [tdd.gen_crops(rng, hw, res, True, margin, overlap)
          for _ in range(256)]
    for c1, c2 in list(zip(jc1, jc2)) + tc:
        assert tuple(c1[2:]) == tuple(c2[2:]) == (res, res)
        assert 0 <= c1[0] <= hw[0] - res and 0 <= c1[1] <= hw[1] - res
        lo, hi = tdd.crop2_range(c1[:2], hw, res, margin, overlap)
        assert lo[0] <= c2[0] <= hi[0] and lo[1] <= c2[1] <= hi[1]
    # Without stitching: crop1 alone, from the loop's two integer draws.
    rng = np.random.default_rng(5)
    c1, c2 = tdd.gen_crops(rng, hw, res, False)
    want = np.random.default_rng(5)
    assert c2 is None and c1 == (int(want.integers(0, hw[0] - res + 1)),
                                 int(want.integers(0, hw[1] - res + 1)),
                                 res, res)


def test_build_banks_guard_and_errors_as_jax():
    style, tri = _banks(2)
    banks = tdd.build_device_banks(_ArrayDS(style), _ArrayDS(tri),
                                   device="cpu")
    assert banks.tri_hw == (12, 12) and banks.style.dtype == torch.uint8
    np.testing.assert_array_equal(banks.style.numpy(), style)
    np.testing.assert_array_equal(banks.tri.numpy(), tri)
    for kw in (dict(max_bytes=16), dict(max_bytes=style.nbytes)):
        with pytest.raises(ValueError) as te:
            tdd.build_device_banks(_ArrayDS(style), _ArrayDS(tri),
                                   device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            jdd.build_device_banks(_ArrayDS(style), _ArrayDS(tri), **kw)
        assert str(te.value) == str(je.value)
        assert "device residency" in str(te.value)
    assert tdd.DEFAULT_MAX_BANK_BYTES == jdd.DEFAULT_MAX_BANK_BYTES == 6 << 30
    f32 = style.astype(np.float32)
    with pytest.raises(ValueError, match="uint8"):
        tdd.build_device_banks(_ArrayDS(f32), _ArrayDS(tri), device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        jdd.build_device_banks(_ArrayDS(f32), _ArrayDS(tri))
    # A mesh: the banks whole on its device; under a group of two ranks each
    # rank draws the global batch's indices and keeps its half.
    on_mesh = tdd.build_device_banks(_ArrayDS(style), _ArrayDS(tri),
                                     mesh=make_mesh(device="cpu"))
    assert torch.equal(on_mesh.style, banks.style)
    assert torch.equal(on_mesh.tri, banks.tri)
    full = tdd.sample_banks(banks.style, banks.tri, 4,
                            torch.Generator().manual_seed(7))
    halves = []
    for rank in range(2):
        with rank_context(RankGroup(None, rank, 2)):
            halves.append(tdd.sample_banks(
                banks.style, banks.tri, 2, torch.Generator().manual_seed(7)))
    for i in range(2):
        assert torch.equal(torch.cat([h[i] for h in halves]), full[i])
