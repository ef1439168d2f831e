"""The port's copy of the training data pipeline against the JAX package's.

Numpy on both sides, and strokes drawn by the same rasterizer on both sides
(the C++ library of each package's ``native.py``, built from the same source
with the same flags, or both numpy forms), so the comparison is exact."""

import itertools
import zipfile

import numpy as np
import pytest

from brushstroke_engine_tpu.data import curves as jcurves
from brushstroke_engine_tpu.train import dataset as jds
from brushstroke_engine_tpu.utils.img_proc import resize_bilinear as jresize
from brushstroke_engine_torch.data import curves as tcurves
from brushstroke_engine_torch.train import dataset as tds
from brushstroke_engine_torch.utils.img_proc import resize_bilinear
from tests.torch_helpers import jax_native


@pytest.mark.parametrize("idx", [0, 1, 7])
def test_synthetic_geometry_is_the_jax_package_s(idx):
    want = jds.SyntheticGeometryDataset(48, size=16, seed=3)[idx]
    got = tds.SyntheticGeometryDataset(48, size=16, seed=3)[idx]
    assert got.dtype == np.uint8 and got.shape == (48, 48, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rasterizer", ["numpy", "native"])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_geometry_192px_is_exactly_the_jax_package_s(
        seed, rasterizer, monkeypatch):
    """Both packages draw each item through ``random_spline_stroke`` ->
    ``draw_stroke``, with the rasterizer pinned alike on both sides: both
    numpy forms, or both C++ libraries.  Equal uint8 items over 16 indices
    at the training size (128 px + 64)."""
    from brushstroke_engine_torch import native as tnative
    for native in (jax_native(), tnative):
        if rasterizer == "numpy":
            monkeypatch.setattr(native, "get_lib", lambda: None)
        else:
            assert native.available()
    want = jds.SyntheticGeometryDataset(192, size=100, seed=seed)
    got = tds.SyntheticGeometryDataset(192, size=100, seed=seed)
    for idx in range(16):
        np.testing.assert_array_equal(got[idx], want[idx], err_msg=str(idx))


def test_stroke_and_triband_helpers_match():
    for seed in (0, 5):
        a = jcurves.random_spline_stroke(np.random.default_rng(seed), 40)
        b = tcurves.random_spline_stroke(np.random.default_rng(seed), 40)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tcurves.triband_from_stroke(b),
                                   jcurves.triband_from_stroke(b), rtol=0,
                                   atol=1e-6)
    assert tcurves.sample_radius(np.random.default_rng(2)) == \
        jcurves.sample_radius(np.random.default_rng(2))


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=False),
                                dict(seed=4, rank=1, num_ranks=2)])
def test_infinite_indices_match(kw):
    want = list(itertools.islice(jds.infinite_indices(11, **kw), 50))
    got = list(itertools.islice(tds.infinite_indices(11, **kw), 50))
    assert got == want


@pytest.mark.parametrize("shape,out", [((9, 13, 3), (16, 16)),
                                       ((20, 12), (7, 9))])
def test_resize_bilinear_matches(shape, out):
    img = np.random.RandomState(0).rand(*shape).astype(np.float32) * 255
    np.testing.assert_array_equal(resize_bilinear(img, *out),
                                  jresize(img, *out))


def _write_images(root, n=5):
    import PIL.Image
    rng = np.random.RandomState(1)
    for i in range(n):
        h, w = (40 + 3 * i, 52 - 2 * i) if i % 2 else (20, 24)
        arr = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        sub = root / ("a" if i % 2 else "b")
        sub.mkdir(exist_ok=True)
        PIL.Image.fromarray(arr).save(sub / f"img_{i}.png")


@pytest.mark.parametrize("kw", [
    dict(), dict(resize_mode="resize"), dict(xflip=True, channels=1),
    dict(regexp=r"a/", max_size=2, channels=4)])
def test_image_folder_dataset_matches(tmp_path, kw):
    _write_images(tmp_path)
    want = jds.ImageFolderDataset(str(tmp_path), 32, seed=6, **kw)
    got = tds.ImageFolderDataset(str(tmp_path), 32, seed=6, **kw)
    assert len(got) == len(want) and got.names == want.names
    for i in range(len(want)):
        np.testing.assert_array_equal(got[i], want[i])


def test_image_folder_dataset_reads_a_zip(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    _write_images(src)
    path = tmp_path / "data.zip"
    with zipfile.ZipFile(path, "w") as z:
        for f in sorted(src.rglob("*.png")):
            z.write(f, f.relative_to(src).as_posix())
    want = jds.ImageFolderDataset(str(path), 24, seed=2)
    got = tds.ImageFolderDataset(str(path), 24, seed=2)
    for i in range(len(want)):
        np.testing.assert_array_equal(got[i], want[i])
    with pytest.raises(ValueError):
        tds.ImageFolderDataset(str(path), 24, regexp="nothing_matches")


def test_batch_iterator_and_float_conversions():
    ds = tds.CachedDataset(tds.NoiseStyleDataset(8, size=6, seed=1))
    it_t = tds.BatchIterator(ds, 4, seed=3)
    it_j = jds.BatchIterator(ds, 4, seed=3)
    for _ in range(3):
        a, b = next(it_t), next(it_j)
        assert a.shape == (4, 8, 8, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert set(ds._items) <= set(range(6)) and len(ds) == 6
    np.testing.assert_array_equal(ds[2], tds.NoiseStyleDataset(8, 6, 1)[2])
    np.testing.assert_array_equal(tds.style_batch_to_float(a),
                                  jds.style_batch_to_float(a))
    np.testing.assert_array_equal(tds.geom_batch_to_float(a),
                                  jds.geom_batch_to_float(a))
    tri = np.random.RandomState(0).rand(2, 20, 20, 3).astype(np.float32)
    c1, p1 = tds.crop_geometry(tri, 12, np.random.default_rng(5))
    c2, p2 = jds.crop_geometry(tri, 12, np.random.default_rng(5))
    assert p1 == p2 and p1[2:] == (12, 12)
    np.testing.assert_array_equal(c1, c2)
