"""The data chain: the port's six data-preparation CLIs against the JAX
package's scripts, image files as Pillow reads them, and the port's shell
entry points.

Each CLI runs on the same small inputs (4-6 images at 32-48 px) through the
JAX script (its ``main`` with ``sys.argv`` set) and through the port, with
Pillow and with Pillow hidden (the path where it is missing).  Member names and
decoded pixels must be exactly equal: both packages run the same numpy
arithmetic and draw strokes with the same C++ library; only the PNG encoders
differ, so files are compared by their pixels, never by their bytes."""

import io
import os
import re
import struct
import subprocess
import sys
import zipfile
import zlib

import numpy as np
import PIL.Image
import pytest

from brushstroke_engine_tpu.train import dataset as jds
from brushstroke_engine_torch.tools import (
    create_splines, dataset_tool, make_synthetic_styles, patch_augment,
    prep_geom_data, project_main, reformat_triband_data_main,
)
from brushstroke_engine_torch.train import dataset as tds
from brushstroke_engine_torch.utils.img_proc import (
    patch_entropy, read_image, read_png,
)
from tests.torch_helpers import REPO, run_script

RNG = np.random.default_rng(11)


def _png(samples, ctype, depth, plte=None, trns=None, interlace=0):
    """A PNG written sample by sample (any color type and bit depth, row
    filter 0), for the kinds Pillow does not write."""
    h, w = samples.shape[:2]
    flat = samples.reshape(h, -1)
    if depth == 16:
        rows = flat.astype(">u2").view(np.uint8).reshape(h, -1)
    else:
        rows = flat.astype(np.uint8)

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        out += chunk(b"PLTE", bytes(plte))
    if trns is not None:
        out += chunk(b"tRNS", bytes(trns))
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _pillow_png(arr, mode=None, **save):
    buf = io.BytesIO()
    img = PIL.Image.fromarray(arr, mode) if mode else PIL.Image.fromarray(arr)
    if mode == "P":
        img.putpalette(RNG.integers(0, 256, 768).astype(np.uint8).tolist())
    img.save(buf, format="PNG", **save)
    return buf.getvalue()


def _kinds():
    idx = RNG.integers(0, 40, (9, 13)).astype(np.uint8)
    return {
        "palette": _pillow_png(idx, "P"),
        "palette_trns": _pillow_png(idx, "P", transparency=bytes(
            RNG.integers(0, 256, 40).astype(np.uint8))),
        "gray16": _pillow_png(RNG.integers(0, 65536, (9, 13)).astype(
            np.uint16)),
        "rgba16": _png(RNG.integers(0, 65536, (9, 13, 4)), 6, 16),
        "gray": _pillow_png(RNG.integers(0, 256, (9, 13)).astype(np.uint8)),
        "gray_alpha": _pillow_png(RNG.integers(0, 256, (9, 13, 2)).astype(
            np.uint8), "LA"),
        "rgba": _pillow_png(RNG.integers(0, 256, (9, 13, 4)).astype(
            np.uint8)),
    }


KINDS = _kinds()


def _no_pillow(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


# ---------------------------------------------------------------------------
# Image files as Pillow reads them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", None])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_read_image_without_pillow_equals_pillow(kind, mode, monkeypatch):
    with PIL.Image.open(io.BytesIO(KINDS[kind])) as img:
        want = np.asarray(img if mode is None else img.convert(mode))
    assert np.array_equal(read_image(KINDS[kind], mode), want)
    _no_pillow(monkeypatch)
    got = read_image(KINDS[kind], mode)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_what_only_pillow_reads_raises_without_it(tmp_path, monkeypatch):
    jpeg = str(tmp_path / "a.jpg")
    PIL.Image.fromarray(RNG.integers(0, 256, (8, 8, 3)).astype(
        np.uint8)).save(jpeg)
    assert read_image(jpeg).shape == (8, 8, 3)
    interlaced = _png(np.zeros((4, 4), np.uint8), 0, 8, interlace=1)
    _no_pillow(monkeypatch)
    for src in (jpeg, interlaced):
        with pytest.raises(ValueError, match="Pillow"):
            read_image(src)
    with pytest.raises(ValueError, match="Pillow"):
        read_png(interlaced)


# ---------------------------------------------------------------------------
# The six CLIs against the JAX scripts
# ---------------------------------------------------------------------------

def _pixels(path):
    with PIL.Image.open(path) as img:
        return img.mode, np.asarray(img)


def _folder(path):
    return {n: _pixels(os.path.join(path, n))
            for n in sorted(os.listdir(path))}


def _zip(path):
    with zipfile.ZipFile(path) as zf:
        out = {}
        for n in zf.namelist():
            with PIL.Image.open(io.BytesIO(zf.read(n))) as img:
                out[n] = img.mode, np.asarray(img)
        return out


def _assert_same(got, want):
    assert list(got) == list(want)
    for n in want:
        assert got[n][0] == want[n][0], n
        assert np.array_equal(got[n][1], want[n][1]), n


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The inputs, and every JAX script's output on them."""
    root = tmp_path_factory.mktemp("chain")
    media = root / "media"
    media.mkdir()
    for i, (h, w) in enumerate(((48, 48), (40, 46), (48, 36), (44, 48))):
        ramp = np.linspace(0, 255, w)[None, :, None]
        img = np.clip(RNG.normal(120, 40, (h, w, 3)) + ramp * (i % 2), 0,
                      255).astype(np.uint8)
        PIL.Image.fromarray(img).save(media / f"m{i}.png")
    # A palette PNG and a gray PNG, which Pillow and the port's reader
    # read; the JPEG only Pillow reads.
    PIL.Image.fromarray(RNG.integers(0, 64, (40, 44)).astype(np.uint8),
                        "P").save(media / "m4_palette.png")
    PIL.Image.fromarray(RNG.integers(0, 256, (44, 40)).astype(
        np.uint8)).save(media / "m5_gray.png")
    pngs = root / "pngs"
    pngs.mkdir()
    for n in sorted(os.listdir(media)):
        os.link(media / n, pngs / n)
    PIL.Image.fromarray(RNG.integers(0, 256, (40, 40, 3)).astype(
        np.uint8)).save(media / "m6.jpg")
    j = root / "jax"
    run_script("create_splines", ["--output_dir", j / "splines",
                                  "--num_images", 5, "--width", 40,
                                  "--seed", 3, "--workers", 1])
    # The splines and one RGBA stroke, whose alpha prep_geom_data reads.
    strokes = root / "strokes"
    strokes.mkdir()
    for n in os.listdir(j / "splines"):
        os.link(j / "splines" / n, strokes / n)
    alpha = (255 * (RNG.random((40, 40)) > 0.7)).astype(np.uint8)
    PIL.Image.fromarray(np.dstack([np.zeros((40, 40, 3), np.uint8), alpha])
                        ).save(strokes / "z_rgba.png")
    run_script("prep_geom_data", ["--input_dir", strokes,
                                  "--output_dir", j / "triband"])
    run_script("dataset_tool", ["--source", media, "--dest",
                                j / "style.zip", "--resolution", 32])
    run_script("dataset_tool", ["--source", j / "triband", "--dest",
                                j / "geom.zip", "--resolution", 40])
    run_script("patch_augment", PATCH_ARGS + ["--input_dir", media,
                                              "--output_zip",
                                              j / "patches.zip"])
    run_script("reformat_triband_data_main", [
        "--input_dir", j / "triband", "--output_dir", j / "reformat",
        "--channel_order", "2,0,1"])
    run_script("make_synthetic_styles", ["--output_dir", j / "styles",
                                         "--num_images", 3,
                                         "--resolution", 24, "--seed", 5])
    return root


PATCH_ARGS = ["--patch_width", 16, "--patches_per_image", 6,
              "--scale_max", 2.5, "--min_entropy", 4.6, "--seed", 2]


def _port_runs(chain, out, pillow):
    """Every port CLI on the chain's inputs into ``out``; ``pillow`` False
    reads only the PNG inputs (no JPEG)."""
    j = chain / "jax"
    media = chain / ("media" if pillow else "pngs")
    workers = 2 if pillow else 1
    runs = [
        (create_splines, ["--output_dir", out / "splines", "--num_images", 5,
                          "--width", 40, "--seed", 3, "--workers", workers]),
        (prep_geom_data, ["--input_dir", chain / "strokes", "--output_dir",
                          out / "triband"]),
        (dataset_tool, ["--source", media, "--dest", out / "style.zip",
                        "--resolution", 32]),
        (dataset_tool, ["--source", j / "triband", "--dest",
                        out / "geom.zip", "--resolution", 40]),
        (patch_augment, PATCH_ARGS + ["--input_dir", media, "--output_zip",
                                      out / "patches.zip"]),
        (reformat_triband_data_main, [
            "--input_dir", j / "triband", "--output_dir", out / "reformat",
            "--channel_order", "2,0,1"]),
        (make_synthetic_styles, ["--output_dir", out / "styles",
                                 "--num_images", 3, "--resolution", 24,
                                 "--seed", 5]),
    ]
    for cli, argv in runs:
        cli.main([str(a) for a in argv])


@pytest.fixture(scope="module")
def port_out(chain):
    out = chain / "port"
    _port_runs(chain, out, pillow=True)
    return out


@pytest.fixture(scope="module")
def port_out_no_pillow(chain):
    out = chain / "port_no_pillow"
    with pytest.MonkeyPatch.context() as mp:
        _no_pillow(mp)
        _port_runs(chain, out, pillow=False)
    return out


FOLDERS = ["splines", "triband", "reformat", "styles"]
ZIPS = ["style.zip", "geom.zip", "patches.zip"]


@pytest.mark.parametrize("name", FOLDERS + ZIPS)
def test_cli_output_equals_the_jax_script_s(chain, port_out, name):
    read = _zip if name.endswith(".zip") else _folder
    want = read(chain / "jax" / name)
    assert len(want) >= 3
    _assert_same(read(port_out / name), want)


@pytest.mark.parametrize("name", FOLDERS + ZIPS)
def test_cli_output_without_pillow_is_the_same(chain, port_out,
                                               port_out_no_pillow, name):
    read = _zip if name.endswith(".zip") else _folder
    want = read(port_out / name)
    if name in ("style.zip", "patches.zip"):
        # Without Pillow the JPEG is not among the inputs.
        want = _without_jpeg(name, want)
    _assert_same(read(port_out_no_pillow / name), want)


def _without_jpeg(name, want):
    """The with-Pillow output minus what came of the JPEG (the last input
    in sorted order): style.zip numbers members in input order, so the
    JPEG's member is the last; patch members carry the input's name."""
    if name == "style.zip":
        return dict(list(want.items())[:-1])
    return {n: v for n, v in want.items() if not n.startswith("m6_")}


def test_chain_contents(chain, port_out):
    style, geom = _zip(port_out / "style.zip"), _zip(port_out / "geom.zip")
    assert list(style) == [f"{i:08d}.png" for i in range(7)]
    for mode, img in style.values():
        assert mode == "RGB" and img.shape == (32, 32, 3)
    assert len(geom) == 6
    for mode, img in geom.values():
        assert mode == "RGB" and img.shape == (40, 40, 3)
        assert set(np.unique(img[..., 1])) <= {0, 255}
    patches = _zip(port_out / "patches.zip")
    assert 0 < len(patches) < 7 * 6
    for _, img in patches.values():
        assert patch_entropy(img.astype(np.float32).mean(-1) / 255.0) >= 4.6
    names = sorted(os.listdir(port_out / "splines"))
    assert all(re.fullmatch(r"spline_\d{6}_rad\d{3}\.png", n) for n in names)


def test_reformat_refuses_a_bad_channel_order(tmp_path):
    with pytest.raises(SystemExit):
        reformat_triband_data_main.main([
            "--input_dir", str(tmp_path), "--output_dir", str(tmp_path),
            "--channel_order", "0,1,3"])


@pytest.mark.parametrize("name,channels", [("style.zip", 3),
                                           ("geom.zip", 3),
                                           ("style.zip", 1)])
def test_image_folder_reads_the_port_zips_as_jax_reads_its_own(
        chain, port_out, name, channels):
    want = jds.ImageFolderDataset(str(chain / "jax" / name), 24,
                                  channels=channels, seed=4)
    got = tds.ImageFolderDataset(str(port_out / name), 24,
                                 channels=channels, seed=4)
    assert len(got) == len(want)
    for i in range(len(want)):
        assert np.array_equal(got[i], want[i]), i


# ---------------------------------------------------------------------------
# The projection CLI's reader (the JPEG and palette targets)
# ---------------------------------------------------------------------------

def _jax_project_main():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_script_project_main", os.path.join(REPO, "scripts",
                                             "project_main.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("target", ["m6.jpg", "m4_palette.png",
                                    "m5_gray.png"])
def test_project_main_reads_targets_as_the_jax_cli(chain, target):
    path = str(chain / "media" / target)
    want = _jax_project_main().load_target_patches(path, 16, 3, 7)
    got = project_main.load_target_patches(path, 16, 3, 7)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# ---------------------------------------------------------------------------
# The port's shell entry points
# ---------------------------------------------------------------------------

SHELL = ["neube_train_torch.sh", "neube_run_torch.sh",
         "neube_stylize_torch.sh", "scripts/run_r5_flagship_torch.sh"]


@pytest.mark.parametrize("script", SHELL)
def test_shell_entry_point_parses_and_names_port_modules(script):
    import importlib
    path = os.path.join(REPO, script)
    assert os.access(path, os.X_OK)
    res = subprocess.run(["bash", "-n", path], capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr
    with open(path) as f:
        mods = re.findall(r"python -m (\S+)", f.read())
    assert mods and all(m.startswith("brushstroke_engine_torch.")
                        for m in mods)
    for m in mods:
        importlib.import_module(m)


@pytest.mark.parametrize("mode", ["train", "finetune"])
def test_neube_train_torch_flag_bundle_parses(mode, tmp_path):
    res = subprocess.run(
        ["bash", os.path.join(REPO, "neube_train_torch.sh"), mode,
         str(tmp_path / "style.zip"), str(tmp_path / "geom.zip"),
         str(tmp_path / "out"), "--dry-run", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "Resolved training options:" in res.stdout
    assert '"batch": "64"' in res.stdout
    assert ('"exit_after_warmstart": "True"' in res.stdout) == \
        (mode == "finetune")
