"""The round-5 tools of the port against the JAX scripts, on the CPU, strict
f32, and the image I/O repairs.

* ``tools/visualize_main.py`` modes 0 (brush icons) and 1 (diagnostic
  grids) and ``tools/diagnose_color_control.py`` on a bundle the JAX package
  wrote: every image within 1 LSB of the JAX script's (uint8 renders of the
  same weights, f32 sums in other orders), ``report.json`` within 1e-4 plus
  the rounding step of each field (the script rounds masses to 1e-4,
  colours to 1e-3, LAB_E% to 1e-2);
* ``tools/plot_colors.py``: the sampled colours and counts of the JAX
  script's draw, read with and without Pillow;
* ``tools/fetch_and_verify_weights.py`` on seeded files of every family:
  the manifest (the JAX package's digests and file format), ``--expect``
  failing before anything is installed, URLs refused;
* ``tools/drive_brush_server.py`` against the port's server on the CPU;
* the two new shell entry points parse and name the port's modules and
  flags;
* ``tools/paint_image.py`` and the icon cache read through
  ``utils/img_proc.read_image``.
"""

import hashlib
import importlib
import json
import os
import re
import shlex
import socket
import string
import subprocess
import sys

import numpy as np
import pytest
import torch

from brushstroke_engine_tpu.utils import weights as jweights
from brushstroke_engine_tpu.utils.checkpoint import EngineBundle, save_native
from brushstroke_engine_torch.tools import (
    diagnose_color_control, drive_brush_server, fetch_and_verify_weights,
    plot_colors, visualize_main,
)
from brushstroke_engine_torch.utils import img_proc
from brushstroke_engine_torch.utils import reference_layout as rl
from brushstroke_engine_torch.utils import weights as tweights
from tests.torch_helpers import REPO, run_script, small_model


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A native bundle written by the JAX package (both packages read it)."""
    m = small_model(seed=5)
    jgen, jenc = m["jax_cfg"]
    path = str(tmp_path_factory.mktemp("bundle") / "run" / "snap" /
               "network-snapshot-000000.pkl")
    os.makedirs(os.path.dirname(path))
    save_native(path, EngineBundle(
        gen_cfg=jgen, gen_params=m["jax"]["gen_params"],
        gen_state=m["jax"]["gen_state"], enc_cfg=jenc,
        enc_params=m["jax"]["enc_params"],
        enc_state=m["jax"]["enc_state"], color_format="triad",
        geom_inject_resolutions=(0, 1)))
    return path


@pytest.fixture(autouse=True)
def _strict():
    from brushstroke_engine_torch.ops.precision import set_precision_mode
    set_precision_mode("strict")
    yield


def _images(d):
    return {f: img_proc.read_image(os.path.join(d, f), None)
            for f in sorted(os.listdir(d)) if f.endswith(".png")}


def _lsb_close(got, want, label):
    assert got.shape == want.shape, label
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, (label, int(diff.max()))


@pytest.mark.parametrize("mode", [0, 1])
def test_visualize_main_equals_the_jax_script(bundle, tmp_path, mode):
    argv = ["--gan_checkpoint", bundle, "--library", "rand3", "--mode",
            str(mode)]
    run_script("visualize_main",
               argv + ["--output_dir", str(tmp_path / "jax")])
    ids = visualize_main.main(argv + ["--output_dir", str(tmp_path / "t"),
                                      "--device", "cpu"])
    got, want = _images(tmp_path / "t"), _images(tmp_path / "jax")
    prefix = "grid_" if mode else ""
    assert sorted(got) == sorted(want) == sorted(
        f"{prefix}{i}.png" for i in ids) and len(ids) == 3
    for name in want:
        _lsb_close(got[name], want[name], name)
        assert got[name].dtype == np.uint8 and got[name].ndim == 3


def test_diagnose_color_control_equals_the_jax_script(bundle, tmp_path):
    run_script("diagnose_color_control",
               [bundle, "--out", str(tmp_path / "jax")])
    raw = {}
    reports = diagnose_color_control.main(
        [bundle, "--out", str(tmp_path / "t"), "--device", "cpu"])
    diagnose_color_control.diagnose(bundle, str(tmp_path / "raw"),
                                    device="cpu", raw=raw)
    with open(tmp_path / "jax" / "report.json") as f:
        want = json.load(f)
    with open(tmp_path / "t" / "report.json") as f:
        got = json.load(f)
    assert got == reports and len(got) == len(want) == 1
    got, want = got[0], want[0]
    assert set(got) == set(want) and got["snapshot"] == want["snapshot"]
    for key, step in (("fg_mass_uvs", 1e-4), ("bg_mass_uvs", 1e-4),
                      ("mean_learned_colors_rgb_per_channel", 1e-3),
                      ("lab_e_primary_only", 1e-2),
                      ("lab_e_primary_and_secondary", 1e-2)):
        np.testing.assert_allclose(np.asarray(got[key]),
                                   np.asarray(want[key]), rtol=1e-4,
                                   atol=1e-4 + step, err_msg=key)
    # Softmax masses: each set sums to 1; LAB_E% finite.
    for key in ("fg_mass_uvs", "bg_mass_uvs"):
        assert abs(float(np.sum(raw[key])) - 1.0) <= 1e-5
    assert np.isfinite(raw["lab_e_primary_only"]).all()
    got_img, want_img = _images(tmp_path / "t"), _images(tmp_path / "jax")
    assert sorted(got_img) == sorted(want_img) == [
        "override_ab_run_network-snapshot-000000.png",
        "uvs_run_network-snapshot-000000.png"]
    for name in want_img:
        _lsb_close(got_img[name], want_img[name], name)


def _jax_plot_colors_draw(img, samples, seed):
    """The JAX script's draw (scripts/plot_colors.py:36-41)."""
    flat = img.reshape(-1, 3)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, flat.shape[0], samples)
    uniq, counts = np.unique(idx, return_counts=True)
    return flat[uniq].astype(np.float32) / 255.0, counts


def test_plot_colors_draws_as_the_jax_script(tmp_path, monkeypatch):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (24, 20, 3)).astype(np.uint8)
    path = str(tmp_path / "img.png")
    img_proc.write_png(path, img)
    want = _jax_plot_colors_draw(img, 300, 4)
    got = plot_colors.sample_colors(img_proc.read_image(path, "RGB"), 300, 4)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].sum() == 300
    out = plot_colors.main(["--image", path, "--samples", "300", "--seed",
                            "4"])
    assert out == str(tmp_path / "img.colors.png") and os.path.getsize(out)
    # Pillow hidden: the PNG is read by the port's own decoder, the same.
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    again = plot_colors.sample_colors(img_proc.read_image(path, "RGB"), 300,
                                      4)
    np.testing.assert_array_equal(again[0], want[0])


SMALL_CLIP = dict(embed_dim=32, image_resolution=224, vision_patch=32,
                  vision_width=64, vision_layers=1, text_width=64,
                  text_layers=1, context_length=77, vocab_size=49408)


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """Seeded files of every family in their published layouts (the VGG16
    and CLIP widths cut down)."""
    d = tmp_path_factory.mktemp("weights_src")
    files = {"inception": d / "inception.pt", "lpips": d / "lpips.pth",
             "vgg16": d / "vgg16.pth", "clip": d / "clip.pt",
             "clip_bpe": d / "bpe.txt.gz"}
    torch.save(rl.inception_state_dict(0), files["inception"])
    torch.save(rl.lpips_state_dict(0), files["lpips"])
    torch.save(rl.vgg16_state_dict(0, width_div=16, fc=64), files["vgg16"])
    torch.save(rl.clip_state_dict(0, SMALL_CLIP), files["clip"])
    rl.write_bpe_merges(str(files["clip_bpe"]), rl.bpe_merges_for(
        ["a", "painted", "brush", "stroke"]))
    return {k: str(v) for k, v in files.items()}


def test_installer_manifest_and_kinds(weight_files, bundle, tmp_path,
                                      monkeypatch, capsys):
    from brushstroke_engine_torch.metrics import fid, lpips
    wdir = tmp_path / "weights"
    monkeypatch.setenv("NEUBE_WEIGHTS_DIR", str(wdir))
    monkeypatch.setattr(fid, "_DEFAULTS", {})
    monkeypatch.setattr(lpips, "_DEFAULT_MODELS", {})
    argv = [a for fam, p in weight_files.items() for a in (f"--{fam}", p)]
    assert fetch_and_verify_weights.main(
        argv + ["--reference_pkl", bundle, "--device", "cpu"]) == 0
    said = capsys.readouterr().out
    assert "[reference_pkl] VERIFIED res=32 color_format=triad" in said
    for probe in ("fid: random -> inception_v3",
                  "lpips: lpips_random -> lpips_alex",
                  "clip: HashingBackbone -> CLIPBackbone"):
        assert probe in said, probe
    with open(wdir / "manifest.json") as f:
        text = f.read()
    manifest = json.loads(text)
    assert set(manifest) == set(weight_files)
    for fam, path in weight_files.items():
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        entry = manifest[fam]
        assert entry["sha256"] == digest == jweights.sha256_file(path)
        assert entry["file"] == tweights.CANONICAL[fam][0]
        with open(wdir / entry["file"], "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == digest
    # The manifest file is the JAX package's format (merged, sorted keys).
    monkeypatch.setenv("NEUBE_WEIGHTS_DIR", str(tmp_path / "jax"))
    jweights.write_manifest(manifest)
    with open(tmp_path / "jax" / "manifest.json") as f:
        assert f.read() == text
    monkeypatch.setenv("NEUBE_WEIGHTS_DIR", str(wdir))
    tweights.write_manifest({"extra": {"sha256": "0"}})
    assert set(tweights.read_manifest()) == set(weight_files) | {"extra"}


def test_installer_refuses_a_mismatch_and_urls(weight_files, tmp_path,
                                               monkeypatch, capsys):
    wdir = tmp_path / "weights"
    monkeypatch.setenv("NEUBE_WEIGHTS_DIR", str(wdir))
    rc = fetch_and_verify_weights.main([
        "--lpips", weight_files["lpips"], "--clip_bpe",
        weight_files["clip_bpe"], "--expect", "lpips=" + "0" * 64,
        "--device", "cpu"])
    assert rc == 1 and not wdir.exists()
    said = capsys.readouterr().out
    assert "sha256 mismatch" in said and "NOT installing" in said
    for url in ("https://example.invalid/lpips.pth", "file:///tmp/x.pt"):
        with pytest.raises(SystemExit, match="fetches nothing"):
            fetch_and_verify_weights.main(["--lpips", url, "--device",
                                           "cpu"])
    with pytest.raises(SystemExit):
        fetch_and_verify_weights.main(["--device", "cpu"])
    # A file naming a foreign callable is refused by the loader.
    bad = tmp_path / "bad.pth"
    torch.save({"x": torch.zeros(1), "f": os.getcwd}, bad)
    assert fetch_and_verify_weights.main(
        ["--lpips", str(bad), "--device", "cpu"]) == 1
    assert "Weights only load failed" in capsys.readouterr().out


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_drive_brush_server_against_the_port_server(bundle, tmp_path):
    """One run on the CPU: the real server process with two seed
    libraries; the report has both, six strokes each, and each icon is a
    JPEG."""
    snap = bundle
    for name, seeds in (("a", "3\n7\n"), ("b", "11\n")):
        (tmp_path / f"{name}.txt").write_text(seeds)
    libs = f"Seeds:disp:{tmp_path / 'a.txt'},More:disp:{tmp_path / 'b.txt'}"
    out = tmp_path / "served"
    report = drive_brush_server.main([
        "--gan_checkpoint", snap, "--libraries", libs, "--out_dir", str(out),
        "--port", str(_free_port()), "--no_warmup", "--device", "cpu",
        "--startup_timeout", "120"])
    with open(out / "report.json") as f:
        assert json.load(f) == report
    assert report["patch_width"] == 32
    assert set(report["libraries"]) == {"Seeds", "More"}
    for lib, style in (("Seeds", "3"), ("More", "11")):
        row = report["libraries"][lib]
        assert row["style_id"] == style and row["n_strokes"] == 6
        assert row["icon_bytes"] > 0 and "icon_error" not in row
        with open(out / f"icon_{lib}.jpg", "rb") as f:
            assert f.read(3) == b"\xff\xd8\xff"
        sheet = img_proc.read_image(str(out / f"strokes_{lib}.png"), "RGB")
        assert sheet.shape == (256, 256, 3) and sheet.min() < 255


def _commands(script):
    """Each ``python -m <module> ...`` of a shell script: (module, argv),
    continuation lines joined, shell variables left as written."""
    with open(os.path.join(REPO, script)) as f:
        text = f.read().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        mm = re.search(r"python -m (\S+)(.*)$", line)
        if mm:
            out.append((mm.group(1), shlex.split(mm.group(2))))
    return out


@pytest.mark.parametrize("script", ["scripts/run_r5_finetune_torch.sh",
                                    "scripts/run_r5_brush_workflow_torch.sh",
                                    "scripts/run_r5_flagship_torch.sh"])
def test_shell_entry_points_parse_and_name_port_modules(script):
    res = subprocess.run(["bash", "-n", os.path.join(REPO, script)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    cmds = _commands(script)
    assert cmds
    for module, argv in cmds:
        assert module.startswith("brushstroke_engine_torch.tools."), module
        mod = importlib.import_module(module)
        src = open(mod.__file__).read()
        for flag in (a for a in argv if a.startswith("--")):
            assert f'"{flag}"' in src, (module, flag)
    if "finetune" in script or "flagship" in script:
        from brushstroke_engine_torch.tools import train
        module, argv = cmds[-1]
        subs = {"D": "d", "SNAP": "s.pkl", "VARIANT": "color",
                "KIMG": "200", "LOSSES": "1.0*iou(u)"}
        argv = [string.Template(a).substitute(subs) for a in argv]
        args = train.build_parser().parse_args(argv)
        assert (args.fused, args.device_dataset,
                args.steps_per_dispatch) == (True, True, 16)


def test_paint_image_reads_a_png_without_pillow(bundle, tmp_path,
                                                monkeypatch):
    """The drawing through ``read_image``: with Pillow hidden the PNG is
    decoded by the port and the canvas written by ``write_png``, equal to
    the run with Pillow."""
    from brushstroke_engine_torch.tools import paint_image
    rng = np.random.RandomState(2)
    drawing = np.where(rng.rand(40, 40) > 0.7, 0, 255).astype(np.uint8)
    path = str(tmp_path / "drawing.png")
    img_proc.write_png(path, drawing)
    argv = ["--gan_checkpoint", bundle, "--geo_image", path,
            "--overlap_margin", "4", "--crop_margin", "4", "--precision",
            "strict", "--device", "cpu"]
    with_pil = paint_image.main(argv + ["--output_dir", str(tmp_path / "a")])
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    without = paint_image.main(argv + ["--output_dir", str(tmp_path / "b")])
    monkeypatch.undo()
    a = img_proc.read_image(with_pil, None)
    b = img_proc.read_image(without, None)
    assert a.shape == b.shape and a.shape[-1] == 4
    np.testing.assert_array_equal(a, b)


def test_icon_cache_reads_through_read_image(tmp_path, monkeypatch):
    import PIL.Image
    from brushstroke_engine_torch.engine import library as tlib
    icon = np.random.RandomState(0).randint(0, 256, (16, 16, 3)).astype(
        np.uint8)
    store = tlib.IconStore(str(tmp_path / "icons.zip"))
    store.put("7", icon)
    with store._zip.open("7.jpg") as f:
        want = np.array(PIL.Image.open(f))
    calls = []
    real = img_proc.read_image
    monkeypatch.setattr(img_proc, "read_image",
                        lambda src, mode="RGB": calls.append(mode) or
                        real(src, mode))
    got = store.get("7")
    assert calls == [None]
    np.testing.assert_array_equal(got, want)
    assert store.get("8") is None
    store.close()
