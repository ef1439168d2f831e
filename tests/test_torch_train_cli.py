"""The port's training CLI (``brushstroke_engine_torch.tools.train``) against
``scripts/train_main.py`` on the CPU: the flags and their defaults, the
configs of ``train_flags.txt`` and of the clarity finetune (with the
recorded ``--d_arch`` fault of the JAX CLI pinned), ``--dry-run``, a tiny run
that writes every file and resumes, the finetune's warm step, one Dmain and
Gmain step in bf16, and the visualizer's sheets.

Small shapes: 32 px, B = 4, <= 32 channels.  Tolerances:
  * configs, flags and the PNG writer: exact;
  * the visualizer's uint8 sheets (from the same geometry): within 1 LSB,
    and 99.9 % of the values equal (the renders agree to ~1e-5; a value on
    a rounding edge moves one LSB);
  * the finetune warm step (LPIPS and L1 against the frozen original),
    strict f32: stats 1e-4 relative (+1e-5 abs), updates as in
    ``tests/test_torch_train_phases.py`` (mean |delta_port - delta_jax|
    under 2 % of the step, 99 % of the entries under 10 %);
  * Dmain and Gmain with the 16- and 32-px blocks in bf16
    (``num_bf16_res=2``): both packages round the same f32 values to bf16
    (8 significant bits, 2^-8 relative) at every block boundary and conv
    input, but sum in other orders, so the stats agree to 2e-2 relative
    (+1e-3 abs); the updates (~lr * sign(g) with beta1 = 0) flip sign where
    a gradient is within bf16 rounding of 0, so the mean
    |delta_port - delta_jax| stays under 20 % of the step and 90 % of the
    entries under 50 %.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import PIL.Image
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.engine import brush as jbrush
from brushstroke_engine_tpu.train import steps as jsteps
from brushstroke_engine_tpu.viz import visualize as jviz
from brushstroke_engine_torch.engine import brush as tbrush
from brushstroke_engine_torch.tools import train as ttrain
from brushstroke_engine_torch.train import steps as tsteps
from brushstroke_engine_torch.train.loop import TrainingLoop
from brushstroke_engine_torch.utils.checkpoint import (
    params_from_jax, train_state_from_jax,
)
from brushstroke_engine_torch.utils.img_proc import write_png
from brushstroke_engine_torch.viz import visualize as tviz
from tests.torch_helpers import small_model
from tests.torch_train_helpers import (  # noqa: F401 (_strict: autouse)
    _strict, RES, B, _np_tree, _flat, _train_cfgs, _jax_state, _batch,
    _assert_update_parity, _assert_stats,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small shapes: the suite runs several
    test processes on the machine's cores, and torch's default pool of one
    thread per core then oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "train_main_for_tests", os.path.join(REPO, "scripts", "train_main.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flags(*names):
    """The lines of the flag files that do not start with '#', as
    ``neube_train.sh`` reads them."""
    out = []
    for name in names:
        with open(os.path.join(REPO, name)) as f:
            out += [ln.strip() for ln in f
                    if ln.strip() and not ln.startswith("#")]
    return out


TRAIN = ("train_flags.txt",)
FINETUNE = ("train_flags.txt", "finetune_flags.txt")


def test_parser_has_every_flag_of_the_jax_cli():
    jp, tp = _jax_cli().build_parser(), ttrain.build_parser()
    want = {a.dest: a.default for a in jp._actions if a.dest != "help"}
    got = {a.dest: a.default for a in tp._actions if a.dest != "help"}
    assert set(got) - set(want) == {"device"} and got["device"] == "cuda"
    assert set(want) <= set(got)
    for dest, default in want.items():
        assert got[dest] == default, dest
    jopts = {s for a in jp._actions for s in a.option_strings}
    topts = {s for a in tp._actions for s in a.option_strings}
    assert topts - jopts == {"--device"} and jopts <= topts


@pytest.mark.parametrize("files", [TRAIN, FINETUNE])
@pytest.mark.parametrize("d_arch", ["orig", "resnet"])
def test_setup_config_equals_jax(files, d_arch):
    argv = _flags(*files) + ["--outdir", "unused", f"--d_arch={d_arch}"]
    jmod = _jax_cli()
    jcfg, jenc, *_ = jmod.setup_config(jmod.build_parser().parse_args(argv))
    tcfg, tenc, enc_params, _ = ttrain.setup_config(
        ttrain.build_parser().parse_args(argv))
    assert dataclasses.asdict(tenc) == dataclasses.asdict(jenc)
    want, got = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    # The JAX CLI builds a resnet D whatever --d_arch says
    # (scripts/train_main.py:205, ROADMAP.md section 3); the port builds
    # the one the flag names.
    assert want["disc_cfg"].pop("architecture") == "resnet"
    assert got["disc_cfg"].pop("architecture") == d_arch
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k
    assert tcfg.gen_cfg.synthesis.num_bf16_res == 4
    if files == FINETUNE:
        assert tcfg.geom_warmstart_losses == \
            "0.5*iou_inv(uvs)+0.5*lpips(fake_orig)+0.5*l1(fake_orig)"
        assert tcfg.losses("warmstart").require_original_fake_image()
    assert set(enc_params) == {"encoder", "decoder"}


@pytest.mark.parametrize("flag", [
    "--fused", "--dp=2", "--device_dataset", "--steps_per_dispatch=4",
    "--profile_dir=x", "--coordinator_address=h:1", "--num_processes=2",
    "--process_id=0"])
def test_unported_flags_raise(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttrain.main(["--outdir", str(tmp_path), "--device", "cpu",
                     "--dry-run", flag])


def test_dry_run_and_cuda(tmp_path, capsys, monkeypatch):
    out = str(tmp_path / "runs")
    assert ttrain.main(["--outdir", out, "--device", "cpu", "--dry-run"]) \
        is None
    said = capsys.readouterr().out
    assert "Would create run dir" in said and "00000-triad-res128-batch64" \
        in said
    assert os.listdir(out) == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--outdir", out, "--dry-run"])


TINY = ["--device", "cpu", "--output_resolution", "32", "--batch", "4",
        "--channel_max", "32", "--kimg", "0", "--snap", "1",
        "--image_snap", "1", "--geom_warmstart_kimg", "0"]


def test_tiny_cli_run_writes_every_file_and_resumes(tmp_path):
    """One batch of every phase at 32 px with the canonical flags (bf16 at
    every block from 8 px, ``--num_bf16_res`` 4), the eval hooks at their
    default ``fid,forger``; then the finetune resumed from its snapshot."""
    out = str(tmp_path / "runs")
    loop = ttrain.main(["--outdir", out] + _flags(*TRAIN) + TINY)
    run = loop.run_dir
    assert os.path.basename(run) == "00000-triad-res32-batch4"
    files = set(os.listdir(run))
    assert {"training_options.json", "stats.jsonl", "train_state.pkl",
            "network-snapshot-000000.pkl", "summary_metrics.txt"} <= files
    assert sorted(os.listdir(os.path.join(run, "viz"))) == [
        "color_control_000000.png", "fakes_000000.png",
        "geom_control_000000.png"]
    with open(os.path.join(run, "training_options.json")) as f:
        assert json.load(f)["num_bf16_res"] == 4
    with open(os.path.join(run, "stats.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    assert len(rows) == 1 and all(np.isfinite(v) for v in rows[0].values())
    for k in ("Loss/D/loss", "Loss/D/reg", "Loss/G/loss", "Loss/G/reg",
              "Loss/forger/Ggeom/total"):
        assert k in rows[0], k
    assert loop.hook_failure_counts == {}
    with open(os.path.join(run, "summary_metrics.txt")) as f:
        head, line = f.read().splitlines()
    assert head.split() == ["STEP", "BG_CLARITY_MEAN", "FG_OPACITY_MEDIAN",
                            "LAB_E%", "LAB_L2", "LPIPS_ACROSS_GEO",
                            "LPIPS_UNIFORM_BG",
                            "LPIPS_UNIFORM_BG_multicolor"]
    assert all(np.isfinite(float(v)) for v in line.split())
    img = np.asarray(PIL.Image.open(os.path.join(run, "viz",
                                                 "fakes_000000.png")))
    assert img.shape == (5 * 32, 5 * 32, 3) and img.dtype == np.uint8

    snap = os.path.join(run, "network-snapshot-000000.pkl")
    ft = ttrain.main(["--outdir", out] + _flags(*FINETUNE) + TINY + [
        "--resume", snap, "--geom_warmstart_kimg", "0.004", "--metrics", ""])
    assert os.path.basename(ft.run_dir).startswith("00001-")
    assert ft.g_orig_params is not None and ft.batch_idx == 1
    for a, b in zip(_flat(ft.g_orig_params).values(),
                    _flat(loop.state["g_ema"]).values()):
        np.testing.assert_array_equal(a, b)
    with open(os.path.join(ft.run_dir, "stats.jsonl")) as f:
        row = json.loads(f.readline())
    assert row["Loss/forger/Ggeom-warm/lpips_fake_orig"] > 0
    assert "network-snapshot-000000.pkl" in os.listdir(ft.run_dir)


def test_build_returns_an_unrun_loop_that_profiles_its_phases(tmp_path):
    """``build`` stops before ``run``; with ``profile_phases`` set the loop
    keeps each phase call's seconds, one per call on the schedule."""
    loop, args = ttrain.build(["--outdir", str(tmp_path)] + _flags(*TRAIN)
                              + TINY + ["--metrics", ""])
    run = loop.run_dir
    files = os.listdir(run)
    assert "training_options.json" in files and "stats.jsonl" not in files
    assert loop.batch_idx == 0 and loop.phase_seconds == {}
    assert not args.exit_after_warmstart
    loop.profile_phases = True
    loop.run(exit_after_warmstart=args.exit_after_warmstart)
    # Batch 0 runs every phase once; the ADA update waits for batch > 0.
    assert {k: len(v) for k, v in loop.phase_seconds.items()} == {
        "Dmain": 1, "Dreg": 1, "Gmain": 1, "Greg": 1, "Ggeom": 1}
    with open(os.path.join(run, "stats.jsonl")) as f:
        row = json.loads(f.readline())
    for phase, secs in loop.phase_seconds.items():
        assert row[f"Timing/{phase}"] == secs[0] > 0


def test_finetune_warm_step_matches_jax():
    """Ggeom-warm with finetune_flags.txt's loss string (LPIPS and L1
    against the frozen original generator)."""
    losses = "0.5*iou_inv(uvs)+0.5*lpips(fake_orig)+0.5*l1(fake_orig)"
    m, jcfg, tcfg = _train_cfgs(geom_warmstart_losses=losses,
                                geom_warmstart_mode="last_and_rgb")
    real, geom, truth, zs = _batch(9)
    jst = _jax_state(m, jcfg)
    g_orig_np = jax.tree_util.tree_map(
        lambda a: np.array(a) * np.float32(1.02), m["np"]["gen_params"])
    jfeats = jsteps.encode_geometry(jcfg, m["jax"]["enc_params"],
                                    m["jax"]["enc_state"], jnp.asarray(geom))
    tfeats = tsteps.encode_geometry(tcfg, m["torch"]["enc_params"],
                                    m["torch"]["enc_state"],
                                    torch.from_numpy(geom))
    tst = train_state_from_jax(_np_tree(jst), device="cpu")
    before = _np_tree(jst["g_params"])
    tst2, ts = tsteps.make_geom_step(tcfg, warmstart=True)(
        tst, tfeats, torch.from_numpy(truth), torch.from_numpy(zs[0]),
        ema_beta=0.9, g_orig_params=params_from_jax(g_orig_np))
    jst, js = jsteps.make_geom_step(jcfg, warmstart=True)(
        jst, jfeats, jnp.asarray(truth), jnp.asarray(zs[0]),
        jax.random.PRNGKey(3), jnp.float32(0.9),
        g_orig_params=jax.tree_util.tree_map(jnp.asarray, g_orig_np))
    _assert_stats(ts, js, "Ggeom-warm")
    assert float(ts["Loss/forger/Ggeom-warm/lpips_fake_orig"]) > 0
    _assert_update_parity(params_from_jax(before), tst2["g_params"],
                          params_from_jax(_np_tree(jst["g_params"])), 2e-4,
                          "Ggeom-warm")


def test_finetune_keeps_the_original_as_the_jax_loop_does(tmp_path):
    """Both loops take a frozen original for the finetune's losses (the
    ported condition agrees with the JAX one) and not for the train flags'."""
    from brushstroke_engine_tpu.train.loop import TrainingLoop as JLoop
    for losses, want in (
            ("0.5*iou_inv(uvs)+0.5*lpips(fake_orig)+0.5*l1(fake_orig)",
             True), ("1.0*iou_inv(uvs)+1.0*iou(u)", False)):
        m, jcfg, tcfg = _train_cfgs(geom_warmstart_losses=losses,
                                    geom_warmstart_kimg=1)
        j = JLoop(jcfg, m["jax"]["enc_params"], m["jax"]["enc_state"], None,
                  None, run_dir=str(tmp_path / "j"),
                  resume_state=_jax_state(m, jcfg))
        t = TrainingLoop(tcfg, m["torch"]["enc_params"],
                         m["torch"]["enc_state"], None, None,
                         run_dir=str(tmp_path / "t"), device="cpu")
        assert (j.g_orig_params is not None) == want
        assert (t.g_orig_params is not None) == want


def _bf16_cfgs():
    m, jcfg, tcfg = _train_cfgs(disc={"num_bf16_res": 2})

    def bf16(cfg):
        g = cfg.gen_cfg
        return dataclasses.replace(cfg, gen_cfg=dataclasses.replace(
            g, synthesis=dataclasses.replace(g.synthesis, num_bf16_res=2)))
    return m, bf16(jcfg), bf16(tcfg)


def test_bf16_dmain_and_gmain_match_jax():
    m, jcfg, tcfg = _bf16_cfgs()
    syn = tcfg.gen_cfg.synthesis
    assert [syn.block_dtype(r) for r in syn.block_resolutions] == \
        [torch.float32, torch.float32, torch.bfloat16, torch.bfloat16]
    assert tcfg.disc_cfg.block_dtype(RES) == torch.bfloat16
    real, geom, truth, zs = _batch(10)
    jst = _jax_state(m, jcfg)
    jfeats = jsteps.encode_geometry(jcfg, m["jax"]["enc_params"],
                                    m["jax"]["enc_state"], jnp.asarray(geom))
    tfeats = tsteps.encode_geometry(tcfg, m["torch"]["enc_params"],
                                    m["torch"]["enc_state"],
                                    torch.from_numpy(geom))
    stat_tol = dict(rtol=2e-2, atol=1e-3)

    def close_stats(got, want, label):
        assert set(got) == set(want), label
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       err_msg=f"{label}:{k}", **stat_tol)
            assert np.isfinite(float(got[k])), (label, k)

    def close_updates(before, port_after, jax_after, lr, label):
        fb, fp, fj = _flat(before), _flat(port_after), _flat(jax_after)
        for k in sorted(fb):
            dp, dj = fp[k] - fb[k], fj[k] - fb[k]
            if not np.any(dj):
                assert not np.any(np.abs(dp) > 1e-12), (label, k)
                continue
            diff = np.abs(dp - dj)
            assert diff.mean() < 0.2 * lr, (label, k, diff.mean() / lr)
            assert np.mean(diff < 0.5 * lr) > 0.9, (label, k)

    tst = train_state_from_jax(_np_tree(jst), device="cpu")
    before = _np_tree(jst["d_params"])
    tst2, ts = tsteps.d_main_step(tcfg, tst, torch.from_numpy(real), tfeats,
                                  torch.from_numpy(zs[0]))
    jst2, js = jsteps.d_main_step(jcfg, jst, jnp.asarray(real), jfeats,
                                  jnp.asarray(zs[0]), jax.random.PRNGKey(1))
    close_stats(ts, js, "Dmain bf16")
    close_updates(params_from_jax(before), tst2["d_params"],
                  params_from_jax(_np_tree(jst2["d_params"])),
                  2e-4 * 16 / 17, "Dmain bf16")

    tst = train_state_from_jax(_np_tree(jst2), device="cpu")
    before = _np_tree(jst2["g_params"])
    tst3, ts = tsteps.g_main_step(tcfg, tst, tfeats, torch.from_numpy(truth),
                                  torch.from_numpy(zs[1]), ema_beta=0.5)
    jst3, js = jsteps.g_main_step(jcfg, jst2, jfeats, jnp.asarray(truth),
                                  jnp.asarray(zs[1]), jax.random.PRNGKey(2),
                                  jnp.float32(0.5))
    close_stats(ts, js, "Gmain bf16")
    close_updates(params_from_jax(before), tst3["g_params"],
                  params_from_jax(_np_tree(jst3["g_params"])),
                  2e-4 * 4 / 5, "Gmain bf16")
    # Parameters and their updates stay f32.
    assert all(v.dtype == torch.float32 for v in
               _flat_tensors(tst3["g_params"]))


def _flat_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat_tensors(v)]
    return [tree]


# ---------------------------------------------------------------------------
# The visualizer
# ---------------------------------------------------------------------------

def test_visualizer_sheets_equal_jax_and_png_round_trips(tmp_path):
    m = small_model(seed=4)
    (jgen, jenc), (tgen, tenc) = m["jax_cfg"], m["cfg"]
    j = jbrush.TriadGanPaintEngine(
        jgen, m["jax"]["gen_params"], m["jax"]["gen_state"], jenc,
        m["jax"]["enc_params"], m["jax"]["enc_state"],
        geom_inject_resolutions=(0, 1))
    t = tbrush.TriadGanPaintEngine(
        tgen, m["torch"]["gen_params"], m["torch"]["gen_state"], tenc,
        m["torch"]["enc_params"], m["torch"]["enc_state"],
        geom_inject_resolutions=(0, 1), device="cpu")
    jv = jviz.TrainingVisualizer(batch_size=4, width=32)
    tv = tviz.TrainingVisualizer(batch_size=4, width=32)
    jv.init(16)
    tv.init(16)
    np.testing.assert_array_equal(tv.fixed_z, jv.fixed_z)
    # The curated strokes: the JAX package rasterizes them in f32 C where
    # its native library is built (tests/test_torch_dataset.py), so 1e-5;
    # the sheets below start from the same geometry.
    np.testing.assert_allclose(tv.fixed_geom, jv.fixed_geom, atol=1e-5)
    tv.fixed_geom = jv.fixed_geom.copy()
    jv.do_visualize(str(tmp_path / "j"), j, "000001")
    tv.do_visualize(str(tmp_path / "t"), t, "000001")
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names and len(names) == 3
    for name in names:
        want = np.asarray(PIL.Image.open(tmp_path / "j" / name))
        got = np.asarray(PIL.Image.open(tmp_path / "t" / name))
        assert got.shape == want.shape, name
        # uint8 of renders that agree to ~1e-5: equal but where a value
        # sits on a rounding edge.
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and np.mean(diff == 0) > 0.999, \
            (name, diff.max(), np.mean(diff == 0))
    grid = np.random.RandomState(0).rand(5, 6, 7, 3).astype(np.float32)
    np.testing.assert_array_equal(tviz.make_grid(grid, nrow=2),
                                  jviz.make_grid(grid, nrow=2))
    uvs = np.random.RandomState(1).rand(2, 6, 6, 3).astype(np.float32)
    cols = np.random.RandomState(2).rand(2, 3, 3).astype(np.float32)
    np.testing.assert_allclose(
        tviz.compose_stroke_with_canvas(uvs, cols, "blur", uvs),
        jviz.compose_stroke_with_canvas(uvs, cols, "blur", uvs), atol=1e-6)

    for shape in [(7, 5), (6, 3, 2), (9, 4, 3), (3, 8, 4)]:
        img = np.random.RandomState(3).randint(0, 256, shape).astype(np.uint8)
        path = str(tmp_path / "png" / f"{len(shape)}_{shape[-1]}.png")
        write_png(path, img)
        np.testing.assert_array_equal(np.asarray(PIL.Image.open(path)), img)
    with pytest.raises(ValueError, match="uint8"):
        write_png(str(tmp_path / "f.png"), np.zeros((2, 2), np.float32))
