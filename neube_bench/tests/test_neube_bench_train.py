"""The training cell at a size the CPU holds: the benchmark's weights have
the program's layout; the plain reference follows the program's four
phases (32 px, batch 4, strict float32: losses, the gradients recovered
from Adam's moments, the change of G and D, the w-average, the reals as
ADA's pipe augmented them, Gmain's images); each cell writes its data in
a folder of its own; each control
of the reference and each fault planted under the program's phases fails
a limit; the work counts match hand counts; the readers read the trace as
the period's phases make it; and the run loads no JAX."""

import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from small import ROOT
from neube_bench import run
from neube_bench import train_weights as TW
from neube_bench.workcount import flops, peaks
from neube_bench.workcount import train as WT

TRAIN = "train-b64"


def small_train_cell(bf16_res: int = 0):
    """The cell at 32 px, channel_max 32, batch 4, 16 style images and 8
    geometry items, with the training CLI's own flags cut to that size."""
    manifest = run.load_manifest()
    cell, cfg, traffic = run.cell_parts(manifest, TRAIN)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg.update(img_resolution=32, channel_max=32, batch=4,
               num_bf16_res=bf16_res)
    cfg["flags"] = cfg["flags"] + [
        "--output_resolution=32", "--channel_max=32", "--batch=4",
        f"--num_bf16_res={bf16_res}", "--metrics="]
    traffic.update(styles=16, geometries=8, host_periods=1, max_periods=1)
    return manifest, cell, cfg, traffic


def _cell(impl="program", bf16_res=0, seed=2 ** 31 + 7):
    torch.set_num_threads(2)
    _, _, cfg, traffic = small_train_cell(bf16_res)
    c = run.driver(traffic).Cell(cfg, traffic, seed, "cpu", impl)
    c.setup()
    c.run_checked()
    c.free_program()
    return c, traffic


def _fails(numbers, traffic):
    return [k for k, v in numbers.items() if v > traffic["limits"][k]]


def test_training_weights_have_the_programs_layout():
    from brushstroke_engine_torch.flagship import flagship_encoder_config
    from brushstroke_engine_torch.models.discriminator import \
        DiscriminatorConfig
    from brushstroke_engine_torch.models.generator import \
        make_generator_config
    from brushstroke_engine_torch.utils.checkpoint import (
        init_native_params, params_from_jax)
    _, _, cfg, _ = small_train_cell()
    enc = flagship_encoder_config()
    gen = make_generator_config(
        z_dim=64, w_dim=64, img_resolution=32,
        geom_feature_resolutions=(4, 8), geom_feature_channels=(16, 256),
        channel_max=32)
    disc = DiscriminatorConfig(c_dim=0, img_resolution=32, img_channels=3,
                               channel_max=32, architecture="orig")
    theirs = {k: params_from_jax(v) for k, v in init_native_params(
        gen, enc, seed=0, disc_cfg=disc).items()}
    ours = TW.make_training_trees(cfg, 2 ** 33 + 1, "cpu")

    def shapes(t, p=""):
        out = {}
        for k, v in t.items():
            out.update(shapes(v, p + k + "/") if isinstance(v, dict)
                       else {p + k: tuple(v.shape)})
        return out
    assert shapes(ours) == shapes(theirs)


def test_reference_follows_the_programs_phases_in_float32():
    r = run.run_cell(*small_train_cell(), 2 ** 31 + 5, 0.0, False, "cpu")
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    for k, v in r["checks"].items():
        assert v["value"] <= (0 if k == "feed_rows_unmatched" else 1e-4), k
    assert r["metrics"]["train_images_per_s"]["value"] > 0
    assert r["attempted"] == 16 and r["failed"] == 0


def test_each_control_fails_a_limit():
    c, traffic = _cell(bf16_res=2)
    from neube_bench.drivers.train import CONTROLS
    for kind in CONTROLS:
        c.impl = "control:" + kind
        assert _fails(c.check(), traffic), kind
    c.impl = "control:no_warp"
    assert "aug_gap" in _fails(c.check(), traffic)


def test_cells_write_their_data_apart_and_remove_it():
    _, _, cfg, traffic = small_train_cell()
    cells = [run.driver(traffic).Cell(cfg, traffic, s, "cpu")
             for s in (11, 12)]
    for c in cells:
        c.setup()
    dirs = [c.work for c in cells]
    assert dirs[0] != dirs[1]
    assert all(os.path.exists(os.path.join(d, "styles.zip")) for d in dirs)
    for c in reversed(cells):       # the second wraps the first's steps
        c.free_program()
    assert not any(os.path.exists(d) for d in dirs)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_each_fault_of_the_program_is_not_correct(fault):
    r = run.run_cell(*small_train_cell(), 2 ** 31 + 9, 0.0, False, "cpu",
                     "fault:" + fault)
    assert not r["correct"], r["checks"]


def _toy():
    _, _, cfg, _ = small_train_cell()
    cfg = copy.deepcopy(cfg)
    cfg.update(img_resolution=8, channel_base=64, channel_max=8, batch=2,
               mapping_layers=1, z_dim=2, w_dim=2, num_bf16_res=1,
               geom_inject_resolutions=[0])
    return cfg


def test_flops_of_one_dmain_and_one_gpl_match_a_hand_count():
    cfg = _toy()
    # D at 8 px, 8 channels, batch 2: fromrgb 2*3*8*64*2 = 6144, conv0
    # 2*9*8*8*64*2 = 147456, conv1 (to 4 px) 2*9*8*8*16*2 = 36864; the
    # epilogue conv 2*9*9*8*16*2 = 41472, fc 2*128*8*2 = 4096, out 32.
    # G: b4 conv1 2*9*8*8*16 + affine 2*2*8 + demod 2*8*8 = 18592 per row,
    # b8 conv0 (from 4 px) 2*9*8*8*16 + 32 + 128 = 18592, conv1
    # 2*9*8*8*64 + 32 + 128 = 73888, torgb 2*8*3*64 + 2*2*17 = 3140,
    # mapping 2*2*2 = 8: 114220 per row.
    d_bf16 = 6144 * 4 + (147456 + 36864) * 6       # the 8-px block
    d_f32 = (41472 + 4096 + 32) * 6                 # the epilogue
    g_bf16 = (18592 + 73888 + 3140) * 2             # the 8-px block
    g_f32 = (18592 + 8) * 2                         # b4 and the mapping
    got = WT.phase_flops(cfg, "Dmain")
    assert got["bf16"] == pytest.approx(d_bf16 + g_bf16)
    assert got["f32"] == pytest.approx(d_f32 + g_f32)
    got = WT.phase_flops(cfg, "Gpl")                # one row, 4 passes
    assert got["bf16"] == pytest.approx((18592 + 73888 + 3140) * 4)
    assert got["f32"] == pytest.approx((18592 + 8) * 4)


def test_k2_bytes_match_a_hand_count():
    cfg = _toy()
    # Two rows of 8x8x3 float32 read and written, 8 float32 scalars each.
    assert WT.k2_bytes(cfg) == 2 * 2 * 8 * 8 * 3 * 4 + 2 * 8 * 4
    assert WT.period_k2(cfg, 16) == (50, 17)


class _Trace:
    def __init__(self, ops):
        self.device = [(n, 0.0, s) for n, s in ops]
        self.busy_s = sum(s for _, s in ops)

    def device_seconds(self, match):
        hits = [e for n, _, e in self.device if match(n)]
        return sum(hits), len(hits)


def _read(name, ctx):
    return run.reader(name)(ctx)


def test_kernel_readers_want_the_periods_launches():
    _, _, cfg, _ = small_train_cell()
    c = {"trace_batches": 16, "host_batches": 32, "host_seconds": 2.0,
         "period_batches": 16, "batch": cfg["batch"]}
    k1 = WT.period_k1(cfg, 16)
    n_w, n_wt = WT.period_k2(cfg, 16)
    ops = [("fir4_epilogue_kernel<float>", 1e-5)] * len(k1) \
        + [("warp_fused", 2e-6)] * n_w \
        + [("resample_gather_t", 1e-6)] * (2 * n_wt) + [("gemm", 1e-3)]
    ctx = {"cfg": cfg, "counters": c, "trace": _Trace(ops)}
    bound = sum(max(b / peaks.HBM_BYTES_PER_S, f / peaks.FLOPS_PER_S["f32"])
                for _, b, f in k1)
    assert _read("k1_roofline.train", ctx) == pytest.approx(
        100 * bound / (len(k1) * 1e-5))
    assert _read("k2_roofline.train", ctx) == pytest.approx(
        100 * (n_w + n_wt) * WT.k2_bytes(cfg) / peaks.HBM_BYTES_PER_S
        / (n_w * 2e-6 + 2 * n_wt * 1e-6))
    assert _read("launches_per_batch.train", ctx) == len(ops) / 16
    busy = ctx["trace"].busy_s
    assert _read("device_ms_per_image.train", ctx) == pytest.approx(
        1e3 * busy / (16 * cfg["batch"]))
    assert _read("idle_share.train", ctx) == pytest.approx(
        100 * (1 - (busy / 16) / (2.0 / 32)))
    ctx["trace"] = _Trace(ops[1:])                  # one K1 launch short
    assert _read("k1_roofline.train", ctx) is None
    ctx["trace"] = _Trace(ops[:len(k1)] + ops[len(k1) + 1:])
    assert _read("k2_roofline.train", ctx) is None


def test_mfu_counts_the_untraced_periods():
    _, _, cfg, _ = small_train_cell()
    c = {"host_batches": 32, "host_seconds": 4.0, "period_batches": 16}
    least = WT.period_least_seconds(cfg, 16, peaks.FLOPS_PER_S)
    assert _read("mfu.train", {"cfg": cfg, "counters": c}) == \
        pytest.approx(100 * 2 * least / 4.0)
    assert flops.forward_flops(cfg, 1) > 0


PROBE = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in list(sys.modules)}})))
"""


def _modules(body):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(
            root=ROOT, tests=os.path.join(ROOT, "neube_bench", "tests"),
            body=body)],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": "/tmp", "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_nothing_of_the_program_and_a_run_no_jax():
    mods = _modules("import neube_bench.reference.train, "
                    "neube_bench.reference.augment, neube_bench.train_weights,"
                    " neube_bench.workcount.train, "
                    "neube_bench.traffic.train_data")
    assert not mods & {"jax", "jaxlib", "flax", "brushstroke_engine_tpu",
                       "brushstroke_engine_torch"}
    mods = _modules(
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from test_neube_bench_train import small_train_cell\n"
        "from neube_bench import run\n"
        "run.run_cell(*small_train_cell(), 3, 0.0, False, 'cpu')\n")
    assert "brushstroke_engine_torch" in mods       # the program did run
    assert not mods & {"jax", "jaxlib", "flax", "brushstroke_engine_tpu"}
