"""The config-f training cell at a size the CPU holds: its weights have the
program's layout for the 'skip' G and the 'resnet' D; the plain reference
follows the program's four phases through the loop (32 px, batch 4,
strict float32); the control 'below', a skipped warp, a state left
unchanged and one update doubled each fail a limit; the work count matches a hand count; the
readers read the period's spans and kernels; and the reference imports
nothing of the program."""

import copy

import pytest
import torch

from small import ROOT  # noqa: F401  (puts the checkout on the path)
from neube_bench import configf_weights as CW
from neube_bench import run
from neube_bench import trace_phases as P
from neube_bench.workcount import configf as WC
from neube_bench.workcount import peaks
from neube_bench.workcount import train as WT
from test_neube_bench_train import _Trace, _modules, _read

CELL = "train-configf-1024-b4"
SIZE_FLAGS = ["--output_resolution=32", "--channel_base=512",
              "--channel_max=32", "--zdim=32", "--wdim=32"]


def small_configf_cell(bf16_res: int = 0):
    """The cell at 32 px, channel_base 512, channel_max 32, z = w = 32,
    batch 4 (one mbstd group of 4), 16 style images, one period."""
    manifest = run.load_manifest()
    cell, cfg, traffic = run.cell_parts(manifest, CELL)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg.update(img_resolution=32, channel_base=512, channel_max=32,
               z_dim=32, w_dim=32, num_bf16_res=bf16_res)
    cfg["flags"] = cfg["flags"] + SIZE_FLAGS + [f"--num_bf16_res={bf16_res}"]
    traffic.update(styles=16, host_periods=1, max_periods=1)
    return manifest, cell, cfg, traffic


def _fails(numbers, traffic):
    return [k for k, v in numbers.items() if v > traffic["limits"][k]]


def test_configf_weights_have_the_programs_layout():
    from brushstroke_engine_torch.models.discriminator import \
        DiscriminatorConfig
    from brushstroke_engine_torch.models.generator import \
        make_generator_config
    from brushstroke_engine_torch.utils.checkpoint import (
        init_native_params, params_from_jax)
    _, _, cfg, _ = small_configf_cell()
    gen = make_generator_config(
        z_dim=32, w_dim=32, img_resolution=32, color_format="orig",
        architecture="skip", channel_base=512, channel_max=32)
    disc = DiscriminatorConfig(c_dim=0, img_resolution=32, img_channels=3,
                               channel_base=512, channel_max=32,
                               architecture="resnet")
    theirs = {k: params_from_jax(v) for k, v in init_native_params(
        gen, None, seed=0, disc_cfg=disc).items()}
    ours = CW.make_training_trees(cfg, 2 ** 33 + 1, "cpu")

    def shapes(t, p=""):
        out = {}
        for k, v in t.items():
            out.update(shapes(v, p + k + "/") if isinstance(v, dict)
                       else {p + k: tuple(v.shape)})
        return out
    assert shapes(ours) == shapes(theirs)


def test_reference_follows_the_programs_phases_in_float32():
    torch.set_num_threads(2)
    r = run.run_cell(*small_configf_cell(), 2 ** 31 + 5, 0.0, False, "cpu")
    assert r["correct"], r["checks"]
    for k, v in r["checks"].items():
        assert v["value"] <= (0 if k == "feed_rows_unmatched" else 1e-4), k
    assert r["metrics"]["train_images_per_s"]["value"] > 0
    assert r["attempted"] == 16 and r["failed"] == 0


def test_below_and_a_skipped_warp_fail_a_limit():
    torch.set_num_threads(2)
    _, _, cfg, traffic = small_configf_cell(bf16_res=2)
    c = run.driver(traffic).Cell(cfg, traffic, 2 ** 31 + 7, "cpu")
    c.setup()
    c.run_checked()
    c.free_program()
    c.impl = "control:below"
    assert _fails(c.check(), traffic)
    c.impl = "control:no_warp"
    assert "aug_gap" in _fails(c.check(), traffic)


def test_a_state_left_unchanged_is_not_correct():
    torch.set_num_threads(2)
    r = run.run_cell(*small_configf_cell(), 2 ** 31 + 9, 0.0, False, "cpu",
                     "fault:unchanged")
    assert not r["correct"]
    assert r["checks"]["step_change_gap.G"]["value"] == 1.0
    assert r["checks"]["step_change_gap.D"]["value"] == 1.0


def test_one_update_doubled_fails_the_step_change_alone():
    """Each step taken again from the program's own state: a doubled
    update of one layer reads 1 there, while every other number holds."""
    torch.set_num_threads(2)
    r = run.run_cell(*small_configf_cell(), 2 ** 31 + 9, 0.0, False, "cpu",
                     "fault:altered")
    over = [k for k, v in r["checks"].items() if v["value"] > v["limit"]]
    assert over == ["step_change_gap.G"]
    assert abs(r["checks"]["step_change_gap.G"]["value"] - 1.0) < 1e-3


def _toy():
    _, _, cfg, _ = small_configf_cell()
    cfg = copy.deepcopy(cfg)
    cfg.update(img_resolution=8, channel_base=64, channel_max=8, batch=2,
               mapping_layers=1, z_dim=2, w_dim=2, num_bf16_res=1)
    return cfg


def test_flops_of_one_dmain_and_one_gpl_match_a_hand_count():
    cfg = _toy()
    # D at 8 px, 8 channels, batch 2: fromrgb 2*3*8*64*2 = 6144, conv0
    # 2*9*8*8*64*2 = 147456, conv1 (to 4 px) 2*9*8*8*16*2 = 36864, skip
    # 2*8*8*16*2 = 4096; the epilogue conv 2*9*9*8*16*2 = 41472, fc
    # 2*128*8*2 = 4096, out 32.  G per row: b4 conv1 2*9*8*8*16 + affine
    # 2*2*8 + demod 2*8*8 = 18592, torgb 2*8*3*16 + 2*2*8 = 800; b8 conv0
    # (from 4 px) 18592, conv1 2*9*8*8*64 + 32 + 128 = 73888, torgb
    # 2*8*3*64 + 32 = 3104; mapping 2*2*2 = 8.
    d_bf16 = 6144 * 4 + (147456 + 36864 + 4096) * 6
    d_f32 = (41472 + 4096 + 32) * 6
    g_bf16 = (18592 + 73888 + 3104) * 2
    g_f32 = (18592 + 800 + 8) * 2
    got = WC.phase_flops(cfg, "Dmain")
    assert got["bf16"] == pytest.approx(d_bf16 + g_bf16)
    assert got["f32"] == pytest.approx(d_f32 + g_f32)
    got = WC.phase_flops(cfg, "Gpl")                # one row, 4 passes
    assert got["bf16"] == pytest.approx((18592 + 73888 + 3104) * 4)
    assert got["f32"] == pytest.approx((18592 + 800 + 8) * 4)
    assert WC.period_flops(cfg, 16)["f32"] == pytest.approx(
        16 * (WC.phase_flops(cfg, "Dmain")["f32"]
              + WC.phase_flops(cfg, "Gmain")["f32"])
        + WC.phase_flops(cfg, "Dr1")["f32"]
        + 4 * WC.phase_flops(cfg, "Gpl")["f32"])


class _SpanTrace(_Trace):
    """A trace with host spans and launches: ``host`` (name, start, end),
    the device list as ``_Trace`` makes it, one kernel per unit of time."""

    def __init__(self, host, ops, span=(0.0, 100.0)):
        self.host = host
        self.span = span
        self.device = [(n, s, e) for n, s, e in ops]
        self.busy_s = sum(e - s for _, s, e in ops)


def test_span_readers_attribute_kernels_by_launch_time():
    _, _, cfg, _ = small_configf_cell()
    c = {"trace_batches": 16, "host_batches": 32, "host_seconds": 2.0,
         "period_batches": 16, "batch": cfg["batch"]}
    # Two kernels launched inside Dr1 (one from another thread's launch
    # at 12.5) run after the span has closed; one launched before it runs
    # inside it.
    host = [("bse.train.data", 0.0, 2.0), ("bse.train.Dmain", 3.0, 10.0),
            ("bse.train.Dr1", 11.0, 13.0), ("bse.train.data", 20.0, 21.0),
            ("cudaLaunchKernel", 9.0, 9.1), ("cudaLaunchKernel", 11.5, 11.6),
            ("cuLaunchKernel", 12.5, 12.6), ("cudaMemcpyAsync", 1.0, 1.1)]
    ops = [("Memcpy HtoD", 1.5, 1.8), ("k0", 11.2, 11.9), ("k1", 14.0, 15.0),
           ("k2", 15.0, 15.5)]
    tr = _SpanTrace(host, ops)
    ctx = {"cfg": cfg, "counters": c, "trace": tr}
    assert P.launched_seconds(tr, P.intervals(tr, "bse.train.Dr1")) == \
        pytest.approx(1.5)
    assert _read("dr1_ms_per_image.configf", ctx) == pytest.approx(
        1e3 * 1.5 / (16 * cfg["batch"]))
    assert _read("gpl_ms_per_image.configf", ctx) is None
    # Idle inside the data spans: 2 - 0.3 s and 1 s, over two spans.
    assert _read("data_wait_ms.configf", ctx) == pytest.approx(
        1e3 * (1.7 + 1.0) / 2)
    ctx["trace"] = _SpanTrace(host[:-1], ops)      # a launch unmatched
    assert _read("dr1_ms_per_image.configf", ctx) is not None
    ctx["trace"] = _SpanTrace(host[:5], ops)
    assert _read("dr1_ms_per_image.configf", ctx) is None


def test_kernel_and_step_readers_at_configf_shapes():
    _, _, cfg, _ = small_configf_cell()
    c = {"trace_batches": 16, "host_batches": 32, "host_seconds": 4.0,
         "period_batches": 16, "batch": cfg["batch"]}
    k1 = WT.period_k1(cfg, 16)
    n_w, n_wt = WT.period_k2(cfg, 16)
    ops = [("fir4_epilogue_kernel<bf16>", 1e-5)] * len(k1) \
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
    busy = ctx["trace"].busy_s
    assert _read("device_ms_per_image.train", ctx) == pytest.approx(
        1e3 * busy / (16 * cfg["batch"]))
    assert _read("idle_share.train", ctx) == pytest.approx(
        100 * (1 - (busy / 16) / (4.0 / 32)))
    assert _read("launches_per_batch.train", ctx) == pytest.approx(
        len(ops) / 16)
    least = WC.period_least_seconds(cfg, 16, peaks.FLOPS_PER_S)
    assert _read("mfu.configf", ctx) == pytest.approx(100 * 2 * least / 4.0)
    ctx["trace"] = _Trace(ops[1:])                  # one K1 launch short
    assert _read("k1_roofline.train", ctx) is None


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules("import neube_bench.reference.train_configf, "
                    "neube_bench.configf_weights, neube_bench.trace_phases, "
                    "neube_bench.workcount.configf")
    assert not mods & {"jax", "jaxlib", "flax", "brushstroke_engine_tpu",
                       "brushstroke_engine_torch"}
