"""StyleGAN2 config-f's training in the port on the CPU: the 'skip' G with
StyleGAN2's RGB head and the 'resnet' D, with no geometry.

* ``tools/train.py:setup_config`` hands ``--synthesis_arch`` and
  ``--channel_base`` to G and D and builds no encoder without an injected
  resolution; NeuBE's ``train_flags.txt`` still builds the same 'orig' G.
* Each phase (Dmain, Dr1, Gmain, Gpl) and ADA's step, at 32 px with
  channel_base 512 / channel_max 32, batch 4 (one minibatch-stddev group
  of 4), strict float32, against the benchmark's plain reference
  (``neube_bench/reference/train_configf.py``) on its seeded weights and
  draws: the loss and the gradient as Adam got it (beta1 = 0: the first
  moment is the gradient) within 1e-4 relative (1e-6 absolute) -- the two
  sum in other orders; the change of the parameters by the benchmark
  check's measure, each leaf's norm within 1e-4 of the reference leaf's
  (or of the median leaf's, if larger): Adam's first step is about lr *
  sign(g), so an entry whose gradient is within rounding of Adam's eps
  moves by a step-sized amount in one of the two (1-7 entries of 73k).
* ``TrainingLoop.run`` trains 16 batches with no encoder pass and no
  geometry batch, writes a snapshot without an encoder, and opens its
  ``bse.train.*`` and ``bse.disc.block{res}`` spans in order.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from brushstroke_engine_torch.ops.precision import set_precision_mode
from brushstroke_engine_torch.tools import train as cli
from brushstroke_engine_torch.train import steps as tsteps
from brushstroke_engine_torch.train.state import init_train_state
from neube_bench import configf_weights as CW
from neube_bench.reference import augment as RA
from neube_bench.reference import train as RT
from neube_bench.reference import train_configf as RC
from tests import torch_helpers  # noqa: F401  (one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SEED = 4, 2 ** 31 + 21
SIZE_FLAGS = ["--output_resolution=32", "--channel_base=512",
              "--channel_max=32", "--zdim=32", "--wdim=32",
              "--num_bf16_res=0"]


def _bench_cfg(name):
    with open(os.path.join(REPO, "neube_bench", "configs", name)) as f:
        return json.load(f)


CONFIGF = _bench_cfg("stylegan2-configf-1024-train.json")


@pytest.fixture(autouse=True)
def _strict():
    set_precision_mode("strict")
    yield
    set_precision_mode("strict")


def _small_cfg():
    cfg = dict(CONFIGF)
    cfg.update(img_resolution=32, channel_base=512, channel_max=32,
               z_dim=32, w_dim=32, num_bf16_res=0)
    return cfg


def _train_cfg(flags):
    return cli.setup_config(cli.build_parser().parse_args(
        ["--outdir", "unused"] + flags))


def test_configf_flags_reach_generator_and_discriminator():
    cfg, enc_cfg, enc_params, enc_state = _train_cfg(CONFIGF["flags"])
    syn, disc = cfg.gen_cfg.synthesis, cfg.disc_cfg
    assert syn.architecture == "skip" and syn.color_format == "orig"
    assert disc.architecture == "resnet"
    assert syn.channel_base == disc.channel_base == 32768
    assert [syn.channels(r) for r in syn.block_resolutions] == \
        [512] * 5 + [256, 128, 64, 32]
    assert [disc.channels(r) for r in disc.block_resolutions] == \
        [32, 64, 128, 256, 512, 512, 512, 512]
    assert syn.num_ws == 18 and cfg.gen_cfg.z_dim == 512
    assert cfg.enc_res == () and enc_cfg is enc_params is enc_state is None
    assert cfg.r1_gamma == 10 and cfg.batch_size == 4
    assert cfg.ema_kimg == 1.25 and cfg.ema_rampup is None
    assert syn.block_dtype(64) == torch.float32
    assert syn.block_dtype(128) == torch.bfloat16


def test_neube_training_flags_build_the_same_orig_generator():
    from brushstroke_engine_torch.models.generator import \
        make_generator_config
    flags = _bench_cfg("neube-flagship-128-train.json")["flags"]
    cfg, enc_cfg, _, _ = _train_cfg(flags)
    assert enc_cfg is not None and cfg.enc_res == (0, 1)
    assert cfg.gen_cfg == make_generator_config(
        z_dim=64, w_dim=64, img_resolution=128,
        geom_feature_resolutions=tuple(
            enc_cfg.featuremap_resolution(128, r) for r in (0, 1)),
        geom_feature_channels=tuple(
            enc_cfg.feature_channels(r) for r in (0, 1)),
        color_format="triad", channel_base=16384, channel_max=128,
        num_bf16_res=4)
    assert cfg.gen_cfg.synthesis.architecture == "orig"
    assert cfg.disc_cfg.channel_base == 16384
    assert cfg.disc_cfg.architecture == "orig"


# ---------------------------------------------------------------------------
# The convolutions' derivatives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transpose,stride,size,groups", [
    (False, 1, 7, 1), (False, 2, 10, 1), (True, 2, 5, 1), (False, 1, 9, 3)])
def test_conv_derivatives_equal_autograds(transpose, stride, size, groups):
    """``ops/gradfix.py:conv``'s first and second derivatives (the
    input's, the weight's and the gradient's own) equal autograd's through
    the plain op, in float64; a strided conv of an even size needs the
    transposed op's output padding; a depthwise conv (the FIRs) too."""
    import torch.nn.functional as F
    from brushstroke_engine_torch.ops.gradfix import conv
    gen = torch.Generator().manual_seed(size)
    x = torch.randn((2, 3, size, size), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    shape = (3, 1, 4, 4) if groups > 1 else \
        (3, 4, 3, 3) if transpose else (4, 3, 3, 3)
    w = torch.randn(shape, generator=gen, dtype=torch.float64,
                    requires_grad=True)

    def plain(x, w):
        return (F.conv_transpose2d if transpose else F.conv2d)(
            x, w, stride=stride, groups=groups)

    def ours(x, w):
        return conv(x, w, transpose, stride, groups)

    y = ours(x, w)
    assert torch.equal(y, plain(x, w))
    assert torch.autograd.gradcheck(ours, (x, w))
    assert torch.autograd.gradgradcheck(ours, (x, w))
    # R1's shape: the penalty of the input gradient, differentiated by the
    # weight, against autograd's.
    got, want = [], []
    for fn, out in ((ours, got), (plain, want)):
        (gx,) = torch.autograd.grad(fn(x, w).square().sum(), x,
                                    create_graph=True)
        out.extend(torch.autograd.grad(gx.square().sum(), (x, w)))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# Phases against the plain reference
# ---------------------------------------------------------------------------

def _draws(cfg, gen):
    def g(n):
        noise = {}
        for r in (4, 8, 16, 32):
            for i in ((1,) if r == 4 else (0, 1)):
                noise[f"b{r}.conv{i}"] = torch.randn((n, r, r, 1),
                                                     generator=gen)
        return {"mixing": {"cutoff_u": torch.rand((), generator=gen),
                           "apply_u": torch.rand((), generator=gen) * 0.5,
                           "z2": torch.randn((n, 32), generator=gen)},
                "noise": noise}
    return {"Dmain": {"g": g(B), "aug_fake": RA.make_draws(gen, B, "cpu"),
                      "aug_real": RA.make_draws(gen, B, "cpu")},
            "Dr1": {"aug": RA.make_draws(gen, B, "cpu")},
            "Gmain": {"g": g(B), "aug": RA.make_draws(gen, B, "cpu")},
            "Gpl": {"g": g(B // 2), "pl_noise": torch.randn(
                (B // 2, 32, 32, 3), generator=gen)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        torch.testing.assert_close(got[k].float(), want[k].float(),
                                   rtol=1e-4, atol=1e-6, msg=f"{what} {k}")


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    set_precision_mode("strict")
    cfg = _small_cfg()
    tcfg, *_ = _train_cfg(CONFIGF["flags"] + SIZE_FLAGS)
    trees = CW.make_training_trees(cfg, SEED, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    real = torch.rand((B, 32, 32, 3), generator=gen) * 2 - 1
    z = {ph: torch.randn((B, 32), generator=gen)
         for ph in ("Dmain", "Gmain", "Gpl")}
    return cfg, tcfg, trees, real, z, _draws(cfg, gen)


def _program_state(tcfg, trees):
    state = init_train_state(tcfg, 0, g_params=trees["gen_params"],
                             g_state=trees["gen_state"],
                             d_params=trees["disc_params"], device="cpu")
    state["ada_p"] = torch.tensor(0.2)
    return state


PHASES = {
    "Dmain": (lambda tc, st, real, z, dr: tsteps.d_main_step(
        tc, st, real, [], z["Dmain"], draws=dr["Dmain"]),
        lambda c, st, real, z, dr, kn: RC.d_main(
            c, st, real, z["Dmain"], dr["Dmain"], kn)),
    "Dr1": (lambda tc, st, real, z, dr: tsteps.d_reg_step(
        tc, st, real, draws=dr["Dr1"]),
        lambda c, st, real, z, dr, kn: RC.d_r1(c, st, real, dr["Dr1"], kn)),
    "Gmain": (lambda tc, st, real, z, dr: tsteps.g_main_step(
        tc, st, [], None, z["Gmain"], draws=dr["Gmain"]),
        lambda c, st, real, z, dr, kn: RC.g_main(
            c, st, z["Gmain"], dr["Gmain"], kn)),
    "Gpl": (lambda tc, st, real, z, dr: tsteps.g_reg_step(
        tc, st, [], z["Gpl"], draws=dr["Gpl"]),
        lambda c, st, real, z, dr, kn: RC.g_pl(c, st, z["Gpl"], dr["Gpl"],
                                               kn)),
}
LOSS = {"Dmain": "Loss/D/loss", "Dr1": "Loss/D/reg", "Gmain": "Loss/G/loss",
        "Gpl": "Loss/G/reg"}


@pytest.mark.parametrize("phase", list(PHASES))
def test_phase_matches_the_plain_reference(setup, phase):
    cfg, tcfg, trees, real, z, dr = setup
    state = _program_state(tcfg, trees)
    ref = RT.init_state(cfg, trees, 0.2)
    knobs = RT.Knobs(RT.precision(cfg))
    new, stats = PHASES[phase][0](tcfg, state, real, z, dr)
    ref_new, ref_loss, ref_grads = PHASES[phase][1](cfg, ref, real, z, dr,
                                                    knobs)
    torch.testing.assert_close(stats[LOSS[phase]].float(), ref_loss,
                               rtol=1e-4, atol=1e-6)
    net = "d" if phase.startswith("D") else "g"
    _close(_flat(new[f"{net}_opt"]["mu"]), ref_grads, "gradient")
    old = _flat(state[f"{net}_params"])
    change = {k: v - old[k] for k, v in _flat(new[f"{net}_params"]).items()}
    assert RT.worst_leaf_gap(change, {
        k: v - ref[net][k] for k, v in ref_new[net].items()}) <= 1e-4


def test_ada_step_matches_the_plain_reference(setup):
    cfg, tcfg, trees, real, z, dr = setup
    state, _ = PHASES["Dmain"][0](tcfg, _program_state(tcfg, trees), real,
                                  z, dr)
    ref, _, _ = PHASES["Dmain"][1](cfg, RT.init_state(cfg, trees, 0.2),
                                   real, z, dr, RT.Knobs(RT.precision(cfg)))
    assert float(state["ada_signs"]) == float(ref["ada_signs"])
    new = tsteps.ada_update(tcfg, state, float(B * cfg["ada_interval"]))
    ref = RT.ada_adjust(cfg, ref, B)
    torch.testing.assert_close(new["ada_p"], ref["ada_p"], rtol=1e-6, atol=0)
    assert float(new["ada_p"]) != 0.2


@pytest.mark.parametrize("augment", [None, "bgc"])
def test_phase_cycle_matches_jax(augment):
    """Dmain -> Dr1 -> Gmain -> Gpl of a small 'skip' G with the RGB head
    and a 'resnet' D, with no geometry, against the JAX package: the skip
    trunk's double backward in Gpl and the resnet D's in Dr1, both through
    ``ops/gradfix.py`` (``torch_train_helpers.full_phase_cycle``, with its
    tolerances)."""
    from tests.torch_train_helpers import (
        CONFIGF_DISC, CONFIGF_MODEL, full_phase_cycle)
    full_phase_cycle(augment, model=CONFIGF_MODEL, disc=CONFIGF_DISC)


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

def _loop(tmp_path):
    loop, _ = cli.build(CONFIGF["flags"] + SIZE_FLAGS + [
        "--outdir", str(tmp_path), "--device", "cpu", "--seed", "3"])
    return loop


def test_loop_trains_16_batches_without_geometry(tmp_path, monkeypatch):
    calls = {}
    for name in ("d_main_step", "d_reg_step", "g_main_step", "g_reg_step",
                 "ada_update"):
        fn = getattr(tsteps, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tsteps, name, counted)

    def no_encoder(*a, **kw):
        raise AssertionError("the geometry encoder ran")
    monkeypatch.setattr(tsteps, "encode_geometry", no_encoder)
    loop = _loop(tmp_path)
    assert loop.geom_iter is None and loop.enc_params is None
    assert loop.geom_step is None and loop.warm_step is None
    assert not loop.in_warmstart()
    loop.run(total_kimg=16 * B / 1000)
    assert loop.batch_idx == 16
    assert calls == {"d_main_step": 16, "g_main_step": 16, "d_reg_step": 1,
                     "g_reg_step": 4, "ada_update": 3}
    from brushstroke_engine_torch.utils.checkpoint import load_native
    snaps = [f for f in os.listdir(loop.run_dir)
             if f.startswith("network-snapshot")]
    bundle = load_native(os.path.join(loop.run_dir, snaps[0]), device="cpu")
    assert bundle.enc_cfg is None and bundle.enc_params == {}
    assert bundle.gen_cfg == loop.cfg.gen_cfg
    assert all(np.isfinite(float(v)) for v in
               (loop.state["ada_p"], loop.state["pl_mean"]))


def test_training_spans_open_and_close_in_order(tmp_path):
    loop = _loop(tmp_path)
    # Batch 16: every phase runs, ADA's step too.
    loop.batch_idx, loop.cur_nimg = 16, 16 * B
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.run(total_kimg=17 * B / 1000)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith("bse."))
    train = [(s, e, n) for s, e, n in spans if n.startswith("bse.train.")]
    assert [n for _, _, n in train] == [
        "bse.train.data", "bse.train.Dmain", "bse.train.Dr1",
        "bse.train.Gmain", "bse.train.Gpl", "bse.train.ada"]
    assert all(e0 <= s1 for (_, e0, _), (s1, _, _) in zip(train, train[1:]))
    blocks = [f"bse.disc.block{r}" for r in (32, 16, 8)]
    for s0, e0, phase in train:
        inner = [n for s, e, n in spans
                 if n.startswith("bse.disc.") and s0 <= s and e <= e0]
        # Dmain: fakes and reals; Dr1: reals; Gmain: fakes; D never runs
        # in Gpl, nor outside the phases.
        passes = {"bse.train.Dmain": 2, "bse.train.Dr1": 1,
                  "bse.train.Gmain": 1}.get(phase, 0)
        assert inner == blocks * passes, phase
    disc = [(s, e) for s, e, n in spans if n.startswith("bse.disc.")]
    assert all(e0 <= s1 for (_, e0), (s1, _) in zip(disc, disc[1:]))
