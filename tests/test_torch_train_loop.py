"""The port's train state and training loop on the CPU, strict f32: the JAX
train state converted leaf by leaf, the FIR-epilogue kernel's backward with
the launch stood in for, and ``TrainingLoop``'s warm start, persistence,
stitch phase and unported options (its plain batches are in
``tests/test_torch_train_loop_batches.py``).

Small shapes: 32 px, B = 4, <= 32 channels.  Tolerances: converted trees
and the networks they drive 2e-5 abs; phase stats 1e-4 relative (+1e-5
abs); the FIR-epilogue gradients as stated in that test.
"""

import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.models import discriminator as jdisc
from brushstroke_engine_tpu.train import steps as jsteps
from brushstroke_engine_tpu.train import stitching as jstitching
from brushstroke_engine_torch.models import discriminator as tdisc
from brushstroke_engine_torch.ops import fir_epilogue as fe
from brushstroke_engine_torch.ops.filters import setup_filter
from brushstroke_engine_torch.train.loop import TrainingLoop
from brushstroke_engine_torch.utils.checkpoint import (
    params_from_jax, train_state_from_jax,
)
from brushstroke_engine_torch.utils.util import tree_leaves
from tests.torch_train_helpers import (  # noqa: F401 (_strict: autouse)
    _strict, RES, B, _np_tree, _train_cfgs, _jax_state, _batch, read_stats,
    small_loop,
)


# ---------------------------------------------------------------------------
# State conversion
# ---------------------------------------------------------------------------

def test_train_state_from_jax_round_trip():
    """A JAX train state after one Dmain and one Gmain step (non-zero Adam
    moments) converts leaf by leaf with the layout rules, and the converted
    trees drive the port's networks to the JAX package's outputs."""
    m, jcfg, tcfg = _train_cfgs()
    real, geom, truth, zs = _batch(1)
    state = _jax_state(m, jcfg)
    feats = jsteps.encode_geometry(jcfg, m["jax"]["enc_params"],
                                   m["jax"]["enc_state"], jnp.asarray(geom))
    state, _ = jsteps.d_main_step(jcfg, state, jnp.asarray(real), feats,
                                  jnp.asarray(zs[0]), jax.random.PRNGKey(1))
    state, _ = jsteps.g_main_step(jcfg, state, feats, jnp.asarray(truth),
                                  jnp.asarray(zs[1]), jax.random.PRNGKey(2),
                                  jnp.float32(0.5))
    snap = _np_tree(state)
    got = train_state_from_jax(snap, device="cpu")

    assert set(got) == set(snap)
    for k in ("g_opt", "d_opt"):
        assert got[k]["count"] == 1 and isinstance(got[k]["count"], int)
    assert got["geom_opt"]["count"] == 0
    for k in ("g_params", "d_params", "g_ema", "noise"):
        want = params_from_jax(snap[k])
        for a, b in zip(tree_leaves(got[k]), tree_leaves(want)):
            assert torch.equal(a, b)
    adam = state["d_opt"][0]
    for name in ("mu", "nu"):
        want = params_from_jax(_np_tree(getattr(adam, name)))
        for a, b, p in zip(tree_leaves(got["d_opt"][name]),
                           tree_leaves(want), tree_leaves(got["d_params"])):
            assert torch.equal(a, b) and a.shape == p.shape
    assert float(got["d_opt"]["nu"]["b4"]["fc"]["weight"].abs().sum()) > 0
    # b4.fc: only the [in, out] -> [out, in] transpose (both flatten NHWC).
    np.testing.assert_array_equal(
        got["d_params"]["b4"]["fc"]["weight"].numpy(),
        snap["d_params"]["b4"]["fc"]["weight"].T)
    for k in ("w_avg", "pl_mean", "ada_p", "ada_signs", "ada_count"):
        np.testing.assert_array_equal(got[k].numpy(), snap[k])
    img = np.random.RandomState(5).randn(B, RES, RES, 3).astype(np.float32)
    np.testing.assert_allclose(
        tdisc.discriminator_apply(tcfg.disc_cfg, got["d_params"],
                                  torch.from_numpy(img)).numpy(),
        np.asarray(jdisc.discriminator_apply(jcfg.disc_cfg,
                                             state["d_params"],
                                             jnp.asarray(img))),
        rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The FIR-epilogue kernel's backward, with the launch stood in for
# ---------------------------------------------------------------------------

def test_fir_epilogue_function_backward_and_double_backward(monkeypatch):
    """``_Fir4EpilogueFn`` wraps a launch whose result has no history.  With
    the launch replaced by the (detached) plain version on the CPU, its
    first and second derivatives must equal autograd through
    ``fir4_epilogue_plain``: before the repair the kernel path returned a
    tensor without ``grad_fn`` and every ``conv0`` layer cut the gradient."""
    def fake_launch(x, taps, d, noise, bias, act_gain, clamp, alpha, dt):
        return fe.fir4_epilogue_plain(x, taps, d, noise, bias, act_gain,
                                      clamp, alpha, dt).detach()

    monkeypatch.setattr(fe, "_launch_kernel", fake_launch)
    rng = np.random.RandomState(0)
    b, h, c = 2, 6, 5
    taps = fe.correlation_taps(setup_filter([1, 3, 3, 1]))

    def leaves():
        rs = np.random.RandomState(1)
        return [torch.from_numpy(a.astype(np.float32)).requires_grad_(True)
                for a in (rs.randn(b, h + 3, h + 3, c), rs.rand(b, c) + 0.5,
                          rs.randn(b, h, h, 1), rs.randn(c))]

    cot = torch.from_numpy(rng.randn(b, h, h, c).astype(np.float32))
    results = []
    for use_fn in (True, False):
        x, d, noise, bias = leaves()
        # A non-linear pre-map so second derivatives are not trivially 0.
        xin = torch.tanh(x) * 3
        if use_fn:
            y = fe._Fir4EpilogueFn.apply(xin, d, noise, bias, taps, 1.4, 2.0,
                                         0.2, torch.float32)
            assert y.grad_fn is not None
        else:
            y = fe.fir4_epilogue_plain(xin, taps, d, noise, bias, 1.4, 2.0,
                                       0.2, torch.float32)
        g1 = torch.autograd.grad((y * cot).sum(), [x, d, noise, bias],
                                 create_graph=True)
        penalty = sum(g.square().sum() for g in g1)
        g2 = torch.autograd.grad(penalty, [x, d, noise, bias],
                                 allow_unused=True)
        results.append((y.detach(), g1, g2))
    (y_a, g1_a, g2_a), (y_b, g1_b, g2_b) = results
    torch.testing.assert_close(y_a, y_b, rtol=0, atol=0)
    for a, b_ in zip(g1_a, g1_b):
        torch.testing.assert_close(a.detach(), b_.detach(), rtol=1e-6,
                                   atol=1e-6)
    for a, b_ in zip(g2_a, g2_b):
        assert (a is None) == (b_ is None)
        if a is not None:
            torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)
    assert g2_a[0] is not None and g2_a[0].abs().max() > 0
    # Under no_grad nothing is recorded.
    with torch.no_grad():
        x, d, noise, bias = leaves()
        y = fe._Fir4EpilogueFn.apply(x, d, noise, bias, taps, 1.4, 2.0, 0.2,
                                     torch.float32)
    assert y.grad_fn is None and not y.requires_grad


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

def test_training_loop_warm_start_and_unported_options(tmp_path):
    loop, cfg = small_loop(tmp_path, "w", geom_warmstart_kimg=2 * B / 1000.0)
    assert loop.in_warmstart()
    d0 = [t.clone() for t in tree_leaves(loop.state["d_params"])]
    loop.run(total_kimg=1.0, exit_after_warmstart=True)
    assert loop.batch_idx == 2 and not loop.in_warmstart()
    rows = read_stats(loop)
    assert all("Loss/forger/Ggeom-warm/total" in r for r in rows)
    assert all("Loss/D/loss" not in r for r in rows)
    for a, b in zip(d0, tree_leaves(loop.state["d_params"])):
        assert torch.equal(a, b)
    assert loop.state["geom_opt"]["count"] == 2
    # Persistence is ported (every tick here); the Orbax backend is not.
    assert {"network-snapshot-000000.pkl", "train_state.pkl"} <= \
        set(os.listdir(loop.run_dir))
    for method in (loop.save_train_state, loop.load_train_state):
        with pytest.raises(NotImplementedError, match="orbax"):
            method(backend="orbax")
    # No ramp-up in this configuration: beta follows the half-life.
    assert loop._ema_beta() == pytest.approx(
        0.5 ** (B / (cfg.ema_kimg * 1000.0)), rel=1e-6)

    for kw in (dict(use_fused=True), dict(device_banks=object()),
               dict(steps_per_dispatch=4), dict(mesh=object()),
               dict(profile_dir="x")):
        with pytest.raises(NotImplementedError):
            TrainingLoop(cfg, {}, {}, None, None, run_dir=str(tmp_path / "n"),
                         device="cpu", **kw)
    # auto_resume with nothing saved starts fresh.
    fresh = TrainingLoop(cfg, loop.enc_params, loop.enc_state, None, None,
                         run_dir=str(tmp_path / "n"), device="cpu",
                         auto_resume=True)
    assert fresh.cur_nimg == 0 and fresh.batch_idx == 0
    # The stitch phase runs (it raised before it was ported): Gstitch after
    # Greg, its second crop from the loop's seeded stream, which draws what
    # the JAX stitcher draws from a global ``random`` seeded alike.
    st, _ = small_loop(tmp_path, "s", geom_warmstart_kimg=0, stitch_interval=1,
                  stitch_phase_losses="1.0*gan(fake)+1.0*l1(patch)")
    assert st.stitch_on
    crop2 = st.stitcher.gen_overlapping_square_crop(
        RES + 8, (3, 5, RES, RES), random.Random(st.seed))
    random.seed(st.seed)
    assert crop2 == jstitching.RandomStitcher().gen_overlapping_square_crop(
        RES + 8, (3, 5, RES, RES))
    st.run(total_kimg=B / 1000.0)
    row = read_stats(st)[-1]
    for k in ("total", "gan_fake", "l1_patch"):
        assert np.isfinite(row[f"Loss/forger/Gstitch/{k}"]), k
    assert st.state["g_opt"]["count"] == 3     # Gmain, Gpl, Gstitch
