"""The port's fused training step (``train/fused.py``) and the loop's
production path, on the CPU, strict f32.

Against the JAX package's ``make_fused_train_step`` (one jitted program for
both batches, compiled once for the module): a batch with Dmain, Dr1,
Gmain, Gpl and Ggeom, and a warm-start batch whose loss reads the frozen
original generator (``fake_orig``, the clarity finetune), the JAX key's
splits replayed as the port's draws.  The stats contract: every phase's key
on every batch, NaN where the phase did not run, the key table against
``jax.eval_shape`` of the JAX step (the stitch phase's keys: the JAX
package's ``test_fused.py`` pins those).  Then the port alone: a chunk of two
batches equals two single steps with the same draws, and a tick keeps each
stat's last finite value (the loop's production path is in
``tests/test_torch_fused_loop.py``).

Small shapes: 32 px, B = 4, <= 32 channels, constant noise, no style mixing
and no ADA, so the only draws are the latents and the path-length noise.
Tolerances (phase 7's and the phase tests'): stats 1e-4 relative (+1e-5
abs); the G and D updates by the phase tests' Adam rule over the summed
learning rate of the phases that moved them (per tensor the mean
|delta_port - delta_jax| under 2 % of it, 99 % of the entries under 10 %).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.train import fused as jfused
from brushstroke_engine_torch.parallel.mesh import make_mesh
from brushstroke_engine_torch.train import fused as tfused
from brushstroke_engine_torch.train import state as tstate
from brushstroke_engine_torch.train.loop import _fetch_stats
from brushstroke_engine_torch.utils.checkpoint import (
    params_from_jax, train_state_from_jax,
)
from brushstroke_engine_torch.utils.util import tree_leaves
from tests.torch_train_helpers import (  # noqa: F401 (_strict: autouse)
    _strict, RES, B, _np_tree, _train_cfgs, _jax_state, _batch,
    _assert_update_parity, STAT_TOL,
)


WARM_LOSSES = "0.5*iou_inv(uvs)+2.0*l1(fake_orig)"
CFG = dict(d_reg_interval=2, g_reg_interval=2, geom_interval=2,
           geom_warmstart_kimg=1, geom_warmstart_losses=WARM_LOSSES)


@pytest.fixture(scope="module")
def jax_fused():
    """The configs, the JAX fused step (one compile for the module) and a
    frozen original generator 1 % off the weights."""
    m, jcfg, tcfg = _train_cfgs(**CFG)
    g_orig = jax.tree_util.tree_map(lambda a: np.array(a) * np.float32(1.01),
                                    m["np"]["gen_params"])
    return m, jcfg, tcfg, jfused.make_fused_train_step(jcfg), g_orig


def _replay(key, jcfg, n):
    """The port's draws for the JAX fused step's key: ``k = split(key,
    10)``; z1 / z2 / z3 from k[5:8]; Gpl's image noise from ``split(k[3])``
    on the shrunk batch."""
    k = jax.random.split(key, 10)
    zdim = jcfg.gen_cfg.z_dim
    z = [torch.from_numpy(np.array(jax.random.normal(k[i], (n, zdim))))
         for i in (5, 6, 7)]
    bs = n // jcfg.pl_batch_shrink
    pl = np.array(jax.random.normal(jax.random.split(k[3])[1],
                                    (bs, RES, RES, 3)))
    return {"z1": z[0], "z2": z[1], "z3": z[2],
            "greg": {"pl_noise": torch.from_numpy(pl)}}


@pytest.mark.parametrize("case", ["regularized", "warm_fake_orig"])
def test_fused_batch_equals_jax(jax_fused, case):
    m, jcfg, tcfg, jstep, g_orig = jax_fused
    warm = case == "warm_fake_orig"
    real, geom, truth, _ = _batch(3)
    jst = _jax_state(m, jcfg)
    tst = train_state_from_jax(_np_tree(jst), device="cpu")
    before = {k: _np_tree(jst[k]) for k in ("g_params", "d_params")}
    key = jax.random.PRNGKey(21)
    jst2, js = jstep(jst, m["jax"]["enc_params"], m["jax"]["enc_state"],
                     jnp.asarray(real), jnp.asarray(geom), jnp.asarray(truth),
                     key, jnp.int32(0), jnp.bool_(warm), jnp.float32(0.5),
                     g_orig_params=jax.tree_util.tree_map(jnp.asarray,
                                                          g_orig))
    tstep = tfused.make_fused_train_step(tcfg)
    tst2, ts = tstep(tst, m["torch"]["enc_params"], m["torch"]["enc_state"],
                     torch.from_numpy(real), torch.from_numpy(geom),
                     torch.from_numpy(truth), 0, warm, 0.5,
                     draws=_replay(key, jcfg, B),
                     g_orig_params=params_from_jax(g_orig))

    # The stats contract: the same keys, NaN in the same places.
    js = {k: float(v) for k, v in js.items()}
    ts = {k: float(v) for k, v in ts.items()}
    assert set(ts) == set(js)
    ran = {k for k, v in js.items() if np.isfinite(v)}
    assert ran == {k for k, v in ts.items() if np.isfinite(v)}
    if warm:
        assert ran == {k for k in js if k.startswith(
            "Loss/forger/Ggeom-warm/")}
        assert ts["Loss/forger/Ggeom-warm/l1_fake_orig"] > 0
    else:
        assert {"Loss/r1_penalty", "Loss/pl_penalty",
                "Loss/forger/Ggeom/total"} <= ran
        assert not any("Ggeom-warm" in k for k in ran)
    for k in ran:
        np.testing.assert_allclose(ts[k], js[k], err_msg=k, **STAT_TOL)

    lr = 2e-4
    moves = {"g_params": 1 if warm else 3, "d_params": 0 if warm else 2}
    for k, n in moves.items():
        after = params_from_jax(_np_tree(jst2[k]))
        if n == 0:
            for a, b in zip(tree_leaves(tst2[k]),
                            tree_leaves(params_from_jax(before[k]))):
                assert torch.equal(a, b), k
            continue
        _assert_update_parity(params_from_jax(before[k]), tst2[k], after,
                              n * lr, f"{case} {k}")
    for k in ("w_avg", "pl_mean"):
        np.testing.assert_allclose(tst2[k].numpy(), np.asarray(jst2[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    counts = {"g_opt": 0, "d_opt": 0, "geom_opt": 1} if warm else \
        {"g_opt": 2, "d_opt": 2, "geom_opt": 1}
    assert {k: tst2[k]["count"] for k in counts} == counts


def test_stat_key_table_equals_jax_eval_shape(jax_fused):
    """``fused_stat_keys`` (the module's table plus the configured loss
    items) is the key set of the JAX step's stats by ``jax.eval_shape``,
    every one a 0-d f32; stitching adds its phase's keys, a configuration
    without a warm start or a geometry phase has neither."""
    m, jcfg, tcfg, jstep, g_orig = jax_fused
    real, geom, truth, _ = _batch(0)
    _, want = jax.eval_shape(
        lambda s: jstep(s, m["jax"]["enc_params"], m["jax"]["enc_state"],
                        jnp.asarray(real), jnp.asarray(geom),
                        jnp.asarray(truth), jax.random.PRNGKey(0),
                        jnp.int32(0), jnp.bool_(False), jnp.float32(0.5),
                        g_orig_params=jax.tree_util.tree_map(jnp.asarray,
                                                             g_orig)),
        _jax_state(m, jcfg))
    table = tfused.fused_stat_keys(tcfg)
    got = [k for keys in table.values() for k in keys]
    assert len(got) == len(set(got)) and set(got) == set(want)
    assert all(v.shape == () and v.dtype == jnp.float32
               for v in want.values())
    assert set(table) == set(tfused.PHASE_STATS) - {"stitch"}
    stitch = tfused.fused_stat_keys(dataclasses.replace(
        tcfg, stitch_interval=2,
        stitch_phase_losses="1.0*gan(fake)+1.0*l1(patch)"))
    assert stitch["stitch"] == ("Loss/forger/Gstitch/total",
                                "Loss/forger/Gstitch/gan_fake",
                                "Loss/forger/Gstitch/l1_patch")
    assert {k: v for k, v in stitch.items() if k != "stitch"} == table
    assert table["gmain"] == ("Loss/G/loss", "Loss/G/total_loss",
                              "Loss/forger/Gmain/iou_inv_uvs")
    _, _, bare = _train_cfgs(geom_warmstart_kimg=0, geom_interval=0)
    assert set(tfused.fused_stat_keys(bare)) == {"dmain", "dreg", "gmain",
                                                 "greg"}


def _draws(tcfg, n, seed):
    gen = torch.Generator().manual_seed(seed)
    zd = tcfg.gen_cfg.z_dim
    return {"z1": torch.randn((n, zd), generator=gen),
            "z2": torch.randn((n, zd), generator=gen),
            "z3": torch.randn((n, zd), generator=gen),
            "bank": (torch.randint(0, 6, (n,), generator=gen),
                     torch.randint(0, 5, (n,), generator=gen)),
            "greg": {"pl_noise": torch.randn((n // 2, RES, RES, 3),
                                             generator=gen)}}


def test_chunk_of_two_equals_two_single_steps():
    """``chunk=2`` from batch 3 and image 12: the same as two bank steps
    at batches 3 and 4 with the crops drawn from the same host stream, the
    warm flag from the image count (the warm start ends at image 16) and
    the EMA beta with its ramp-up in f32."""
    m, _, tcfg = _train_cfgs(d_reg_interval=2, g_reg_interval=2,
                             geom_interval=2, geom_warmstart_kimg=0.016,
                             ema_rampup=0.05)
    rng = np.random.RandomState(2)
    style = torch.from_numpy(rng.randint(0, 256, (6, RES, RES, 3)).astype(
        np.uint8))
    tri = torch.from_numpy(rng.randint(0, 256, (5, RES + 8, RES + 8, 3))
                           .astype(np.uint8))
    state = tstate.init_train_state(
        tcfg, seed=2, g_params=m["torch"]["gen_params"],
        g_state=m["torch"]["gen_state"], device="cpu")
    enc = (m["torch"]["enc_params"], m["torch"]["enc_state"])
    draws = [_draws(tcfg, B, 1), _draws(tcfg, B, 2)]

    chunk = tfused.make_fused_train_step(tcfg, device_data=True, chunk=2)
    s_chunk, st_chunk = chunk(state, *enc, style, tri, 3, 12,
                              np.random.default_rng(7), draws=draws)

    single = tfused.make_fused_train_step(tcfg, device_data=True)
    host = np.random.default_rng(7)
    s, per = state, []
    for i, (nimg, warm) in enumerate(((12, True), (16, False))):
        crop1, _ = tfused.gen_crops(host, (RES + 8, RES + 8), RES, False)
        beta = float(np.exp2(np.float32(-B) / np.float32(
            min(tcfg.ema_kimg * 1000.0, nimg * 0.05))))
        assert tfused.ema_beta_f32(tcfg, nimg) == pytest.approx(beta,
                                                                rel=1e-7)
        s, st = single(s, *enc, style, tri, 3 + i, warm,
                       tfused.ema_beta_f32(tcfg, nimg), crop1,
                       draws=draws[i], host_rng=host)
        per.append(st)
    assert set(st_chunk) == set(per[0])
    for k, v in st_chunk.items():
        assert v.shape == (2,)
        want = torch.stack([torch.as_tensor(p[k]).float() for p in per])
        assert torch.equal(torch.isnan(v), torch.isnan(want)), k
        assert torch.equal(torch.nan_to_num(v), torch.nan_to_num(want)), k
    # Batch 3 is warm (Ggeom-warm only), batch 4 the main branch with its
    # regularizers.
    assert torch.isfinite(st_chunk["Loss/forger/Ggeom-warm/total"]).tolist() \
        == [True, False]
    assert torch.isfinite(st_chunk["Loss/r1_penalty"]).tolist() == \
        [False, True]
    for a, b in zip(tree_leaves(s_chunk), tree_leaves(s)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    with pytest.raises(ValueError, match="2 draws"):
        chunk(state, *enc, style, tri, 0, 0, np.random.default_rng(0),
              draws=draws[:1])
    with pytest.raises(ValueError, match="device_data"):
        tfused.make_fused_train_step(tcfg, chunk=2)
    # A mesh is one card per rank (tests/test_torch_multirank.py).
    with pytest.raises(ValueError, match="one card per process"):
        tfused.make_fused_train_step(tcfg, mesh=make_mesh(2, device="cpu"))


def test_fetch_stats_keeps_the_last_finite_value():
    nan = float("nan")
    got = _fetch_stats({
        "a": torch.tensor([1.0, 2.0, nan]), "b": torch.tensor([nan, nan]),
        "c": torch.tensor(3.5), "d": torch.tensor(nan), "t": 0.25,
        "e": torch.tensor([nan, 7.0])})
    assert got == {"a": 2.0, "c": 3.5, "t": 0.25, "e": 7.0}
