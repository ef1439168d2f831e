"""The port's training phases against the JAX package, on the CPU, strict
f32: one full Dmain -> Dr1 -> Gmain -> Gpl -> Ggeom cycle with ADA ('bgc'),
the warm-start step and the ADA p update (the cycle without ADA and the
``batch_gpu`` rounds are in ``tests/test_torch_train_phases.py``).

Small shapes: 32 px, B = 4, <= 32 channels, ``noise_mode="const"``, style
mixing 0, explicit path-length noise, so both packages consume the same
numbers.  Where the JAX step draws from its key (ADA, path-length noise) the
test replays the key's splits and hands the port the same draws.

Tolerances:
  * phase stats 1e-4 relative (+1e-5 abs), ``pl_mean`` 1e-4 relative;
  * parameter updates by the method of ``tests/test_reference_parity.py``:
    with beta1 = 0 one Adam step is ~lr * sign(g), so per tensor the mean
    |delta_port - delta_jax| must stay under 2 % of the step size and 99 % of
    the entries under 10 %; a tensor one side freezes must be exactly
    untouched on the other.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.train import steps as jsteps
from brushstroke_engine_torch.train import steps as tsteps
from brushstroke_engine_torch.utils.checkpoint import (
    params_from_jax, train_state_from_jax,
)
from tests.torch_train_helpers import (  # noqa: F401 (_strict: autouse)
    _strict, B, _np_tree, _train_cfgs, _jax_state, _batch,
    _assert_update_parity, _assert_stats, full_phase_cycle,
)


# ---------------------------------------------------------------------------
# One full phase cycle through both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("augment", ["bgc"])
def test_full_phase_cycle_matches_jax(augment):
    """Dmain -> Dr1 -> Gmain -> Gpl -> Ggeom through both packages
    (``torch_train_helpers.full_phase_cycle``)."""
    full_phase_cycle(augment)


def test_warm_step_with_frozen_original_matches_jax():
    """Ggeom-warm with a fake_orig loss: the frozen original generator runs
    without style mixing, and its image is a constant of the loss."""
    m, jcfg, tcfg = _train_cfgs(
        geom_warmstart_losses="0.5*iou_inv(uvs)+2.0*l1(fake_orig)",
        geom_warmstart_mode="all")
    real, geom, truth, zs = _batch(8)
    jst = _jax_state(m, jcfg)
    g_orig_np = jax.tree_util.tree_map(
        lambda a: np.array(a) * np.float32(1.01), m["np"]["gen_params"])
    jfeats = jsteps.encode_geometry(jcfg, m["jax"]["enc_params"],
                                    m["jax"]["enc_state"], jnp.asarray(geom))
    tfeats = tsteps.encode_geometry(tcfg, m["torch"]["enc_params"],
                                    m["torch"]["enc_state"],
                                    torch.from_numpy(geom))
    tst = train_state_from_jax(_np_tree(jst), device="cpu")
    before = _np_tree(jst["g_params"])
    tstep = tsteps.make_geom_step(tcfg, warmstart=True)
    with pytest.raises(ValueError, match="g_orig_params"):
        tstep(tst, tfeats, torch.from_numpy(truth), torch.from_numpy(zs[0]))
    tst2, ts = tstep(tst, tfeats, torch.from_numpy(truth),
                     torch.from_numpy(zs[0]), ema_beta=0.9,
                     g_orig_params=params_from_jax(g_orig_np))
    jst, js = jsteps.make_geom_step(jcfg, warmstart=True)(
        jst, jfeats, jnp.asarray(truth), jnp.asarray(zs[0]),
        jax.random.PRNGKey(3), jnp.float32(0.9),
        g_orig_params=jax.tree_util.tree_map(jnp.asarray, g_orig_np))
    _assert_stats(ts, js, "Ggeom-warm")
    assert float(ts["Loss/forger/Ggeom-warm/l1_fake_orig"]) > 0
    _assert_update_parity(params_from_jax(before), tst2["g_params"],
                          params_from_jax(_np_tree(jst["g_params"])), 2e-4,
                          "Ggeom-warm")


def test_ada_update_matches_jax():
    m, jcfg, tcfg = _train_cfgs("bgc")
    for signs, count, p0 in [(3.0, 4.0, 0.0), (-2.0, 8.0, 0.001),
                             (0.0, 0.0, 0.0), (-4.0, 4.0, 0.0)]:
        jst = dict(_jax_state(m, jcfg, p0), ada_signs=jnp.float32(signs),
                   ada_count=jnp.float32(count))
        tst = {"ada_p": torch.tensor(p0), "ada_signs": torch.tensor(signs),
               "ada_count": torch.tensor(count)}
        want = jsteps.ada_update(jcfg, jst, np.float32(B * 4))
        got = tsteps.ada_update(tcfg, tst, float(B * 4))
        np.testing.assert_allclose(float(got["ada_p"]), float(want["ada_p"]),
                                   rtol=1e-6, atol=1e-9)
        assert float(got["ada_p"]) >= 0
        assert float(got["ada_signs"]) == 0 and float(got["ada_count"]) == 0
