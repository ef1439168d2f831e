"""The port's training phases against the JAX package, on the CPU, strict
f32: one full Dmain -> Dr1 -> Gmain -> Gpl -> Ggeom cycle without ADA and the
``batch_gpu`` rounds (the cycle with ADA, the warm-start step and the ADA p
update are in ``tests/test_torch_train_phases_ada.py``).

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

import dataclasses

import numpy as np
import pytest
import torch

from brushstroke_engine_torch.train import state as tstate
from brushstroke_engine_torch.train import steps as tsteps
from tests.torch_train_helpers import (  # noqa: F401 (_strict: autouse)
    _strict, B, _train_cfgs, _batch, _assert_update_parity,
    full_phase_cycle,
)


# ---------------------------------------------------------------------------
# One full phase cycle through both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("augment", [None])
def test_full_phase_cycle_matches_jax(augment):
    """Dmain -> Dr1 -> Gmain -> Gpl -> Ggeom through both packages
    (``torch_train_helpers.full_phase_cycle``)."""
    full_phase_cycle(augment)


@pytest.mark.parametrize("phase", ["Dmain", "Dr1", "Gmain"])
def test_batch_gpu_rounds_give_the_one_round_update(phase):
    """``batch_gpu=2`` (two accumulation rounds) against one round of 4.
    Minibatch-stddev is off: it couples the samples of a round, so with it
    the two are different functions.  Stats to 1e-5; the mean gradients
    agree to f32 rounding, so the Adam updates agree by the update-parity
    bounds."""
    disc = dict(mbstd_num_channels=0)
    m, _, cfg1 = _train_cfgs(disc=disc)
    _, _, cfg2 = _train_cfgs(disc=disc, batch_gpu=2)
    real, geom, truth, zs = _batch(9)
    state = tstate.init_train_state(
        cfg1, seed=2, g_params=m["torch"]["gen_params"],
        g_state=m["torch"]["gen_state"], device="cpu")
    feats = tsteps.encode_geometry(cfg1, m["torch"]["enc_params"],
                                   m["torch"]["enc_state"],
                                   torch.from_numpy(geom))
    t_real, t_truth = torch.from_numpy(real), torch.from_numpy(truth)
    z = torch.from_numpy(zs[0])

    def run(cfg):
        if phase == "Dmain":
            return tsteps.d_main_step(cfg, state, t_real, feats, z) + \
                ("d_params", 2e-4 * 16 / 17)
        if phase == "Dr1":
            return tsteps.d_reg_step(cfg, state, t_real) + \
                ("d_params", 2e-4 * 16 / 17)
        return tsteps.g_main_step(cfg, state, feats, t_truth, z,
                                  ema_beta=0.5) + ("g_params", 2e-4 * 4 / 5)

    s1, stats1, which, lr = run(cfg1)
    s2, stats2, _, _ = run(cfg2)
    assert tsteps._num_rounds(cfg2, B) == 2 and tsteps._num_rounds(cfg1, B) == 1
    for k in stats1:
        np.testing.assert_allclose(float(stats2[k]), float(stats1[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    _assert_update_parity(state[which], s2[which], s1[which], lr, phase)
    with pytest.raises(ValueError, match="divisible"):
        tsteps._num_rounds(dataclasses.replace(cfg1, batch_gpu=3), B)
