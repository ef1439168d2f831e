"""Shared pieces of the port's training parity tests
(``tests/test_torch_train_*.py``): the small configs of both packages, a
batch, tree flattening and the comparisons with their tolerances (stated in
each test file).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.models import discriminator as jdisc
from brushstroke_engine_tpu.ops.precision import set_precision_mode as jset
from brushstroke_engine_tpu.train import augment as jaug
from brushstroke_engine_tpu.train import state as jstate
from brushstroke_engine_torch.models import discriminator as tdisc
from brushstroke_engine_torch.ops.precision import set_precision_mode as tset
from brushstroke_engine_torch.train import augment as taug
from brushstroke_engine_torch.train import state as tstate
from tests.torch_helpers import small_model

RES, B = 32, 4
STAT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _strict():
    jset("strict")
    tset("strict")
    yield
    jset("strict")
    tset("strict")


def _disc_cfgs(arch="orig", **kw):
    base = dict(c_dim=0, img_resolution=RES, img_channels=3,
                architecture=arch, channel_base=2048, channel_max=32)
    base.update(kw)
    return jdisc.DiscriminatorConfig(**base), \
        tdisc.DiscriminatorConfig(**base)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _flat(tree, prefix=""):
    """{path: float64 array} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    a = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)
    return {prefix: a.astype(np.float64)}




def _train_cfgs(augment=None, **kw):
    m = small_model(seed=3)
    jd, td = _disc_cfgs("orig", **kw.pop("disc", {}))
    common = dict(enc_res=(0, 1), batch_size=B, noise_mode="const",
                  style_mixing_prob=0.0, r1_gamma=10.0,
                  main_phase_losses="0.1*iou_inv(uvs)",
                  geom_phase_mode="last_and_rgb")
    common.update(kw)
    jcfg = jstate.TrainConfig(
        gen_cfg=m["jax_cfg"][0], disc_cfg=jd, enc_cfg=m["jax_cfg"][1],
        augment=None if augment is None
        else jaug.AugmentConfig.from_spec(augment), **common)
    tcfg = tstate.TrainConfig(
        gen_cfg=m["cfg"][0], disc_cfg=td, enc_cfg=m["cfg"][1],
        augment=None if augment is None
        else taug.AugmentConfig.from_spec(augment), **common)
    return m, jcfg, tcfg


def _jax_state(m, jcfg, ada_p=0.0):
    state = jstate.init_train_state(
        jcfg, jax.random.PRNGKey(0), g_params=m["jax"]["gen_params"],
        g_state=m["jax"]["gen_state"])
    state["ada_p"] = jnp.float32(ada_p)
    return state


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    real = rng.randn(B, RES, RES, 3).astype(np.float32)
    geom = (rng.rand(B, RES, RES, 1) > 0.5).astype(np.float32)
    truth = rng.choice([0.0, 0.5, 1.0],
                       size=(B, RES, RES, 1)).astype(np.float32)
    zs = [rng.randn(B, 16).astype(np.float32) for _ in range(4)]
    return real, geom, truth, zs


def _assert_update_parity(before, port_after, jax_after, lr_eff, label):
    fb, fp, fj = _flat(before), _flat(port_after), _flat(jax_after)
    assert set(fb) == set(fp) == set(fj)
    for k in sorted(fb):
        dp, dj = fp[k] - fb[k], fj[k] - fb[k]
        if not np.any(dj):
            assert not np.any(np.abs(dp) > 1e-12), \
                f"{label}:{k} updated a tensor the JAX step froze"
            continue
        diff = np.abs(dp - dj)
        assert diff.mean() < 0.02 * lr_eff, \
            (label, k, float(diff.mean() / lr_eff))
        assert np.mean(diff < 0.1 * lr_eff) > 0.99, \
            (label, k, float(np.mean(diff < 0.1 * lr_eff)))


def _assert_stats(got, want, label):
    assert set(got) == set(want), label
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   err_msg=f"{label}:{k}", **STAT_TOL)


def _assert_tree_close(got, want, label, tol=2e-5):
    fg, fw = _flat(got), _flat(want)
    assert set(fg) == set(fw)
    for k in fw:
        np.testing.assert_allclose(fg[k], fw[k], rtol=0, atol=tol,
                                   err_msg=f"{label}:{k}")
