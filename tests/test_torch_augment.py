"""The port's ADA pipeline against the JAX package, on the CPU, strict f32.

JAX's draws are replayed from its key in ``augment.py``'s order
(``tests/torch_helpers.replay_augment_draws``) and handed to the port, so
both sides build the same transforms.  Tolerance 1e-4 abs/rel on images in
about [-3, 3]: the 3x3 inverse, sin/cos and the warp's f32 sums differ in
rounding between the two frameworks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.ops.precision import set_precision_mode as jset
from brushstroke_engine_tpu.train import augment as jaug
from brushstroke_engine_torch.train import augment as taug
from tests.torch_helpers import replay_augment_draws

SPECS = ["blit", "geom", "color", "noise", "cutout", "bg", "bgc", "filter",
         "bgcf", "bgcfn", "bgcfnc", "bgcn", "bgcnc"]


@pytest.fixture(autouse=True)
def _strict():
    jset("strict")
    yield
    jset("strict")


@pytest.mark.parametrize("spec", SPECS)
def test_from_spec_matches_jax(spec):
    import dataclasses
    assert dataclasses.asdict(taug.AugmentConfig.from_spec(spec)) == \
        dataclasses.asdict(jaug.AugmentConfig.from_spec(spec))


def test_from_spec_rejects_unknown():
    with pytest.raises(ValueError):
        taug.AugmentConfig.from_spec("nope")


@pytest.mark.parametrize("p", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("spec", ["bgc", "bgcfnc"])
def test_augment_pipe_matches_jax(spec, p):
    b, res = 4, 32
    imgs = np.random.RandomState(17).randn(b, res, res, 3).astype(np.float32)
    jcfg = jaug.AugmentConfig.from_spec(spec)
    tcfg = taug.AugmentConfig.from_spec(spec)
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        want = jaug.augment_pipe(jcfg, key, jnp.asarray(imgs),
                                 jnp.float32(p))
        draws = replay_augment_draws(tcfg, key, b, (res, res, 3))
        got = taug.augment_pipe(tcfg, draws, torch.from_numpy(imgs),
                                torch.tensor(p))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=f"seed {seed}")
        if p == 0.0:
            np.testing.assert_allclose(got.numpy(), imgs, atol=1e-5)


def test_draw_augment_covers_the_spec_and_is_seeded():
    cfg = taug.AugmentConfig.from_spec("bgcfnc")
    gen = torch.Generator().manual_seed(3)
    d1 = taug.draw_augment(cfg, gen, 4, (32, 32, 3), "cpu")
    d2 = taug.draw_augment(cfg, torch.Generator().manual_seed(3), 4,
                           (32, 32, 3), "cpu")
    spec = taug.draw_spec(cfg, 4, (32, 32, 3))
    assert list(d1) == [name for name, _, _ in spec]
    for name, kind, shp in spec:
        assert tuple(d1[name].shape) == tuple(shp)
        assert torch.equal(d1[name], d2[name])
        if kind == "uniform":
            assert 0 <= d1[name].min() and d1[name].max() < 1
    out = taug.augment_pipe(cfg, d1, torch.zeros(4, 32, 32, 3) + 0.5,
                            torch.tensor(1.0))
    assert out.shape == (4, 32, 32, 3) and torch.isfinite(out).all()


def test_gradient_flows_to_images_through_the_pipe():
    cfg = taug.AugmentConfig.from_spec("bgc")
    draws = taug.draw_augment(cfg, torch.Generator().manual_seed(5), 2,
                              (32, 32, 3), "cpu")
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(6),
                    requires_grad=True)
    y = taug.augment_pipe(cfg, draws, x, torch.tensor(1.0))
    (g,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    (gg,) = torch.autograd.grad(g.square().sum(), x)
    assert torch.isfinite(gg).all() and gg.abs().max() > 0
