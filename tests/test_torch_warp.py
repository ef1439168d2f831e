"""The port's two-pass ADA warp against the JAX package, on the CPU.

JAX side in strict f32.  The port's plain version (dense weights, two
einsums) is held against the JAX XLA two-pass form for the five transform
classes of ``tests/test_pallas_warp.py``, and against the Pallas kernel in
interpret mode for one case each.  Tolerances as in that file: value 2e-5
(the same f32 weights, sums in another order), first gradient 2e-4, the
second-order penalty gradient 2e-4 relative to its largest entry.

The ``WarpTwoPass`` / ``WarpTwoPassT`` pair runs its CPU path here (the CUDA
kernels are checked on the card): adjoint identity, gradcheck in f64-free
form (directional derivatives of a linear map), double backward.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from brushstroke_engine_tpu.ops import pallas_warp as pw
from brushstroke_engine_tpu.ops.precision import set_precision_mode as jset
from brushstroke_engine_tpu.train import augment as jaug
from brushstroke_engine_torch.ops import warp as tw
from brushstroke_engine_torch.train import augment as taug

KINDS = ("identity", "translate", "scale", "rotate", "near90")


def _mats(kinds):
    ms = []
    for kind in kinds:
        m = np.eye(3)
        if kind == "translate":
            m[0, 2], m[1, 2] = 7.35, -3.6
        elif kind == "scale":
            m = np.diag([1.7, 0.55, 1.0])
        elif kind in ("rotate", "near90"):
            t, tx, ty = (0.5, 2.0, -1.0) if kind == "rotate" else \
                (np.pi / 2 - 0.07, 0.5, 0.0)
            m = np.array([[np.cos(t), -np.sin(t), tx],
                          [np.sin(t), np.cos(t), ty], [0, 0, 1.0]])
        elif kind != "identity":
            raise ValueError(kind)
        ms.append(m)
    return np.stack(ms).astype(np.float32)


def _images(seed, b, w=32, c=3):
    return np.random.RandomState(seed).randn(b, w, w, c).astype(np.float32)


@pytest.fixture(autouse=True)
def _strict():
    jset("strict")
    yield
    jset("strict")


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_prep_and_plain_match_jax(kind, antialias):
    imgs, mat = _images(0, 2), _mats((kind, kind))
    mat[1, 0, 2] += 1.25                       # two different samples
    j_imgs, j_sc = jaug._twopass_prep(jnp.asarray(imgs), jnp.asarray(mat),
                                      antialias)
    t_imgs, t_sc = taug._twopass_prep(torch.from_numpy(imgs),
                                      torch.from_numpy(mat), antialias)
    np.testing.assert_array_equal(t_imgs.numpy(), np.asarray(j_imgs))
    np.testing.assert_allclose(t_sc.numpy(), np.asarray(j_sc), rtol=1e-6,
                               atol=1e-6)
    want = jaug._affine_warp_twopass(jnp.asarray(imgs), jnp.asarray(mat),
                                     antialias)
    got = taug._affine_warp_twopass(torch.from_numpy(imgs),
                                    torch.from_numpy(mat), antialias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # The entry point takes the same (plain) path for a CPU tensor.
    got2 = tw.affine_warp_twopass(torch.from_numpy(imgs),
                                  torch.from_numpy(mat), antialias)
    assert torch.equal(got, got2)


def test_plain_matches_pallas_kernel_in_interpret_mode():
    """One case against the TPU kernel itself (128 px: its eligibility
    floor), forward and gradient."""
    imgs, mat = _images(1, 2, 128), _mats(("rotate", "scale"))
    cot = _images(2, 2, 128)
    with pltpu.force_tpu_interpret_mode():
        want = pw.affine_warp_twopass_pallas(jnp.asarray(imgs),
                                             jnp.asarray(mat))
        want_g = jax.grad(lambda x: jnp.sum(pw.affine_warp_twopass_pallas(
            x, jnp.asarray(mat)) * cot))(jnp.asarray(imgs))
    x = torch.from_numpy(imgs).requires_grad_(True)
    got = tw.affine_warp_twopass(x, torch.from_numpy(mat))
    (got_g,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("kinds", [("rotate", "scale"),
                                   ("near90", "translate")])
def test_gradient_matches_jax(kinds):
    imgs, mat, cot = _images(3, 2), _mats(kinds), _images(4, 2)
    want = jax.grad(lambda x: jnp.sum(jaug._affine_warp_twopass(
        x, jnp.asarray(mat)) * cot))(jnp.asarray(imgs))
    x = torch.from_numpy(imgs).requires_grad_(True)
    out = tw.affine_warp_twopass(x, torch.from_numpy(mat))
    (got,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_second_order_grad_matches_jax():
    """The Dr1 pattern: differentiate THROUGH the warp's backward pass."""
    imgs, mat = _images(5, 2), _mats(("rotate", "scale"))
    wvec = np.random.RandomState(6).randn(3).astype(np.float32)

    def j_penalty(x):
        g = jax.grad(lambda xx: jnp.sum(jnp.sin(jaug._affine_warp_twopass(
            xx, jnp.asarray(mat))) * wvec))(x)
        return jnp.sum(g * g)

    want = np.asarray(jax.grad(j_penalty)(jnp.asarray(imgs)))

    x = torch.from_numpy(imgs).requires_grad_(True)
    logits = (torch.sin(tw.affine_warp_twopass(x, torch.from_numpy(mat)))
              * torch.from_numpy(wvec)).sum()
    (g,) = torch.autograd.grad(logits, x, create_graph=True)
    (got,) = torch.autograd.grad((g * g).sum(), x)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-4 * max(scale, 1.0))


@pytest.mark.parametrize("antialias", [True, False])
def test_function_pair_adjoint_and_transpose_plain(antialias):
    """<W x, g> = <x, W^T g>, and W^T's plain form is the autograd
    transpose of W's (1e-4 relative: two f32 sums of 3072 terms)."""
    imgs, mat = _images(7, 5), _mats(KINDS)
    g = torch.from_numpy(_images(8, 5))
    x = torch.from_numpy(imgs)
    _, sc = taug._twopass_prep(x, torch.from_numpy(mat), antialias)
    wx = tw.warp_twopass(x, sc)
    wtg = tw.warp_twopass_t(g, sc)
    lhs, rhs = (wx * g).sum().item(), (x * wtg).sum().item()
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), 1.0)
    xr = x.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad((tw.warp_twopass_plain(xr, sc) * g).sum(),
                                  xr)
    torch.testing.assert_close(wtg, auto, rtol=1e-5, atol=1e-5)


def test_function_pair_double_backward():
    """Each Function is the other's backward, to any order: the gradient of
    a quadratic in W^T g w.r.t. g equals 2 W W^T g, through two levels."""
    x = torch.from_numpy(_images(9, 2)).requires_grad_(True)
    _, sc = taug._twopass_prep(x.detach(),
                               torch.from_numpy(_mats(("rotate", "scale"))))
    y = tw.warp_twopass(x, sc)
    (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    assert gx.requires_grad                    # W^T(2 W x), differentiable
    (ggx,) = torch.autograd.grad(gx.square().sum(), x)
    # d/dx |2 W^T W x|^2 = 8 (W^T W)^2 x, with the plain forms:
    with torch.no_grad():
        def wtw(v):
            return tw.warp_twopass_t_plain(tw.warp_twopass_plain(v, sc), sc)
        want = 8 * wtw(wtw(x))
    torch.testing.assert_close(ggx, want, rtol=1e-4, atol=1e-4)
    # gradcheck-style: the pair has no gradient for the scalar pack.
    sc_r = sc.clone().requires_grad_(True)
    out = tw.warp_twopass(x, sc_r)
    gx2, gsc = torch.autograd.grad(out.sum(), (x, sc_r), allow_unused=True)
    assert gsc is None and gx2 is not None


def test_warp_eligible_and_gather_dispatch():
    x = torch.zeros(1, 8, 8, 3)
    assert tw.warp_eligible(x)
    assert not tw.warp_eligible(torch.zeros(1, 8, 6, 3))
    assert not tw.warp_eligible(x.double())
    assert not tw.warp_eligible(x.transpose(1, 2).transpose(1, 2)[:, ::2])
    # Non-square input takes the gather form in both packages.
    imgs = _images(10, 2, 16)[:, :12]
    mat = _mats(("rotate", "translate"))
    want = jaug._affine_warp(jnp.asarray(imgs), jnp.asarray(mat))
    got = taug._affine_warp(torch.from_numpy(imgs), torch.from_numpy(mat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
