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


# ---------------------------------------------------------------------------
# W^T's source walk (the CUDA kernel's enumeration, mirrored in Python)
# ---------------------------------------------------------------------------

STRESS = {
    "quarter": [[0, -1, 0.0], [1, 0, 0.0]],
    "translate_far": [[1, 0, 13.25], [0, 1, -40.5]],
    "flip_x": [[-1, 0, 0.5], [0, 1, 0.0]],
    "flip_y": [[1, 0, 0.0], [0, -1, -0.25]],
    "zoom_out": [[4.3, 0.2, 1.0], [-0.3, 3.1, 2.0]],
    "zoom_in": [[0.3, 0.05, -2.0], [0.02, 0.22, 3.0]],
    "shear_flat": [[0.81 + 1e-5, 0.9, 0.0], [0.9, 1.0, 0.0]],
    "rotate_far": [[0.8, -0.6, 300.0], [0.6, 0.8, -500.0]],
}


def _walk_covers(scalars, n, lines):
    """For each pass, line in ``lines`` and output tap: the intervals are
    ascending, disjoint and inside [0, n-1], and every source with a non-zero
    dense weight lies in one.  Returns the mean number of sources visited."""
    w1, w2 = tw.dense_weights(torch.tensor([scalars], dtype=torch.float32), n)
    w1, w2 = w1[0].numpy(), w2[0].numpy()      # w1[r, j, k], w2[i, j, r]
    a1, b1, c1, s1, d2, e2, c2, s2 = (
        float(v) for v in np.asarray(scalars, np.float32))
    visited = 0
    for line in lines:
        for tap in range(n):
            for vertical in (False, True):
                if vertical:
                    got = tw.source_intervals(e2, d2, line, c2, s2, tap, n)
                    nonzero = np.nonzero(w2[:, line, tap])[0]
                else:
                    got = tw.source_intervals(a1, b1, line, c1, s1, tap, n)
                    nonzero = np.nonzero(w1[line, :, tap])[0]
                mask = np.zeros(n, bool)
                prev = -1
                for lo, hi in got:
                    assert prev < lo <= hi <= n - 1, (got, scalars)
                    mask[lo:hi + 1] = True
                    prev = hi
                assert mask[nonzero].all(), (scalars, line, tap, vertical,
                                             got, nonzero)
                visited += int(mask.sum())
    return visited / (len(lines) * n * 2)


def _some_lines(n):
    return range(n) if n <= 16 else sorted({0, 1, n // 3, n // 2, n - 2,
                                            n - 1})


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("n", [8, 67, 128])
@pytest.mark.parametrize("kind", KINDS + tuple(STRESS))
def test_source_walk_covers_dense_weights(kind, n, antialias):
    mat = _mats((kind,)) if kind in KINDS else np.array(
        [STRESS[kind] + [[0, 0, 1.0]]], np.float32)
    _, sc = taug._twopass_prep(torch.zeros(1, n, n, 1),
                               torch.from_numpy(mat), antialias)
    visited = _walk_covers(sc[0].tolist(), n, _some_lines(n))
    # The walk pays: away from flat slopes it visits a few sources per tap.
    if kind in ("identity", "translate", "rotate", "flip_x") and n == 128:
        assert visited < 12, visited


@pytest.mark.parametrize("a1,e2", [(0.0, 1e-6), (1e-7, -1e-6), (-3e-3, 2e-3),
                                   (1.0, 1e-6), (40.0, -35.0), (1e6, 1e5)])
def test_source_walk_flat_and_steep_slopes(a1, e2):
    """Slopes no matrix reaches through the prep: exactly 0, next to 0 (the
    dense line), and so steep that the targets outnumber the sources."""
    for n in (8, 67):
        for antialias in (True, False):
            s1 = max(abs(a1), 1.0) if antialias else 1.0
            s2 = max(abs(e2), 1.0) if antialias else 1.0
            _walk_covers([a1, 0.37, 5.5 - n, s1, -0.21, e2, 2.0 * n, s2], n,
                         _some_lines(n))


def test_source_walk_covers_dense_weights_hypothesis():
    from hypothesis import given, settings, strategies as st

    slope = st.one_of(st.floats(-6, 6, width=32),
                      st.sampled_from([0.0, 1e-7, -1e-7, 1.0, -1.0]))
    cross = st.floats(-3, 3, width=32)
    offset = st.floats(-600, 600, width=32)

    @settings(max_examples=40, deadline=None, derandomize=True,
              database=None)
    @given(a1=slope, b1=cross, c1=offset, d2=cross, e2=slope, c2=offset,
           n=st.sampled_from([8, 67, 128]), antialias=st.booleans(),
           line=st.integers(0, 127))
    def run(a1, b1, c1, d2, e2, c2, n, antialias, line):
        if abs(e2) < 1e-6:                     # the prep's floor on e
            e2 = 1e-6
        s1 = max(abs(a1), 1.0) if antialias else 1.0
        s2 = max(abs(e2), 1.0) if antialias else 1.0
        _walk_covers([a1, b1, c1, s1, d2, e2, c2, s2], n,
                     sorted({line % n, n - 1}))

    run()


def _transpose_tabled(g, scalars):
    """``W^T`` the way the kernel computes it, in torch and Python loops
    (small shapes only): per source pixel the reflected centre
    and ``1 / normaliser`` once, then per output tap a gather over
    ``source_intervals`` in ascending source order."""
    b, n, _, ch = g.shape
    sc = scalars.float()
    grid = torch.arange(n, dtype=torch.float32)
    rows, cols = grid[:, None], grid[None, :]
    out = torch.zeros_like(g, dtype=torch.float32)

    def one_pass(src, p, q, c, s, vertical):
        ctr = tw._reflect((p * rows + q * cols) + c, n)            # [row, col]
        tri_all = torch.clamp_min(
            1.0 - (grid - ctr[..., None]).abs() * (1.0 / s), 0.0)
        inv = 1.0 / torch.clamp_min(tri_all.sum(-1), 1e-8)
        dst = torch.zeros_like(src)
        slope, coef = (p, q) if vertical else (q, p)
        for line in range(n):
            for tap in range(n):
                acc = torch.zeros(ch)
                for lo, hi in tw.source_intervals(float(slope), float(coef),
                                               line, float(c), float(s), tap,
                                               n):
                    for m in range(lo, hi + 1):
                        r, j = (m, line) if vertical else (line, m)
                        w = max(0.0, 1.0 - abs(tap - float(ctr[r, j]))
                                * float(1.0 / s))
                        if w > 0.0:
                            acc = acc + (w * inv[r, j]) * src[r, j]
                if vertical:
                    dst[tap, line] = acc
                else:
                    dst[line, tap] = acc
        return dst

    for i in range(b):
        a1, b1, c1, s1, d2, e2, c2, s2 = sc[i]
        i1b = one_pass(g[i].float(), e2, d2, c2, s2, True)
        out[i] = one_pass(i1b, b1, a1, c1, s1, False)
    return out


@pytest.mark.parametrize("antialias", [True, False])
def test_tabled_transpose_matches_plain(antialias):
    """The kernel's algorithm in torch (per-source centre and 1/normaliser
    once, then the gather over the walk) equals ``warp_twopass_t_plain``
    within 2e-6: the reciprocal normaliser and the order of the tap sums
    are all that differ."""
    n = 12
    kinds = ("rotate", "scale", "near90", "translate")
    mats = np.concatenate([_mats(kinds), np.array(
        [STRESS[k] + [[0, 0, 1.0]] for k in ("zoom_out", "flip_x")],
        np.float32)])
    g = torch.from_numpy(_images(20, len(mats), n, 2))
    _, sc = taug._twopass_prep(g, torch.from_numpy(mats), antialias)
    torch.testing.assert_close(_transpose_tabled(g, sc),
                               tw.warp_twopass_t_plain(g, sc), rtol=0,
                               atol=2e-6)


# ---------------------------------------------------------------------------
# W's fused schedule (the CUDA kernel's order of work, mirrored in torch)
# ---------------------------------------------------------------------------

def _forward_banded(imgs, scalars, band):
    """``W`` the way the fused kernel computes it, in torch (small shapes
    only): for each band of ``band`` output columns (the last one may be
    ragged), pass 1 fills the band's ``i1`` for every row from ``x``, then
    pass 2 gathers its taps from that band alone.  Per pixel: the kernel's
    tap range ``[max(0, ceil(ctr - s)), min(n - 1, floor(ctr + s))]``, the
    taps and their weight sum accumulated in ascending order, and one
    reciprocal normaliser."""
    b, n, _, ch = imgs.shape
    x = imgs.float()
    grid = torch.arange(n, dtype=torch.float32)
    rows, r_idx = grid[:, None], torch.arange(n)[:, None]
    out = torch.empty_like(x)

    def gather(ctr, s, fetch):
        """``ctr [R, J]``; ``fetch(t)``: the ``[R, J, ch]`` values at tap
        indices ``t [R, J]``."""
        lo = torch.clamp_min(torch.ceil(ctr - s), 0.0).long()
        hi = torch.clamp_max(torch.floor(ctr + s), n - 1.0).long()
        inv = 1.0 / s
        acc = torch.zeros(ctr.shape + (ch,))
        total = torch.zeros(ctr.shape)
        for k in range(int((hi - lo).max()) + 1):
            t = lo + k
            w = torch.where(t <= hi, torch.clamp_min(
                1.0 - (t.float() - ctr).abs() * inv, 0.0), 0.0)
            total = total + w
            acc = acc + w[..., None] * fetch(torch.clamp_max(t, n - 1))
        return acc * (1.0 / torch.clamp_min(total, 1e-8))[..., None]

    for i in range(b):
        a1, b1, c1, s1, d2, e2, c2, s2 = scalars[i].float()
        for j0 in range(0, n, band):
            cols = grid[None, j0:j0 + band]
            j_idx = torch.arange(cols.shape[1])[None, :]
            ctr1 = tw._reflect((b1 * rows + a1 * cols) + c1, n)     # [R, J]
            i1 = gather(ctr1, s1, lambda t: x[i][r_idx, t])
            ctr2 = tw._reflect((e2 * rows + d2 * cols) + c2, n)     # [I, J]
            out[i, :, j0:j0 + band] = gather(ctr2, s2,
                                             lambda t: i1[t, j_idx])
    return out


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("band", [1, 5, 16, 13])
@pytest.mark.parametrize("kind", KINDS + tuple(STRESS))
def test_banded_forward_matches_plain_and_jax(kind, band, antialias):
    """The fused kernel's schedule in torch at N = 13 (band 5 leaves a
    ragged last band, 16 one band wider than the image, 13 the whole image)
    equals ``warp_twopass_plain`` within 2e-6 -- the reciprocal normaliser
    and the order of the tap sums are all that differ -- and the JAX
    package's two-pass warp within 2e-5."""
    n = 13
    mat = _mats((kind, kind)) if kind in KINDS else np.array(
        [STRESS[kind] + [[0, 0, 1.0]]] * 2, np.float32)
    mat[1, 0, 2] += 1.25                       # two different samples
    imgs = _images(30, 2, n)
    t_imgs, sc = taug._twopass_prep(torch.from_numpy(imgs),
                                    torch.from_numpy(mat), antialias)
    got = _forward_banded(t_imgs, sc, band)
    torch.testing.assert_close(got, tw.warp_twopass_plain(t_imgs, sc),
                               rtol=0, atol=2e-6)
    want = jaug._affine_warp_twopass(jnp.asarray(imgs), jnp.asarray(mat),
                                     antialias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
