"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one: a CUDA kernel has
no CPU mode.  The file imports no JAX, so it runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: f32 1e-5 rel and abs (the same f32 math, only the FIR sum's
order differs); bf16 2^-7 relative -- one bf16 ulp, since both sides round
one f32 value once -- plus a 1e-5 abs floor for outputs near 0.  The
FIR-epilogue gradients: 1e-4 of the largest gradient entry (its backward
re-runs the plain chain, so only the forward value it is handed differs).
The two-pass warp: 2e-5 forward (the same f32 weights, the taps summed in
another order), 2e-4 for first and second-order gradients, 1e-4 relative for
the adjoint identity.
"""

import numpy as np
import pytest
import torch

from brushstroke_engine_torch.ops import fir_epilogue as fe
from brushstroke_engine_torch.ops import warp as tw
from brushstroke_engine_torch.ops.conv import modulated_conv2d
from brushstroke_engine_torch.ops.filters import setup_filter
from brushstroke_engine_torch.ops.precision import set_precision_mode
from brushstroke_engine_torch.train import augment as taug

pytestmark = pytest.mark.cuda

F = setup_filter([1, 3, 3, 1])


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    set_precision_mode("strict")


def _inputs(seed, b, h, w, c, noise_batch):
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.randn(b, h + 3, w + 3, c).astype(np.float32))
    d = torch.from_numpy((rng.rand(b, c) * 0.5 + 0.7).astype(np.float32))
    noise = None if noise_batch is None else torch.from_numpy(
        rng.randn(noise_batch, h, w, 1).astype(np.float32))
    bias = torch.from_numpy(rng.randn(c).astype(np.float32))
    return [None if t is None else t.to(dev) for t in (x, d, noise, bias)]


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("shape,noise_batch,clamp", [
    ((3, 24, 20, 40), None, 256.0),
    ((3, 13, 9, 64), 3, None),         # ragged row strip, no clamp
    ((2, 16, 16, 128), 1, 0.5),        # one noise plane for the batch
])
def test_kernel_matches_plain(dtype, out_dtype, shape, noise_batch, clamp):
    x, d, noise, bias = _inputs(0, *shape, noise_batch)
    x = x.to(dtype)
    before = fe.fir4_epilogue.launches
    got = fe.fir4_epilogue(x, F, d, noise, bias, 1.4142, clamp,
                           out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fe.fir4_epilogue.launches == before + 1
    assert got.dtype == out_dtype and got.shape == shape
    want = fe.fir4_epilogue_plain(x, fe.correlation_taps(F), d, noise, bias,
                                  1.4142, clamp, out_dtype=out_dtype)
    rtol = 1e-5 if out_dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5)


def test_kernel_rejects_what_it_does_not_take():
    x, d, noise, bias = _inputs(1, 2, 8, 8, 16, 2)
    with pytest.raises(ValueError):
        fe.fir4_epilogue(x.half(), F, d, noise, bias, 1.0, None)
    with pytest.raises(ValueError):
        fe.fir4_epilogue(x, F, d.double(), noise, bias, 1.0, None)
    with pytest.raises(ValueError):
        fe.fir4_epilogue(x.transpose(1, 2), F, d, noise, bias, 1.0, None)
    with pytest.raises(ValueError):
        fe.fir4_epilogue(x, F, d, noise, bias, 1.0, None,
                         out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fe.fir4_epilogue(x.bfloat16(), F, d, noise, bias, 1.0, None,
                         out_dtype=torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_up2_modulated_conv_cuda_vs_cpu(dtype):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 8, 8, 24).astype(np.float32))
    w = torch.from_numpy(rng.randn(32, 24, 3, 3).astype(np.float32))
    s = torch.from_numpy(rng.randn(2, 24).astype(np.float32) + 1)
    noise = torch.from_numpy(rng.randn(2, 16, 16, 1).astype(np.float32))
    b = torch.from_numpy(rng.randn(32).astype(np.float32))
    kw = dict(up=2, padding=1, resample_filter=F, flip_weight=False,
              activation="lrelu", act_gain=2 ** 0.5, clamp=256.0)
    want = modulated_conv2d(x.to(dtype), w, s, noise=noise, bias=b, **kw)
    before = fe.fir4_epilogue.launches
    got = modulated_conv2d(x.cuda().to(dtype), w.cuda(), s.cuda(),
                           noise=noise.cuda(), bias=b.cuda(), **kw)
    torch.cuda.synchronize()
    assert fe.fir4_epilogue.launches == before + 1
    # f32: a 216-term conv sum reordered by cuDNN; bf16: the conv itself
    # rounds to bf16 on both devices, in different places.
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 \
        else dict(rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(got.float().cpu(), want.float(), **tol)


# ---------------------------------------------------------------------------
# FIR epilogue: gradients through the kernel path
# ---------------------------------------------------------------------------

def _fir_grads(use_kernel, leaves, cot, clamp, second):
    x, d, noise, bias = [t.detach().clone().requires_grad_(True)
                         for t in leaves]
    xin = torch.tanh(x) * 3          # second derivatives w.r.t. x exist
    if use_kernel:
        y = fe.fir4_epilogue(xin, F, d, noise, bias, 1.4142, clamp)
        assert y.grad_fn is not None
    else:
        y = fe.fir4_epilogue_plain(xin, fe.correlation_taps(F), d, noise,
                                   bias, 1.4142, clamp)
    g1 = torch.autograd.grad((y * cot).sum(), [x, d, noise, bias],
                             create_graph=second)
    if not second:
        return g1
    return torch.autograd.grad(sum(g.square().sum() for g in g1),
                               [x, d, noise, bias], allow_unused=True)


@pytest.mark.parametrize("second", [False, True])
@pytest.mark.parametrize("shape,clamp", [((2, 16, 16, 128), 256.0),
                                         ((3, 13, 9, 40), 1.5)])
def test_kernel_gradients_match_plain(shape, clamp, second):
    leaves = _inputs(3, *shape, shape[0])
    cot = torch.from_numpy(np.random.RandomState(4).randn(*shape)
                           .astype(np.float32)).cuda()
    before = fe.fir4_epilogue.launches
    got = _fir_grads(True, leaves, cot, clamp, second)
    assert fe.fir4_epilogue.launches == before + 1
    want = _fir_grads(False, leaves, cot, clamp, second)
    torch.cuda.synchronize()
    for name, a, b in zip(("x", "dcoefs", "noise", "bias"), got, want):
        assert (a is None) == (b is None), name
        if a is None:
            continue
        assert a.abs().max() > 0, name
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), (name, err)


def test_kernel_saves_nothing_under_no_grad():
    x, d, noise, bias = _inputs(5, 2, 8, 8, 16, 2)
    with torch.no_grad():
        y = fe.fir4_epilogue(x.requires_grad_(True), F, d, noise, bias, 1.0,
                             None)
    assert y.grad_fn is None and not y.requires_grad


# ---------------------------------------------------------------------------
# Two-pass warp: W and W^T
# ---------------------------------------------------------------------------

def _warp_case(seed, b, n, c, antialias):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, n, n, c).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.randn(b, n, n, c).astype(np.float32)).cuda()
    cfg = taug.AugmentConfig.from_spec("bg")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draws = taug.draw_augment(cfg, gen, b, (n, n, c), "cuda")
    mat = torch.linalg.inv_ex(taug.geometric_matrix(
        cfg, draws, b, n, n, torch.tensor(1.0, device="cuda"))).inverse
    imgs, sc = taug._twopass_prep(x, mat, antialias)
    return imgs.contiguous(), g, sc.contiguous()


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("b,n,c", [(16, 128, 3), (5, 48, 4)])
def test_warp_kernels_match_plain(b, n, c, antialias):
    x, g, sc = _warp_case(11, b, n, c, antialias)
    n_w, n_t = tw.warp_twopass.launches, tw.warp_twopass_t.launches
    wx, wtg = tw.warp_twopass(x, sc), tw.warp_twopass_t(g, sc)
    torch.cuda.synchronize()
    assert (tw.warp_twopass.launches, tw.warp_twopass_t.launches) == \
        (n_w + 1, n_t + 1)
    torch.testing.assert_close(wx, tw.warp_twopass_plain(x, sc), rtol=2e-5,
                               atol=2e-5)
    torch.testing.assert_close(wtg, tw.warp_twopass_t_plain(g, sc),
                               rtol=2e-4, atol=2e-4)
    lhs, rhs = (wx * g).sum().item(), (x * wtg).sum().item()
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), 1.0)
    # Deterministic: gather form, no atomics.
    assert torch.equal(wtg, tw.warp_twopass_t(g, sc))


def test_warp_kernel_second_order_matches_plain():
    """The Dr1 pattern through the kernel pair: W^T in the first backward,
    W again in the second."""
    x, g, sc = _warp_case(12, 4, 64, 3, True)

    def penalty_grad(fn):
        xr = x.clone().requires_grad_(True)
        logits = (torch.sin(fn(xr)) * g).sum()
        (g1,) = torch.autograd.grad(logits, xr, create_graph=True)
        (g2,) = torch.autograd.grad(g1.square().sum(), xr)
        return g2

    n_w, n_t = tw.warp_twopass.launches, tw.warp_twopass_t.launches
    got = penalty_grad(lambda v: tw.warp_twopass(v, sc))
    assert tw.warp_twopass.launches == n_w + 2       # forward + 2nd backward
    assert tw.warp_twopass_t.launches == n_t + 2     # 1st backward, twice
    want = penalty_grad(lambda v: tw.warp_twopass_plain(v, sc))
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 2e-4 * max(want.abs().max().item(), 1.0), err


def test_warp_kernel_rejects_what_it_does_not_take():
    x, g, sc = _warp_case(13, 2, 16, 3, True)
    with pytest.raises(ValueError):
        tw.warp_twopass(x.double(), sc)
    with pytest.raises(ValueError):
        tw.warp_twopass(x[:, :, :12], sc)
    with pytest.raises(ValueError):
        tw.warp_twopass(x.transpose(1, 2), sc)
    with pytest.raises(ValueError):
        tw.warp_twopass(x, sc.cpu())
    with pytest.raises(ValueError):
        tw.warp_twopass_t(g, sc[:1])
