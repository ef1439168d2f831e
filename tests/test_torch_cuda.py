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
the adjoint identity.  Then the card against the CPU where the render picks
texels (the wrapped noise: 1e-6, the same IEEE operations) and the batched
serving paths against serial replays (uint8 within 1 LSB); the model
variants of reference checkpoints against the CPU (1e-4), a converted
reference snapshot (bit-equal parameters, 1 LSB) and autoencoder steps
(losses within 1e-4 relative); a Gstitch step against the CPU (1e-4), W and
W^T at Gstitch's batch of 128, and PPL's distances (1e-3 plus the f32 floor
of LPIPS) and precision / recall (equal) against the CPU; a parallel
projection step with per-row noise against the CPU (1e-4 relative plus
Adam's lr bound).
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [(0, 0), (1, 1), (1, 3), (2, 1), (2, 8)])
@pytest.mark.parametrize("shape", [
    (2, 13, 9, 20),      # C a multiple of 4, not of 8; H != W; ragged strips
    (3, 5, 7, 5),        # C a multiple of neither: the scalar instantiation
    (2, 6, 3, 24),       # W narrower than two columns plus the window
    (1, 1, 1, 8),        # one pixel
    (2, 37, 66, 64),     # the vector path with ragged strips and columns
])
def test_kernel_off_vector_path_and_forced_tiles(shape, tile, dtype):
    """Every instantiation (16-byte and scalar, one and two columns per
    thread) and strips that do not divide H, against the plain version."""
    x, d, noise, bias = _inputs(6, *shape, shape[0])
    x = x.to(dtype)
    taps = fe.cached_taps(F)
    got = fe._launch_kernel(x, taps, d, noise, bias, 1.4142, 256.0, 0.2,
                            dtype, tile=tile)
    torch.cuda.synchronize()
    want = fe.fir4_epilogue_plain(x, taps, d, noise, bias, 1.4142, 256.0,
                                  out_dtype=dtype)
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5)


def test_kernel_takes_an_unaligned_view():
    """A pointer off the 16-byte grid takes the scalar instantiation inside
    the kernel; it neither raises nor goes to the plain version."""
    x, d, noise, bias = _inputs(7, 2, 8, 8, 16, 2)
    flat = torch.empty(x.numel() + 1, device="cuda")
    xu = flat[1:].view(x.shape).copy_(x)
    assert xu.data_ptr() % 16 != 0 and xu.is_contiguous()
    before = fe.fir4_epilogue.launches
    got = fe.fir4_epilogue(xu, F, d, noise, bias, 1.0, None)
    torch.cuda.synchronize()
    assert fe.fir4_epilogue.launches == before + 1
    want = fe.fir4_epilogue_plain(x, fe.cached_taps(F), d, noise, bias, 1.0,
                                  None)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


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


# Inverse affines that stress W^T's source walk (as in chip_smoke.py).
_STRESS = {
    "quarter": [[0, -1, 0.0], [1, 0, 0.0]],
    "translate": [[1, 0, 13.25], [0, 1, -40.5]],
    "flip_x": [[-1, 0, 0.5], [0, 1, 0.0]],
    "flip_y": [[1, 0, 0.0], [0, -1, -0.25]],
    "zoom_out": [[4.3, 0.2, 1.0], [-0.3, 3.1, 2.0]],
    "zoom_in": [[0.3, 0.05, -2.0], [0.02, 0.22, 3.0]],
    "shear_flat": [[0.81 + 1e-5, 0.9, 0.0], [0.9, 1.0, 0.0]],
    "rotate_far": [[0.8, -0.6, 300.0], [0.6, 0.8, -500.0]],
}


def _stress_case(seed, n, c, antialias, flat):
    """Images, a cotangent and the scalar packs of the stress matrices; with
    ``flat`` pass slopes of exactly 0 and next to 0 written into the pack."""
    rng = np.random.RandomState(seed)
    mats = torch.from_numpy(np.stack([
        np.array(m + [[0, 0, 1.0]], np.float32) for m in _STRESS.values()
    ])).cuda()
    b = len(_STRESS)
    x = torch.from_numpy(rng.randn(b, n, n, c).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.randn(b, n, n, c).astype(np.float32)).cuda()
    imgs, sc = taug._twopass_prep(x, mats, antialias)
    imgs, sc = imgs.contiguous(), sc.contiguous()
    if flat:
        sc[:, 0] = torch.tensor([0.0, 1e-7, -1e-7, 3e-3, 0.0, 1e-7, -3e-3,
                                 0.0]).cuda()
        sc[:, 5] = torch.tensor([1e-6, -1e-6, 2e-3, 1e-6, -2e-3, 1.0, 1e-6,
                                 -1.0]).cuda()
        if antialias:
            sc[:, 3], sc[:, 7] = 1.0, 1.0
    return imgs, g, sc


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("n,c", [(67, 5), (128, 3), (8, 1), (40, 11)])
def test_warp_transpose_source_walk_under_stress(n, c, antialias, flat):
    """W^T where its interval walk is hardest: a quarter turn, a far
    translation, flips, a strong zoom-out and zoom-in, a near-singular
    shear; with ``flat`` pass slopes of exactly 0 and next to 0 written into
    the scalar pack.  N = 67 and 40 are no multiple of the tile, C = 11
    takes two channel chunks."""
    imgs, g, sc = _stress_case(14, n, c, antialias, flat)
    wtg = tw.warp_twopass_t(g, sc)
    torch.cuda.synchronize()
    torch.testing.assert_close(wtg, tw.warp_twopass_t_plain(g, sc),
                               rtol=2e-4, atol=2e-4)
    assert torch.equal(wtg, tw.warp_twopass_t(g, sc))
    wx = tw.warp_twopass(imgs, sc)
    lhs, rhs = (wx * g).sum().item(), (imgs * wtg).sum().item()
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("band", [0, 1, 5, 16, 128])
@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("n,c", [(67, 5), (128, 3), (8, 1), (33, 11)])
def test_warp_forward_bands_under_stress(n, c, antialias, flat, band):
    """The fused W on the stress matrices and flat slopes, with the kernel's
    own band (0) and every forced one: 5 and 16 leave a ragged last band at
    N = 67 and 33, 128 is one band (wider than N below 128), C = 11 takes
    two channel chunks.  Two calls give equal bits."""
    imgs, _, sc = _stress_case(16, n, c, antialias, flat)
    before = tw.warp_twopass.launches
    wx = tw._launch(imgs, sc, False, band=band)
    torch.cuda.synchronize()
    assert tw.warp_twopass.launches == before + 1
    torch.testing.assert_close(wx, tw.warp_twopass_plain(imgs, sc),
                               rtol=2e-5, atol=2e-5)
    assert torch.equal(wx, tw._launch(imgs, sc, False, band=band))


def test_warp_forward_deterministic_and_size_limit():
    """W gives equal bits on every call at the trainer's shape; where not
    even one column of its intermediate fits in shared memory (N = 7300 at
    C = 8: 233,600 bytes) the launch raises and the band query says 0."""
    x, _, sc = _warp_case(17, 64, 128, 3, True)
    first = tw.warp_twopass(x, sc)
    for _ in range(3):
        assert torch.equal(first, tw.warp_twopass(x, sc))
    assert tw.warp_band(64, 128, 3) > 0
    assert tw.warp_band(1, 7300, 8) == 0
    big = torch.zeros((1, 7300, 7300, 8), device="cuda")
    with pytest.raises(RuntimeError):
        tw.warp_twopass(big, sc[:1].contiguous())


def test_warp_transpose_large_n_tiles():
    """N so large that W^T's shared-memory tile holds fewer than its usual
    eight lines: N = 600 (four lines) against the plain version; N = 3000
    (one line, above the 48 KB that needs no opt-in), where the dense
    weights of the plain version no longer fit, by the adjoint identity
    with W on four probes."""
    rng = np.random.RandomState(15)
    th = 0.3
    mat = torch.tensor([[[1.3 * np.cos(th), -np.sin(th), 4.5],
                         [np.sin(th), 0.8 * np.cos(th), -7.25],
                         [0, 0, 1.0]]], dtype=torch.float32).cuda()
    n = 600
    g = torch.from_numpy(rng.randn(1, n, n, 3).astype(np.float32)).cuda()
    _, sc = taug._twopass_prep(g, mat, True)
    sc = sc.contiguous()
    wtg = tw.warp_twopass_t(g, sc)
    torch.cuda.synchronize()
    torch.testing.assert_close(wtg, tw.warp_twopass_t_plain(g, sc),
                               rtol=2e-4, atol=2e-4)
    assert torch.equal(wtg, tw.warp_twopass_t(g, sc))

    n = 3000
    g = torch.from_numpy(rng.randn(1, n, n, 1).astype(np.float32)).cuda()
    _, sc = taug._twopass_prep(g, mat, True)
    sc = sc.contiguous()
    wtg = tw.warp_twopass_t(g, sc)
    for _ in range(4):
        x = torch.from_numpy(rng.randn(1, n, n, 1).astype(np.float32)).cuda()
        lhs = (tw.warp_twopass(x, sc).double() * g.double()).sum().item()
        rhs = (x.double() * wtg.double()).sum().item()
        # Both sums have 9e6 terms of size ~1: compare against their scale.
        assert abs(lhs - rhs) <= 1e-4 * n, (lhs, rhs)
    with pytest.raises(RuntimeError):           # beyond the tile's limit
        big = torch.zeros((1, 6000, 6000, 8), device="cuda")
        tw.warp_twopass_t(big, sc)


def _small_engine(device):
    """A 32-px triad engine with random weights from a numpy seed (the
    parity tests' small configuration, built without JAX)."""
    from brushstroke_engine_torch.engine.brush import TriadGanPaintEngine
    from brushstroke_engine_torch.models.generator import \
        make_generator_config
    from brushstroke_engine_torch.models.geo_encoder import GeoEncoderConfig
    from brushstroke_engine_torch.utils.checkpoint import (
        init_native_params, params_from_jax,
    )
    enc = GeoEncoderConfig(
        kind="sauto", in_channels=1, out_channels=1, preproc="-11inverse",
        pre_filters=8, down_filters=(16, 16), post_filters=(8,),
        up_filters=(16, 8))
    gen = make_generator_config(
        z_dim=16, w_dim=16, img_resolution=32,
        geom_feature_resolutions=tuple(enc.featuremap_resolution(32, r)
                                       for r in (0, 1)),
        geom_feature_channels=tuple(enc.feature_channels(r) for r in (0, 1)),
        channel_base=2048, channel_max=32)
    trees = init_native_params(gen, enc, seed=3)
    for block in trees["gen_params"]["synthesis"].values():
        for name in ("conv0", "conv1"):
            if name in block:
                block[name]["noise_strength"] = np.float32(0.4)
    t = {k: params_from_jax(v) for k, v in trees.items()}
    return TriadGanPaintEngine(gen, t["gen_params"], t["gen_state"], enc,
                               t["enc_params"], t["enc_state"],
                               geom_inject_resolutions=(0, 1), device=device)


@pytest.mark.parametrize("path", ["batched", "pooled"])
def test_batched_serving_on_the_card(path):
    """Three closed-loop painters through a batched path of the serving core
    on the card: every reply arrives, K1 launches 6 times per generator
    pass, passes hold several rows, and each served image equals the
    session's strokes replayed one by one on the card (1 LSB) and on the
    CPU (1 LSB)."""
    from brushstroke_engine_torch.tools import bench_serve as bs
    eng = _small_engine("cuda")
    n_up = len(eng.gen_cfg.synthesis.block_resolutions) - 1
    core = bs.make_core(eng, path, canvas=96, level=2, crop=4)
    before = fe.fir4_epilogue.launches
    stats, painters = bs.serve(core, path, 3, 4, 1, canvas=96, level=2,
                               crop=4, trace_strokes=1, keep_images=True)
    core.close()
    assert fe.fir4_epilogue.launches - before == stats["k1_launches"] \
        == n_up * stats["generator_passes"]
    assert stats["fallbacks"] == 0 and stats["errors"] == 0
    assert stats["rows_per_pass"]["max"] > 1
    assert stats["device"]["busy_ms"] > 0
    cpu = _small_engine("cpu")
    for p in painters:
        assert len(p.records) == 6
        for eng_r in (eng, cpu):
            replay = bs.serial_replay(eng_r, path, p, 96, 2, 4)
            for r, (img, meta) in zip(p.records, replay):
                assert r["meta"] == meta
                assert np.abs(r["image"].astype(int)
                              - img.astype(int)).max() <= 1


@pytest.mark.parametrize("img_res,layer_res", [(32, 32), (32, 8), (128, 128),
                                               (128, 16), (256, 256)])
def test_wrapped_noise_on_the_card_equals_the_cpu(img_res, layer_res):
    """Every canvas position modulo the image size, on the card and on the
    CPU: the same texels (a division by a Python number on CUDA rounds as a
    product with the reciprocal and picked other texels at 17, 21, 25, 29
    mod 32, and at 9, 13, 18, ... mod 128)."""
    from brushstroke_engine_torch.ops.noise import wrapped_const_noise
    rng = np.random.RandomState(img_res + layer_res)
    tex = torch.from_numpy(rng.randn(layer_res, layer_res).astype(np.float32))
    p = np.arange(img_res)
    pos = torch.from_numpy(np.stack([p, p[::-1]], axis=1).astype(np.int64))
    want = wrapped_const_noise(tex, pos, img_res)
    got = wrapped_const_noise(tex.cuda(), pos.cuda(), img_res).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The training slice on the card: the metric models, K1 at the trainer's
# bf16 rows, and the train state with CUDA tensors and generator.
# ---------------------------------------------------------------------------

def test_lpips_and_detectors_on_the_card_equal_the_cpu():
    """LPIPS, the random FID detector and Inception-v3 (random weights from
    one seed) on the card and on the CPU, TF32 off: 1e-4 relative (cuDNN's
    and the CPU's f32 sums in other orders).  The default models are kept
    per device."""
    from brushstroke_engine_torch.metrics import fid as tfid
    from brushstroke_engine_torch.metrics import inception as tinc
    from brushstroke_engine_torch.metrics import lpips as tlpips
    rng = np.random.RandomState(30)
    x = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    u8 = rng.randint(0, 256, (2, 96, 96, 3)).astype(np.uint8)
    cpu = tlpips.lpips_batched(torch.from_numpy(x), torch.from_numpy(y),
                               tlpips.get_default_model("cpu"))
    gpu = tlpips.lpips_batched(torch.from_numpy(x).cuda(),
                               torch.from_numpy(y).cuda())
    assert gpu.device.type == "cuda"
    assert tlpips.get_default_model("cuda").device.type == "cuda"
    assert tlpips.get_default_model("cpu").device.type == "cpu"
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=1e-4, atol=1e-6)
    for make in (tfid.InceptionFeatures.random_init,
                 tinc.InceptionV3.random_init):
        fc = tfid.extract_features(u8, make(0, device="cpu"))
        fg = tfid.extract_features(u8, make(0, device="cuda"))
        assert fg.device.type == "cuda"
        torch.testing.assert_close(fg.cpu(), fc, rtol=1e-4,
                                   atol=1e-4 * float(fc.abs().max()))
    fd = tfid.extract_features(torch.from_numpy(u8).cuda())
    assert fd.device.type == "cuda" and \
        tfid.get_default_extractor("cpu").device.type == "cpu"


@pytest.mark.parametrize("b", [64, 32])
@pytest.mark.parametrize("res", [16, 32, 64, 128])
def test_kernel_bf16_at_the_trainer_rows(b, res):
    """K1 in bf16 at the canonical training run's rows (--num_bf16_res 4:
    the 16-128 px conv0 layers, C = 128, B = 64 and B = 32 for the
    path-length phase, noise and clamp) against the plain version: 2^-7
    relative + 1e-5 (one bf16 ulp)."""
    x, d, noise, bias = _inputs(res + b, b, res, res, 128, b)
    x = (x * 2).to(torch.bfloat16)
    got = fe.fir4_epilogue(x, F, d, noise, bias, 2 ** 0.5, 256.0)
    want = fe.fir4_epilogue_plain(x, fe.correlation_taps(F), d, noise, bias,
                                  2 ** 0.5, 256.0)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-5)


@pytest.mark.parametrize("res", [64, 128])
def test_kernel_bf16_backward_at_the_trainer_rows(res):
    """K1's backward with a bf16 input at the 64- and 128-px training
    shapes (B = 8 of the B = 64 rows): every gradient within 2^-7 of its
    largest entry (the backward re-runs the plain chain on the same bf16
    inputs; the bound allows one bf16 rounding of a summed product)."""
    x, d, noise, bias = _inputs(res, 8, res, res, 128, 8)
    cot = torch.randn((8, res, res, 128), device="cuda")
    grads = []
    for use_kernel in (True, False):
        ins = [t.detach().clone().requires_grad_(True)
               for t in (x.to(torch.bfloat16), d, noise, bias)]
        if use_kernel:
            y = fe.fir4_epilogue(ins[0], F, *ins[1:3], ins[3], 2 ** 0.5,
                                 256.0)
            assert y.grad_fn is not None
        else:
            y = fe.fir4_epilogue_plain(ins[0], fe.correlation_taps(F),
                                       *ins[1:], 2 ** 0.5, 256.0)
        grads.append(torch.autograd.grad((y.float() * cot).sum(), ins))
    for name, a, w in zip(("x", "dcoefs", "noise", "bias"), *grads):
        assert a.dtype == w.dtype
        scale = float(w.float().abs().max())
        assert scale > 0, name
        err = float((a.float() - w.float()).abs().max()) / scale
        assert err <= 2 ** -7, (name, err)


def _small_train_loop(run_dir, seed=0):
    from brushstroke_engine_torch.models.discriminator import \
        DiscriminatorConfig
    from brushstroke_engine_torch.train.augment import AugmentConfig
    from brushstroke_engine_torch.train.loop import TrainingLoop
    from brushstroke_engine_torch.train.state import TrainConfig
    eng = _small_engine("cpu")
    cfg = TrainConfig(
        gen_cfg=eng.gen_cfg, enc_cfg=eng.enc_cfg, enc_res=(0, 1),
        disc_cfg=DiscriminatorConfig(
            c_dim=0, img_resolution=32, img_channels=3, architecture="orig",
            channel_base=2048, channel_max=32),
        batch_size=4, augment=AugmentConfig.from_spec("bgc"),
        d_reg_interval=2, g_reg_interval=2, geom_interval=2, ada_interval=1,
        geom_warmstart_kimg=0, kimg_per_tick=0.004)
    rng = np.random.RandomState(31)

    def batches(shape):
        while True:
            yield rng.randint(0, 256, shape).astype(np.uint8)
    return TrainingLoop(cfg, eng.enc_params, eng.enc_state,
                        batches((4, 32, 32, 3)), batches((4, 40, 40, 3)),
                        run_dir=str(run_dir), seed=seed, device="cuda")


def test_train_state_round_trips_on_the_card(tmp_path):
    """save_train_state / load_train_state with CUDA tensors and the CUDA
    generator: every leaf back on the card, equal; the restored generator
    draws what the saved one draws next."""
    from brushstroke_engine_torch.utils.util import tree_leaves
    loop = _small_train_loop(tmp_path / "a")
    loop.run(total_kimg=0.008)
    path = loop.save_train_state(str(tmp_path / "ts.pkl"))
    other = _small_train_loop(tmp_path / "b", seed=7)
    assert other.load_train_state(path)
    assert (other.cur_nimg, other.batch_idx) == (8, 2)
    assert other.state["g_opt"]["count"] == loop.state["g_opt"]["count"] > 0
    for a, b in zip(tree_leaves(other.state), tree_leaves(loop.state)):
        if isinstance(a, torch.Tensor):
            assert a.device.type == "cuda" and a.shape == b.shape
            assert torch.equal(a, b)
    assert torch.equal(torch.randn(64, device="cuda",
                                   generator=other.device_rng),
                       torch.randn(64, device="cuda",
                                   generator=loop.device_rng))


# ---------------------------------------------------------------------------
# Reference checkpoints and the model variants they carry, on the card
# ---------------------------------------------------------------------------

_VARIANTS = {
    "orig-head-skip": dict(color_format="orig", architecture="skip"),
    "posenc-cat": dict(geom_feature_resolutions=(8,),
                       geom_feature_channels=(4,),
                       positional_encoding="sine:8",
                       posenc_inject_resolutions=(1, 2)),
    "c_dim": dict(geom_feature_resolutions=(8,), geom_feature_channels=(4,),
                  c_dim=4),
}


def _variant(kw, device, seed=2):
    from brushstroke_engine_torch.models.generator import \
        make_generator_config
    from brushstroke_engine_torch.models.geo_encoder import GeoEncoderConfig
    from brushstroke_engine_torch.utils.checkpoint import (
        init_native_params, params_from_jax,
    )
    from brushstroke_engine_torch.utils.util import tree_to
    cfg = make_generator_config(z_dim=8, w_dim=8, img_resolution=32,
                                channel_base=256, channel_max=16,
                                mapping_layers=2, **kw)
    enc = GeoEncoderConfig(pre_filters=2, down_filters=(2,),
                           post_filters=(2,), up_filters=(2,))
    trees = init_native_params(cfg, enc, seed=seed)
    for block in trees["gen_params"]["synthesis"].values():
        for name in ("conv0", "conv1"):
            if name in block:
                block[name]["noise_strength"] = np.float32(0.3)
    return cfg, [tree_to(params_from_jax(trees[k]), device)
                 for k in ("gen_params", "gen_state")]


@pytest.mark.parametrize("name", sorted(_VARIANTS))
def test_generator_variant_on_the_card_equals_the_cpu(name):
    """z -> image of each variant at B = 4 on the card and on the CPU
    (1e-4: cuDNN's and the CPU's f32 sums in other orders, TF32 off); K1
    launches once per up-sampling layer."""
    from brushstroke_engine_torch.models.generator import generator_apply
    rng = np.random.RandomState(3)
    z = torch.from_numpy(rng.randn(4, 8).astype(np.float32))
    c = torch.from_numpy(rng.randn(4, 4).astype(np.float32))
    geom = [torch.from_numpy(rng.randn(4, 8, 8, 4).astype(np.float32))]
    pos = torch.from_numpy(np.array([[3, 40], [0, 0], [31, 7], [300, 9]]))
    outs = []
    for dev in ("cuda", "cpu"):
        cfg, (gp, gs) = _variant(_VARIANTS[name], dev)
        before = fe.fir4_epilogue.launches
        img, _ = generator_apply(
            cfg, gp, gs, z=z.to(dev), c=c.to(dev) if cfg.c_dim else None,
            geom_features=[g.to(dev) for g in geom]
            if cfg.synthesis.geom_feature_resolutions else (),
            positions=pos.to(dev), noise_mode="const")
        if dev == "cuda":
            torch.cuda.synchronize()
            assert fe.fir4_epilogue.launches - before == \
                len(cfg.synthesis.block_resolutions) - 1
        outs.append(img.cpu())
    assert torch.isfinite(outs[0]).all()
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)


def test_reference_snapshot_on_the_card(tmp_path):
    """A reference-layout snapshot ('conv' encoder) through the factory on
    the card: parameters bit-equal to the CPU conversion, the stroke within
    1 LSB of the CPU's, K1 launched by the render."""
    from brushstroke_engine_torch.engine.brush import (
        GanBrushOptions, PaintEngineFactory,
    )
    from brushstroke_engine_torch.models.geo_encoder import GeoEncoderConfig
    from brushstroke_engine_torch.utils import reference_layout as rl
    from brushstroke_engine_torch.utils.checkpoint import (
        init_native_params, params_to_jax,
    )
    from brushstroke_engine_torch.models.generator import \
        make_generator_config
    enc = GeoEncoderConfig(kind="conv", preproc="-11inverse", img_width=32,
                           emb_channel=4, channel_factor=2, num_layers=2)
    cfg = make_generator_config(z_dim=8, w_dim=8, img_resolution=32,
                                geom_feature_resolutions=(8,),
                                geom_feature_channels=(4,), channel_base=256,
                                channel_max=16, mapping_layers=2)
    trees = init_native_params(cfg, enc, seed=5)
    p = str(tmp_path / "snap.pkl")
    rl.write_reference_snapshot(
        p, rl.generator_state_dict(cfg, trees["gen_params"],
                                   trees["gen_state"]),
        {"color_format": "triad", "geom_inject_resolutions": [0]},
        encoder={"args": rl.encoder_args(enc),
                 "model_state": rl.encoder_state_dict(
                     enc, trees["enc_params"], trees["enc_state"])})
    engines = [PaintEngineFactory.create(p, device=d) for d in ("cuda", "cpu")]
    for k in ("gen_params", "enc_params", "enc_state"):
        a, b = (params_to_jax(getattr(e, k)) for e in engines)
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_array_equal(x, y)
    patch = np.zeros((32, 32, 4), np.uint8)
    patch[8:20, 4:28, 3] = 255
    outs = []
    before = fe.fir4_epilogue.launches
    for e in engines:
        opts = GanBrushOptions()
        opts.set_style(e.random_style(1), style_id=1)
        outs.append(e.render_stroke(patch, None, opts)[0])
    assert fe.fir4_epilogue.launches > before
    assert np.abs(outs[0].astype(int) - outs[1].astype(int)).max() <= 1


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def test_autoencoder_steps_on_the_card_equal_the_cpu():
    """Two AE steps (a small 'sauto' encoder, batch 4 at 32 px) on the card
    and on the CPU from the same weights and crops: the losses within 1e-4
    relative."""
    from brushstroke_engine_torch.models.geo_encoder import GeoEncoderConfig
    from brushstroke_engine_torch.train import train_autoencoder as tae
    cfg = tae.AETrainConfig(enc_cfg=GeoEncoderConfig(
        preproc="-11inverse", pre_filters=4, down_filters=(8, 8),
        post_filters=(6,), up_filters=(8, 4)))
    rng = np.random.RandomState(4)
    geom = [(rng.rand(4, 32, 32, 2) > 0.3).astype(np.float32)
            for _ in range(2)]
    losses = {}
    for dev in ("cuda", "cpu"):
        step, opt = tae.make_ae_train_step(cfg)
        params, state = tae.init_ae(cfg.enc_cfg, seed=1, device=dev)
        opt_state = opt.init(params)
        losses[dev] = []
        for g in geom:
            g = torch.from_numpy(g).to(dev)
            params, state, opt_state, loss = step(params, state, opt_state,
                                                  g[..., :1], g[..., 1:])
            losses[dev].append(loss.item())
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# ---------------------------------------------------------------------------
# Stitching and the metric zoo on the card
# ---------------------------------------------------------------------------

def _stitch_setup(device):
    """The small stitch configuration's config, train state, both crops'
    features and explicit draws (made on the CPU), on ``device``."""
    from brushstroke_engine_torch.models.discriminator import \
        DiscriminatorConfig
    from brushstroke_engine_torch.train import steps as tsteps
    from brushstroke_engine_torch.train.augment import AugmentConfig, \
        draw_augment
    from brushstroke_engine_torch.train.state import TrainConfig, \
        init_train_state
    from brushstroke_engine_torch.utils.util import tree_to
    eng = _small_engine(device)
    cfg = TrainConfig(
        gen_cfg=eng.gen_cfg, enc_cfg=eng.enc_cfg, enc_res=(0, 1),
        disc_cfg=DiscriminatorConfig(
            c_dim=0, img_resolution=32, img_channels=3, architecture="orig",
            channel_base=2048, channel_max=32),
        batch_size=4, augment=AugmentConfig.from_spec("bgc"),
        stitch_interval=4, stitch_phase_losses="1.0*gan(fake)+"
        "1.0*gan(fake_composite)+1.0*l1(patch)")
    state = tree_to(init_train_state(cfg, 0, device="cpu"), device)
    state["ada_p"] = torch.full((), 0.6, device=device)
    rng = np.random.RandomState(17)
    geom = torch.from_numpy((rng.rand(4, 32, 32, 1) > 0.5).astype(
        np.float32)).to(device)
    feats1 = tsteps.encode_geometry(cfg, eng.enc_params, eng.enc_state, geom)
    feats2 = tsteps.encode_geometry(cfg, eng.enc_params, eng.enc_state,
                                    torch.flip(geom, dims=(2,)))
    gen = torch.Generator().manual_seed(5)
    draws = {"positions1": torch.tensor([[0, 3], [5, 10], [12, 2], [9, 7]]),
             "aug_fake": draw_augment(cfg.augment, gen, 8, (32, 32, 3),
                                      "cpu"),
             "aug_composite": draw_augment(cfg.augment, gen, 8, (32, 32, 3),
                                           "cpu")}
    z = torch.from_numpy(rng.randn(4, 16).astype(np.float32)).to(device)
    return cfg, state, feats1, feats2, z, tree_to(draws, device)


def test_gstitch_step_on_the_card_equals_the_cpu():
    """One Gstitch at B = 4 (ADA at p = 0.6) on the card and on the CPU
    with the same draws: every stat within 1e-4 relative (cuDNN's and the
    CPU's f32 sums in other orders); K1 on both generator passes, W on both
    discriminator passes and W^T in their backward."""
    from brushstroke_engine_torch.train import steps as tsteps
    stats = {}
    for dev in ("cuda", "cpu"):
        cfg, state, f1, f2, z, draws = _stitch_setup(dev)
        before = (fe.fir4_epilogue.launches, tw.warp_twopass.launches,
                  tw.warp_twopass_t.launches)
        _, s = tsteps.g_stitch_step(cfg, state, f1, f2, z, (2, 3, 32, 32),
                                    (7, 0, 32, 32), ema_beta=0.5,
                                    draws=draws)
        stats[dev] = {k: float(v) for k, v in s.items()}
        after = (fe.fir4_epilogue.launches, tw.warp_twopass.launches,
                 tw.warp_twopass_t.launches)
        n_up = len(cfg.gen_cfg.synthesis.block_resolutions) - 1
        want = (2 * n_up, 2, 2) if dev == "cuda" else (0, 0, 0)
        assert tuple(a - b for a, b in zip(after, before)) == want
    assert set(stats["cuda"]) == set(stats["cpu"])
    for k, v in stats["cpu"].items():
        assert abs(stats["cuda"][k] - v) <= 1e-4 * max(abs(v), 1e-3), k


@pytest.mark.parametrize("antialias", [True, False])
def test_warp_kernels_at_the_gstitch_batch(antialias):
    """W and W^T at B = 128 (Gstitch's discriminator sees both crops of a
    64-batch) against their plain versions, as at the other batches."""
    x, g, sc = _warp_case(13, 128, 128, 3, antialias)
    wx, wtg = tw.warp_twopass(x, sc), tw.warp_twopass_t(g, sc)
    torch.testing.assert_close(wx, tw.warp_twopass_plain(x, sc), rtol=2e-5,
                               atol=2e-5)
    torch.testing.assert_close(wtg, tw.warp_twopass_t_plain(g, sc),
                               rtol=2e-4, atol=2e-4)
    assert (128, 128, 3) in tw.warp_twopass.shapes
    assert (128, 128, 3) in tw.warp_twopass_t.shapes


def test_ppl_and_pr_on_the_card_equal_the_cpu():
    """PPL's per-sample distances at epsilon 1e-2 within 1e-3 relative
    (f32 renders in other summation orders, magnified by epsilon^-2 = 1e4)
    plus the f32 floor of LPIPS (8 u sqrt(d) / epsilon, see
    tests/test_torch_metric_zoo.py); precision and recall equal on the same
    clustered features."""
    from brushstroke_engine_torch.metrics import pr as tpr
    from brushstroke_engine_torch.metrics import ppl as tppl
    from brushstroke_engine_torch.models.geo_encoder import \
        geo_encoder_encode
    geom = (np.random.RandomState(2).rand(1, 32, 32, 1) > 0.5).astype(
        np.float32)
    d = {}
    for dev in ("cuda", "cpu"):
        eng = _small_engine(dev)
        feats = geo_encoder_encode(eng.enc_cfg, eng.enc_params,
                                   eng.enc_state,
                                   torch.from_numpy(geom).to(dev),
                                   res=[0, 1])
        d[dev] = tppl.ppl_distances(eng, feats, num_samples=8,
                                    epsilon=1e-2, space="w", batch=4,
                                    seed=3)
    bound = 1e-3 * d["cpu"] + 8 * 2.0 ** -24 * np.sqrt(d["cpu"]) / 1e-2
    assert np.all(np.abs(d["cuda"] - d["cpu"]) <= bound), d
    rng = np.random.RandomState(7)
    centers = rng.randn(6, 16).astype(np.float32) * 10
    real = (centers[rng.randint(0, 5, 40)] + rng.randn(40, 16) * 0.3)
    fake = (centers[1 + rng.randint(0, 5, 33)] + rng.randn(33, 16) * 0.3)
    assert tpr.compute_pr(real, fake, row_batch_size=7, device="cuda") == \
        tpr.compute_pr(real, fake, row_batch_size=7, device="cpu")


def test_project_parallel_step_on_the_card_equals_the_cpu():
    """One ``project_parallel`` step of 2 styles x 2 rows with per-row noise
    planes, the same draws on the card and on the CPU: K1 runs every up=2
    layer (its backward gives the noise gradient), the LPIPS within 1e-4
    relative, w and noise within 1e-4 relative plus Adam's lr bound (step 0
    has lr 0: only the noise renormalization moves them)."""
    from brushstroke_engine_torch.tools import projection as tproj
    rng = np.random.RandomState(5)
    targets = (rng.rand(2, 2, 32, 32, 3) * 2 - 1).astype(np.float32)
    geoms = np.ones((2, 2, 32, 32, 1), np.float32)
    geoms[:, :, 10:20, 4:28] = 0.0
    cfg = tproj.ProjectionConfig(num_steps=2, w_avg_samples=64,
                                 min_lpips_improvement=-1.0)
    eng = _small_engine("cuda")
    draws = rng.randn(2, 2, 1, eng.gen_cfg.num_ws,
                      eng.gen_cfg.w_dim).astype(np.float32)
    n_up = len(eng.gen_cfg.synthesis.block_resolutions) - 1
    before = fe.fir4_epilogue.launches
    got = tproj.project_parallel(eng, targets, geoms, cfg, log_every=1,
                                 draws=draws)
    assert fe.fir4_epilogue.launches - before == 2 * n_up
    assert (4, 32, 32, 32, str(torch.float32)) in fe.fir4_epilogue.shapes
    want = tproj.project_parallel(_small_engine("cpu"), targets, geoms, cfg,
                                  log_every=1, draws=draws)
    lr_total = sum(tproj._lr_schedule(cfg, s) for s in range(2))
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        np.testing.assert_allclose(g["lpips"], w["lpips"], rtol=1e-4)
        for key in w["noise"]:
            err = np.abs(g["noise"][key] - w["noise"][key])
            assert err.max() <= 1e-4 * np.abs(w["noise"][key]).max() \
                + lr_total
        err = np.abs(g["w"] - w["w"])
        assert err.max() <= 1e-4 * np.abs(w["w"]).max() + lr_total
