"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one: a CUDA kernel has
no CPU mode.  The file imports no JAX, so it runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: f32 1e-5 rel and abs (the same f32 math, only the FIR sum's
order differs); bf16 2^-7 relative -- one bf16 ulp, since both sides round
one f32 value once -- plus a 1e-5 abs floor for outputs near 0.
"""

import numpy as np
import pytest
import torch

from brushstroke_engine_torch.ops import fir_epilogue as fe
from brushstroke_engine_torch.ops.conv import modulated_conv2d
from brushstroke_engine_torch.ops.filters import setup_filter
from brushstroke_engine_torch.ops.precision import set_precision_mode

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
