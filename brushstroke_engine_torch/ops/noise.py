"""Position-wrapped constant noise sampling.

Counterpart of ``brushstroke_engine_tpu/ops/noise.py``, in its fixed form.
With layer noise resolution ``R_l``, image resolution ``R_img`` and patch
position ``(y, x)``, the sample is

    out[b, i, j] = bilinear(noise, row = c(j, x_b), col = c(i, y_b))
    c(t, p) = ((t / (R_l - 1) + (p % R_img) / (R_img - 1)) % 1) * (R_l - 1)

i.e. a fractional circular shift of the (transposed) texture with period
``p = R_l - 1``.  The bilinear '+1' tap of an integer coordinate ``a`` reads
texel ``a + 1``, which may be the LAST texel ``p``: it is not the periodic
wrap to texel 0, so the '+1' corner reads ``T[1 : p+1]`` with period ``p``.
"""

from __future__ import annotations

import torch


def wrapped_const_noise(noise_const, positions, img_resolution: int):
    """Sample a noise texture with wrap-around at a canvas position.

    Args:
      noise_const: ``[R_l, R_l]`` float noise texture.
      positions: ``[B, 2]`` int tensor of (y, x) patch positions in canvas
        pixels.
      img_resolution: the generator's output resolution ``R_img``.

    Returns:
      ``[B, R_l, R_l, 1]`` float32 noise.
    """
    r_l = int(noise_const.shape[0])
    p = r_l - 1
    pos = positions.to(device=noise_const.device, dtype=torch.float32)
    # A true division, by a tensor on the same device: CUDA divides by a
    # Python number as a product with its reciprocal, whose rounding moves
    # ``shift`` across an integer at some positions (17, 21, 25, 29 mod 32
    # at 32 px) and so reads another texel than the CPU.
    norm = torch.remainder(pos, img_resolution) / torch.full_like(
        pos, float(img_resolution - 1))
    shift = torch.remainder(norm, 1.0) * p          # [B, 2] (y, x) in [0, p)
    k = torch.floor(shift)
    frac = shift - k
    k = k.long()
    f_col = frac[:, 0, None, None]                  # y shift, along i
    f_row = frac[:, 1, None, None]                  # x shift, along j

    t = torch.arange(r_l, device=noise_const.device)
    ia = torch.remainder(k[:, 0, None] + t, p)      # [B, r_l]
    ja = torch.remainder(k[:, 1, None] + t, p)
    m = noise_const.float().t()                     # i-major

    def corner(di, dj):
        return m[(ia + di)[:, :, None], (ja + dj)[:, None, :]]

    out = ((1 - f_col) * (1 - f_row) * corner(0, 0)
           + (1 - f_col) * f_row * corner(0, 1)
           + f_col * (1 - f_row) * corner(1, 0)
           + f_col * f_row * corner(1, 1))
    return out[..., None]
