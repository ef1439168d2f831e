"""Operations and bytes of the painting engine's forward pass, from the
configuration's shapes alone.

A convolution counts 2 * k * k * in * out multiply-adds per output pixel it
must compute: an up=2 3x3 conv counts its transposed form, 2 * 9 * in * out
per input pixel, not the zeros a dense form would multiply.  A matrix
product counts 2 * m * n * k.  Elementwise work (modulation, noise, bias,
activations, softmax, the FIR) is not counted: it is no conv or matrix
product.  These counts are the same work whatever implements them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from neube_bench import weights as W


def forward_layers(cfg: Dict, batch: int) -> List[Tuple[str, str, float]]:
    """[(layer, part, flops)] of one render pass of ``batch`` patches;
    ``part`` is 'encoder' or 'generator'."""
    res = cfg["img_resolution"]
    out = []
    enc_layers, dec_layers = W.encoder_plan(cfg)
    n_down = len(cfg["encoder"]["down_filters"])
    r = res
    for i, (name, ci, co, k) in enumerate(enc_layers):
        if 1 <= i <= n_down:
            r //= 2
        out.append((f"encoder.{name}", "encoder",
                    2.0 * k * k * ci * co * r * r * batch))
    for i in range(max(cfg["geom_inject_resolutions"])):
        name, ci, co, k = dec_layers[i]
        r *= 2
        out.append((f"decoder.{name}", "encoder",
                    2.0 * k * k * ci * co * r * r * batch))
    w = cfg["w_dim"]
    feats = [cfg["z_dim"]] + [w] * cfg["mapping_layers"]
    out.append(("mapping", "generator",
                sum(2.0 * a * b for a, b in zip(feats, feats[1:])) * batch))
    for r in W.block_resolutions(cfg):
        c = W.channels(cfg, r)
        layers = [("conv1", c, 2.0 * 9 * c * c * r * r)]
        if r > 4:
            ci = W.block_in_channels(cfg, r)
            layers.insert(0, ("conv0", ci,
                              2.0 * 9 * ci * c * (r // 2) ** 2))
        for name, ci, conv in layers:
            affine = 2.0 * w * ci
            demod = 2.0 * ci * c
            out.append((f"b{r}.{name}", "generator",
                        (conv + affine + demod) * batch))
        if r == res:
            out.append((f"b{r}.torgb", "generator",
                        (2.0 * c * 3 * r * r + 2.0 * w * (c + 9)) * batch))
    return out


def forward_flops(cfg: Dict, batch: int) -> float:
    return sum(f for _, _, f in forward_layers(cfg, batch))


def least_seconds(cfg: Dict, batch: int, peaks: Dict[str, float]) -> float:
    """The least time one pass's convs and matrix products need at the
    peak of the dtype each runs in (``peaks.compute_kind``)."""
    from neube_bench.workcount.peaks import compute_kind
    return sum(f / peaks[compute_kind(cfg["precision"], part)]
               for _, part, f in forward_layers(cfg, batch))


def k1_launches(cfg: Dict, batch: int):
    """[(res, bytes, flops)] of the fused FIR-epilogue kernel's launches in
    one render pass: one per up=2 layer.  Each input byte is counted once
    and each output byte once: the pre-FIR tensor ``[B, r+3, r+3, C]`` and
    the output ``[B, r, r, C]``, the noise ``[B, r, r, 1]``, the
    demodulation ``[B, C]`` and the bias ``[C]``, all in float32 (the
    configuration's blocks run in float32).  The
    operations are the 16-tap FIR's multiply-adds and 6 more per output
    (scale, noise, bias, activation, gain, clamp), as
    ``chip_smoke.py``'s bound counts them."""
    rows = []
    for r in W.block_resolutions(cfg)[1:]:
        c = W.channels(cfg, r)
        n_out = batch * r * r * c
        nbytes = (batch * (r + 3) ** 2 * c * 4
                  + n_out * 4 + batch * r * r * 4
                  + batch * c * 4 + c * 4)
        rows.append((r, float(nbytes), float(n_out * (16 * 2 + 6))))
    return rows


def k1_bound_seconds(cfg: Dict, batch: int, hbm: float, f32: float) -> float:
    """The least time of one pass's K1 launches: per launch the larger of
    its bytes over the memory rate and its operations over the float32
    rate."""
    return sum(max(b / hbm, f / f32) for _, b, f in k1_launches(cfg, batch))


def k2_launch(batch: int, n: int, channels: int, half_widths):
    """(bytes, flops) of one launch of the ADA two-pass warp ``W`` (or of
    its transpose ``Wᵀ``) over ``batch`` square ``[n, n, channels]``
    float32 images, whose pass half-widths ``(s1, s2)`` per image are
    ``half_widths`` (the warp's scalars 3 and 7, at least 1).  One image
    batch read and one written, and the eight float32 scalars per image;
    per output pixel and pass each tap under the triangle (``2 s + 1``)
    costs a weight (4 operations) and ``channels`` multiply-adds, as
    ``chip_smoke.py``'s bound counts them."""
    nbytes = 2 * batch * n * n * channels * 4 + batch * 8 * 4
    taps = sum((2 * s1 + 1) + (2 * s2 + 1) for s1, s2 in half_widths)
    return float(nbytes), float(taps * n * n * (4 + 2 * channels))
