"""Geometry (stroke) autoencoder: encodes a black-on-white stroke patch into
multi-resolution feature maps that condition the GAN trunk.

Counterpart of ``brushstroke_engine_tpu/models/geo_encoder.py``: the
'sauto' family (both layer orders, bilinear align-corners and
transposed-conv ``scale_up_v2`` decoder up-layers, partial decoding for
multi-resolution features) and the strided 'conv' autoencoder (bottleneck
only; conv -> act -> BN), the feature encoding for the GAN
(:func:`geo_encoder_encode`, eval mode), the full autoencoder forward with
BatchNorm in eval or train mode (:func:`geo_encoder_apply`) and the pre- and
post-processing of the reference's base class (base.py:32-91).  Inputs and
outputs are NHWC; inside, the convs run on NCHW views.  Conv weights are
OIHW for every layer, the transposed ones included (the JAX package stores
them HWIO like the others); a transposed conv views its weight as torch's
IOHW.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from brushstroke_engine_torch.ops.precision import get_precision_mode
from brushstroke_engine_torch.ops.upfirdn import nchw


@dataclass(frozen=True)
class GeoEncoderConfig:
    kind: str = "sauto"                  # 'sauto' | 'conv'
    in_channels: int = 1
    out_channels: int = 1                # decoder output channels (1 or 3)
    preproc: Optional[str] = "none"      # 'none' | 'inverse' | '-11inverse'
    # --- sauto ---
    pre_filters: int = 64
    down_filters: Tuple[int, ...] = (128, 256, 256)
    post_filters: Tuple[int, ...] = (32, 16)
    up_filters: Tuple[int, ...] = (256, 128, 64)
    decoder_pre_filters: int = -1
    neg_slope: Optional[float] = None    # None = legacy (conv-BN-act, slope .01)
    # --- conv ---
    img_width: int = 128
    emb_channel: int = 4
    channel_factor: int = 4
    num_layers: int = 4

    @property
    def batchnorm_after_activation(self) -> bool:
        return self.kind == "sauto" and self.neg_slope is not None

    @property
    def scale_up_v2(self) -> bool:
        return self.kind == "sauto" and self.neg_slope is not None

    def num_downsampling_layers(self) -> int:
        if self.kind == "sauto":
            return len(self.down_filters)
        return self.num_layers

    def feature_channels(self, res: int = 0) -> int:
        if self.kind == "sauto":
            channels = [self.post_filters[-1]] + list(self.up_filters)
            return channels[res]
        assert res == 0, "conv AE supports bottleneck resolution only"
        return self.emb_channel

    def featuremap_resolution(self, input_res: int, res: int = 0) -> int:
        enc_res = input_res // (2 ** self.num_downsampling_layers())
        return enc_res * (2 ** res)


def _bias(p, y):
    return y + p["bias"].to(y.dtype)[None, :, None, None]


def _reflect_conv(p, x, stride: int = 1, pad: int = 1):
    if pad > 0:
        x = F.pad(x, [pad, pad, pad, pad], mode="reflect")
    return _bias(p, F.conv2d(x, p["weight"].to(x.dtype), stride=stride))


def _conv_transpose(p, x, stride: int = 2, pad: int = 1,
                    output_padding: int = 1):
    """nn.ConvTranspose2d; the OIHW weight is viewed as torch's IOHW."""
    w = p["weight"].transpose(0, 1).to(x.dtype)
    return _bias(p, F.conv_transpose2d(x, w, stride=stride, padding=pad,
                                       output_padding=output_padding))


def _bn(p, s, x, train: bool, momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm2d on NCHW ``x``; returns (y, new running stats).  In
    training it normalises with the biased batch variance and moves the
    running variance toward the unbiased one (``n / (n - 1)``), as torch's
    ``BatchNorm2d`` and the JAX package's ``_bn_apply`` do; in eval it
    reads the running stats and leaves them as they are."""
    def ch(v):
        return v.to(x.dtype)[None, :, None, None]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        unbiased = var.detach() * n / max(n - 1, 1)
        new_s = {"mean": (1 - momentum) * s["mean"]
                 + momentum * mean.detach(),
                 "var": (1 - momentum) * s["var"] + momentum * unbiased}
    else:
        mean, var, new_s = s["mean"], s["var"], s
    inv = torch.rsqrt(var + eps)
    return (x - ch(mean)) * ch(inv) * ch(p["scale"]) + ch(p["bias"]), new_s


def _lrelu(x, neg_slope: Optional[float]):
    return F.leaky_relu(x, 0.01 if neg_slope is None else neg_slope)


def upsample_bilinear_align_corners(x, factor: int = 2):
    """Bilinear upsample of NCHW ``x`` with align_corners=True semantics."""
    return F.interpolate(x, scale_factor=factor, mode="bilinear",
                         align_corners=True)


def _single_conv_apply(cfg, p, s, x, *, stride=1, pad=1, transpose=False,
                       legacy_order=None, train=False):
    """conv (+BN +LeakyReLU in config-dependent order); returns (x, state)."""
    if transpose:
        x = _conv_transpose(p["conv"], x, stride=stride, pad=pad)
    else:
        x = _reflect_conv(p["conv"], x, stride=stride, pad=pad)
    after_act = cfg.batchnorm_after_activation if legacy_order is None \
        else legacy_order
    if after_act:
        x, bn_s = _bn(p["bn"], s["bn"], _lrelu(x, cfg.neg_slope), train)
    else:
        x, bn_s = _bn(p["bn"], s["bn"], x, train)
        x = _lrelu(x, cfg.neg_slope)
    return x, {"bn": bn_s}


def _by_res(names, sign):
    return sorted(names, key=lambda n: sign * int(n.replace("layer", "")))


def _encoder_forward(cfg, params, state, x, train=False):
    """The encoder half; returns (encoding, new encoder state)."""
    new_state = {}
    enc_p, enc_s = params["encoder"], state["encoder"]
    if cfg.kind == "sauto":
        n_pre = 1 if cfg.pre_filters > 0 else 0
        n_down = len(cfg.down_filters)
        for i, name in enumerate(_by_res(enc_p, 1)):
            stride = 2 if n_pre <= i < n_pre + n_down else 1
            pad = 3 if (i == 0 and n_pre) else 1
            x, new_state[name] = _single_conv_apply(
                cfg, enc_p[name], enc_s[name], x, stride=stride, pad=pad,
                train=train)
        return x, new_state
    # 'conv' (ae_conv.py): strided layers from the input resolution down,
    # then 'final'; conv -> act -> BN.
    for name in _by_res([n for n in enc_p if n != "final"], -1) + ["final"]:
        x, new_state[name] = _single_conv_apply(
            cfg, enc_p[name], enc_s[name], x,
            stride=1 if name == "final" else 2, legacy_order=True,
            train=train)
    return x, new_state


def _decoder_layers(cfg, params, state, x, nlayers, train=False):
    """Run the 'sauto' decoder's first ``nlayers`` up-layers; returns (x,
    the detached intermediates, new decoder state)."""
    new_state, results = {}, []
    if "first" in params["decoder"]:
        x, new_state["first"] = _single_conv_apply(
            cfg, params["decoder"]["first"], state["decoder"]["first"], x,
            legacy_order=True, train=train)
    for i in range(nlayers):
        name = f"up{i}"
        p, s = params["decoder"][name], state["decoder"][name]
        if cfg.scale_up_v2:
            x, new_state[name] = _single_conv_apply(
                cfg, p, s, x, stride=2, pad=1, transpose=True,
                legacy_order=True, train=train)
        else:
            x = upsample_bilinear_align_corners(x)
            x, new_state[name] = _single_conv_apply(
                cfg, p, s, x, legacy_order=False, train=train)
        results.append(x.detach())
    return x, results, new_state


def preprocess(cfg: GeoEncoderConfig, x):
    if cfg.preproc in (None, "none"):
        return x
    if cfg.preproc == "inverse":
        return 1.0 - x
    if cfg.preproc == "-11inverse":
        return (1.0 - x) * 2.0 - 1.0
    raise ValueError(f"unknown preprocessing {cfg.preproc!r}")


def geo_encoder_encode(cfg: GeoEncoderConfig, params, state, geom,
                       res: Sequence[int] = (0,)):
    """Encode geometry into feature maps for the GAN (eval mode).

    Args:
      geom: ``[B, H, W, 1]`` float, 0 = stroke (FG), 1 = background.
      res: resolutions to return (0 = bottleneck, 1 = one decoder layer up;
        the 'conv' kind has the bottleneck only).

    Returns:
      list of ``[B, h_i, w_i, c_i]`` f32 feature maps (NHWC).
    """
    if isinstance(res, int):
        res = [res]
    if cfg.kind == "conv" and max(res) != 0:
        raise ValueError("conv AE supports bottleneck resolution only")
    x = nchw(preprocess(cfg, geom))
    # In 'fast' mode the frozen encoder runs in bf16, as in the JAX package.
    if get_precision_mode() == "fast":
        x = x.to(torch.bfloat16)
    encoding, _ = _encoder_forward(cfg, params, state, x)
    results = [encoding]
    if max(res) > 0:
        results += _decoder_layers(cfg, params, state, encoding,
                                   max(res))[1]
    return [results[r].float().permute(0, 2, 3, 1).contiguous() for r in res]


def geo_encoder_apply(cfg: GeoEncoderConfig, params, state, x,
                      train: bool = False, preprocess_input: bool = True):
    """Full autoencoder forward (AE training, diagnostics): NHWC geometry ->
    (raw reconstruction NHWC, new state).  ``train`` normalises with batch
    statistics and returns the moved running stats."""
    if preprocess_input:
        x = preprocess(cfg, x)
    x, enc_state = _encoder_forward(cfg, params, state, nchw(x), train)
    new_state = {"encoder": enc_state}
    if cfg.kind == "sauto":
        x, _, new_state["decoder"] = _decoder_layers(
            cfg, params, state, x, len(cfg.up_filters), train)
        if "final" in params["decoder"]:
            x = _reflect_conv(params["decoder"]["final"], x, pad=0)
        return x.permute(0, 2, 3, 1).contiguous(), new_state
    dec_p, dec_s = params["decoder"], state["decoder"]
    dec_state = {}
    x, dec_state["first"] = _single_conv_apply(
        cfg, dec_p["first"], dec_s["first"], x, legacy_order=True,
        train=train)
    for name in _by_res([n for n in dec_p if n.startswith("layer")], 1):
        x, dec_state[name] = _single_conv_apply(
            cfg, dec_p[name], dec_s[name], x, stride=2, pad=1,
            transpose=True, legacy_order=True, train=train)
    new_state["decoder"] = dec_state
    return x.permute(0, 2, 3, 1).contiguous(), new_state


def preprocess_truth(cfg: GeoEncoderConfig, x):
    if (cfg.preproc is not None and "inverse" in cfg.preproc) \
            or cfg.out_channels == 3:
        return 1.0 - x
    return x


def postprocess(cfg: GeoEncoderConfig, y):
    """Raw decoder output (NHWC) -> [0,1] black-on-white reconstruction."""
    y = postprocess_partial(cfg, y)
    if cfg.out_channels == 1:
        y = torch.sigmoid(y + 0.5)
    else:
        y = y[..., 1:]  # background channel (black-on-white default)
    if cfg.preproc is not None and "inverse" in cfg.preproc \
            and cfg.out_channels == 1:
        y = 1.0 - y
    return y


def postprocess_partial(cfg: GeoEncoderConfig, y):
    if cfg.out_channels == 1:
        return y
    if cfg.out_channels == 3:
        p = torch.softmax(y, dim=-1)
        return torch.cat([p[..., :2].sum(dim=-1, keepdim=True), p[..., 2:]],
                         dim=-1)
    raise ValueError(f"unsupported decoder channels {cfg.out_channels}")
