"""Geometry (stroke) autoencoder: encodes a black-on-white stroke patch into
multi-resolution feature maps that condition the GAN trunk.

Counterpart of ``brushstroke_engine_tpu/models/geo_encoder.py`` for the
render: the 'sauto' encoder in eval mode (BatchNorm from running stats),
both layer orders, bilinear (align_corners) and transposed-conv
(``scale_up_v2``) decoder up-layers.  Inputs and outputs are NHWC; inside,
the convs run on NCHW views.  Conv weights are OIHW for every layer, the
transposed ones included (the JAX package stores them HWIO like the others).
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


def _bn_eval(p, s, x, eps: float = 1e-5):
    def ch(v):
        return v.to(x.dtype)[None, :, None, None]
    inv = torch.rsqrt(s["var"] + eps)
    return (x - ch(s["mean"])) * ch(inv) * ch(p["scale"]) + ch(p["bias"])


def _lrelu(x, neg_slope: Optional[float]):
    return F.leaky_relu(x, 0.01 if neg_slope is None else neg_slope)


def upsample_bilinear_align_corners(x, factor: int = 2):
    """Bilinear upsample of NCHW ``x`` with align_corners=True semantics."""
    return F.interpolate(x, scale_factor=factor, mode="bilinear",
                         align_corners=True)


def _single_conv_apply(cfg, p, s, x, *, stride=1, pad=1, transpose=False,
                       legacy_order=None):
    """conv (+BN +LeakyReLU in config-dependent order), eval mode."""
    if transpose:
        x = _conv_transpose(p["conv"], x, stride=stride, pad=pad)
    else:
        x = _reflect_conv(p["conv"], x, stride=stride, pad=pad)
    after_act = cfg.batchnorm_after_activation if legacy_order is None \
        else legacy_order
    if after_act:
        return _bn_eval(p["bn"], s["bn"], _lrelu(x, cfg.neg_slope))
    return _lrelu(_bn_eval(p["bn"], s["bn"], x), cfg.neg_slope)


def _encoder_forward(cfg, params, state, x):
    names = sorted(params["encoder"].keys(),
                   key=lambda n: int(n.replace("layer", "")))
    n_pre = 1 if cfg.pre_filters > 0 else 0
    n_down = len(cfg.down_filters)
    for i, name in enumerate(names):
        stride = 2 if n_pre <= i < n_pre + n_down else 1
        pad = 3 if (i == 0 and n_pre) else 1
        x = _single_conv_apply(cfg, params["encoder"][name],
                               state["encoder"][name], x,
                               stride=stride, pad=pad)
    return x


def _decoder_layers(cfg, params, state, x, nlayers):
    """Run the first ``nlayers`` decoder up-layers, returning intermediates."""
    results = []
    if "first" in params["decoder"]:
        x = _single_conv_apply(cfg, params["decoder"]["first"],
                               state["decoder"]["first"], x, legacy_order=True)
    for i in range(nlayers):
        p, s = params["decoder"][f"up{i}"], state["decoder"][f"up{i}"]
        if cfg.scale_up_v2:
            x = _single_conv_apply(cfg, p, s, x, stride=2, pad=1,
                                   transpose=True, legacy_order=True)
        else:
            x = upsample_bilinear_align_corners(x)
            x = _single_conv_apply(cfg, p, s, x, legacy_order=False)
        results.append(x)
    return results


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
      res: resolutions to return (0 = bottleneck, 1 = one decoder layer up).

    Returns:
      list of ``[B, h_i, w_i, c_i]`` f32 feature maps (NHWC).
    """
    if cfg.kind != "sauto":
        raise NotImplementedError(f"the {cfg.kind!r} encoder is not ported")
    if isinstance(res, int):
        res = [res]
    x = nchw(preprocess(cfg, geom))
    # In 'fast' mode the frozen encoder runs in bf16, as in the JAX package.
    if get_precision_mode() == "fast":
        x = x.to(torch.bfloat16)
    encoding = _encoder_forward(cfg, params, state, x)
    results = [encoding]
    if max(res) > 0:
        results += _decoder_layers(cfg, params, state, encoding, max(res))
    return [results[r].float().permute(0, 2, 3, 1).contiguous() for r in res]
