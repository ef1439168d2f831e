"""StyleGAN2 discriminator ('orig' and 'resnet' architectures).

Counterpart of ``brushstroke_engine_tpu/models/discriminator.py``: blocks
with FIR-filtered downsampling, minibatch-stddev, and the epilogue FC.
Activations are NHWC, conv weights OIHW, FC weights ``[out, in]``; the
epilogue flattens NHWC like the JAX package, so its ``b4.fc`` weight is the
JAX one transposed.  With ``c_dim > 0`` the output has ``cmap`` channels,
projected on the label's embedding by a mapping network with ``z_dim = 0``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from brushstroke_engine_torch.ops import setup_filter
from brushstroke_engine_torch.models.layers import conv_layer_apply, fc_apply
from brushstroke_engine_torch.models.mapping import MappingConfig, \
    mapping_apply


@dataclass(frozen=True)
class DiscriminatorConfig:
    c_dim: int
    img_resolution: int
    img_channels: int
    architecture: str = "resnet"       # 'orig' | 'resnet'
    channel_base: int = 16384
    channel_max: int = 128
    num_bf16_res: int = 0
    conv_clamp: Optional[float] = 256.0
    cmap_dim: Optional[int] = None
    mbstd_group_size: int = 4
    mbstd_num_channels: int = 1
    activation: str = "lrelu"
    resample_taps: Tuple[int, ...] = (1, 3, 3, 1)

    @property
    def block_resolutions(self) -> Tuple[int, ...]:
        n = int(math.log2(self.img_resolution))
        return tuple(2 ** i for i in range(n, 2, -1))

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def cmap(self) -> int:
        if self.c_dim == 0:
            return 0
        return self.cmap_dim if self.cmap_dim is not None else self.channels(4)

    def block_dtype(self, res: int):
        bf16_res = max(2 ** (int(math.log2(self.img_resolution)) + 1
                             - self.num_bf16_res), 8)
        return torch.bfloat16 if res >= bf16_res else torch.float32

    @property
    def cmap_mapping(self) -> MappingConfig:
        """The label mapping of a conditional D (``c_dim > 0``)."""
        return MappingConfig(z_dim=0, c_dim=self.c_dim, w_dim=self.cmap,
                             num_ws=None, w_avg_beta=None)

    @property
    def resample_filter(self):
        return setup_filter(list(self.resample_taps))


def _minibatch_stddev(x, group_size: int, num_channels: int):
    """Reference MinibatchStdLayer (networks.py:873-894), NHWC."""
    n, h, w, c = x.shape
    g = min(group_size, n) if group_size is not None else n
    f = num_channels
    cc = c // f
    y = x.reshape(g, n // g, h, w, f, cc).float()
    y = y - y.mean(dim=0, keepdim=True)
    y = y.square().mean(dim=0)
    y = torch.sqrt(y + 1e-8)
    y = y.mean(dim=(1, 2, 4))                            # [n//g, F]
    y = y[:, None, None, :].repeat(g, h, w, 1).reshape(n, h, w, f)
    return torch.cat([x, y.to(x.dtype)], dim=-1)


def discriminator_apply(cfg: DiscriminatorConfig, params, img, c=None,
                        force_fp32: bool = False):
    """Returns logits ``[B, 1]``.  img is NHWC in [-1, 1]-ish range; ``c``
    ``[B, c_dim]`` the labels of a conditional D."""
    f = cfg.resample_filter
    x = None
    for res in cfg.block_resolutions:
        bp = params[f"b{res}"]
        dtype = torch.float32 if force_fp32 else cfg.block_dtype(res)
        if res == cfg.img_resolution:
            x = conv_layer_apply(bp["fromrgb"], img.to(dtype),
                                 activation=cfg.activation,
                                 conv_clamp=cfg.conv_clamp)
        else:
            x = x.to(dtype)
        if cfg.architecture == "resnet":
            y = conv_layer_apply(bp["skip"], x, down=2, resample_filter=f,
                                 gain=math.sqrt(0.5))
            x = conv_layer_apply(bp["conv0"], x, activation=cfg.activation,
                                 conv_clamp=cfg.conv_clamp)
            x = conv_layer_apply(bp["conv1"], x, activation=cfg.activation,
                                 down=2, resample_filter=f,
                                 conv_clamp=cfg.conv_clamp,
                                 gain=math.sqrt(0.5))
            x = y + x
        else:
            x = conv_layer_apply(bp["conv0"], x, activation=cfg.activation,
                                 conv_clamp=cfg.conv_clamp)
            x = conv_layer_apply(bp["conv1"], x, activation=cfg.activation,
                                 down=2, resample_filter=f,
                                 conv_clamp=cfg.conv_clamp)

    # Epilogue at 4x4 (reference networks.py:899-952).
    x = x.float()
    ep = params["b4"]
    if cfg.mbstd_num_channels > 0:
        x = _minibatch_stddev(x, cfg.mbstd_group_size, cfg.mbstd_num_channels)
    x = conv_layer_apply(ep["conv"], x, activation=cfg.activation,
                         conv_clamp=cfg.conv_clamp)
    x = fc_apply(ep["fc"], x.reshape(x.shape[0], -1),
                 activation=cfg.activation)
    x = fc_apply(ep["out"], x)
    if cfg.cmap > 0:
        cmap = mapping_apply(cfg.cmap_mapping, params["mapping"], None, c)
        x = (x * cmap).sum(dim=1, keepdim=True) / math.sqrt(cfg.cmap)
    return x
