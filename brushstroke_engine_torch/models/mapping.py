"""Mapping network z (+c) -> w.

Counterpart of ``brushstroke_engine_tpu/models/mapping.py``.  The w-average
EMA is explicit state: :func:`mapping_apply` reads it from the generator
state (truncation), and :func:`update_w_avg` gives its next value for a
training step.  With ``c_dim > 0`` the label goes through the ``embed`` FC
and is normalised and concatenated after z (``z_dim = 0``: the label alone,
as the conditional discriminator's ``cmap`` mapping runs it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from brushstroke_engine_torch.parallel.distributed import \
    batch_mean as global_batch_mean
from brushstroke_engine_torch.models.layers import fc_apply, \
    normalize_2nd_moment


@dataclass(frozen=True)
class MappingConfig:
    z_dim: int
    c_dim: int
    w_dim: int
    num_ws: Optional[int]        # None = no broadcast.
    num_layers: int = 8
    embed_features: Optional[int] = None
    layer_features: Optional[int] = None
    activation: str = "lrelu"
    lr_multiplier: float = 0.01
    w_avg_beta: Optional[float] = 0.995

    @property
    def features_list(self):
        embed = self.embed_features
        if embed is None:
            embed = self.w_dim
        if self.c_dim == 0:
            embed = 0
        layer = self.layer_features or self.w_dim
        return ([self.z_dim + embed] + [layer] * (self.num_layers - 1)
                + [self.w_dim])

    @property
    def embed_dim(self):
        return 0 if self.c_dim == 0 else (self.embed_features or self.w_dim)


def _map_w(cfg: MappingConfig, params, z, c=None):
    """z ``[B, z_dim]`` and c ``[B, c_dim]`` -> w ``[B, w_dim]`` (before
    broadcast/truncation)."""
    x = None
    if cfg.z_dim > 0:
        x = normalize_2nd_moment(z.float())
    if cfg.c_dim > 0:
        y = normalize_2nd_moment(fc_apply(params["embed"], c.float()))
        x = y if x is None else torch.cat([x, y], dim=1)
    for i in range(cfg.num_layers):
        x = fc_apply(params[f"fc{i}"], x, activation=cfg.activation,
                     lr_multiplier=cfg.lr_multiplier)
    return x


def update_w_avg(cfg: MappingConfig, w, w_avg):
    """Next value of the w-average EMA from a batch of mapped ``w [B, w_dim]``
    (or broadcast ``ws [B, num_ws, w_dim]``); no gradient flows through it."""
    if cfg.w_avg_beta is None:
        return w_avg
    if w.dim() == 3:
        w = w[:, 0]
    # The global batch's mean under a data-parallel group.
    batch_mean = global_batch_mean(w.detach(), dim=0)
    return batch_mean + (w_avg - batch_mean) * cfg.w_avg_beta


def mapping_apply(cfg: MappingConfig, params, z, c=None, *, w_avg=None,
                  truncation_psi: float = 1.0,
                  truncation_cutoff: Optional[int] = None):
    """Returns ws ``[B, num_ws, w_dim]`` (or w ``[B, w_dim]``)."""
    x = _map_w(cfg, params, z, c)

    if cfg.num_ws is not None:
        x = x[:, None, :].expand(-1, cfg.num_ws, -1)

    if truncation_psi != 1.0:
        assert w_avg is not None
        if cfg.num_ws is None or truncation_cutoff is None:
            x = w_avg + (x - w_avg) * truncation_psi
        else:
            trunc = w_avg + (x[:, :truncation_cutoff] - w_avg) * truncation_psi
            x = torch.cat([trunc, x[:, truncation_cutoff:]], dim=1)
    return x
