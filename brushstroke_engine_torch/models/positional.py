"""Positional encoders for patch-position conditioning.

Counterpart of ``brushstroke_engine_tpu/models/positional.py`` (reference:
forger/train/positional.py:20-143): grid (normalized xy), sinusoidal tables
and simple periodic encodings, plus the per-pixel :func:`encode_grid` of the
'varying' featuremap mode.  Positions are integer tensors; the tables are
built in numpy and indexed on the positions' device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class PositionalEncoderConfig:
    kind: str                 # 'grid' | 'sine' | 'simplesine'
    resolution: int
    sine_channels: int = 0    # for kind == 'sine'

    @property
    def out_channels(self) -> int:
        if self.kind == "grid":
            return 2
        if self.kind == "sine":
            return self.sine_channels
        if self.kind == "simplesine":
            return 4
        raise ValueError(self.kind)

    @staticmethod
    def from_string(spec: str, resolution: int) -> "PositionalEncoderConfig":
        """Parse the reference flag format: 'grid', 'sine:<ch>', 'simplesine'."""
        if spec == "grid":
            return PositionalEncoderConfig("grid", resolution)
        if spec.startswith("sine"):
            ch = int(spec.split(":")[-1])
            return PositionalEncoderConfig("sine", resolution, ch)
        if spec == "simplesine":
            return PositionalEncoderConfig("simplesine", resolution)
        raise ValueError(f"unknown positional encoding {spec!r}")


def _sine_table(cfg: PositionalEncoderConfig) -> np.ndarray:
    enc_len = cfg.out_channels // 2
    position = np.arange(cfg.resolution)[:, None]
    div = np.exp(np.arange(0, enc_len, 2) * (-math.log(10000.0) / enc_len))
    pe = np.zeros((cfg.resolution, enc_len), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def _simplesine_table(cfg: PositionalEncoderConfig) -> np.ndarray:
    position = (np.arange(cfg.resolution, dtype=np.float32)
                / cfg.resolution * 2 * np.pi)
    return np.stack([np.cos(position), np.sin(position)], axis=1)


def encode_position(cfg: PositionalEncoderConfig, pos):
    """Integer positions -> ``[..., out_channels // 2]`` f32."""
    pos = torch.remainder(pos.long(), cfg.resolution)
    if cfg.kind == "grid":
        return (2.0 * pos.float() / (cfg.resolution - 1) - 1.0)[..., None]
    table = _sine_table(cfg) if cfg.kind == "sine" else _simplesine_table(cfg)
    return torch.from_numpy(table).to(pos.device)[pos]


def encode_xy(cfg: PositionalEncoderConfig, x, y):
    """(x, y) -> ``[..., out_channels]`` (reference forward, positional.py:65)."""
    return torch.cat([encode_position(cfg, x), encode_position(cfg, y)],
                     dim=-1)


def encode_grid(cfg: PositionalEncoderConfig, start_x, start_y,
                resolution: int):
    """Per-pixel encodings of a patch grid ('varying' featuremap mode):
    ``[B] int`` starts -> ``[B, resolution, resolution, out_channels]``
    (NHWC; the reference returns NCHW, positional.py:39-63)."""
    increment = cfg.resolution // resolution
    shift = torch.arange(0, increment * resolution, increment,
                         device=start_x.device)
    ex = encode_position(cfg, start_x.long()[:, None] + shift[None, :])
    ey = encode_position(cfg, start_y.long()[:, None] + shift[None, :])
    b, r = ex.shape[0], resolution
    return torch.cat([ex[:, None, :, :].expand(b, r, r, ex.shape[-1]),
                      ey[:, :, None, :].expand(b, r, r, ey.shape[-1])],
                     dim=-1)
