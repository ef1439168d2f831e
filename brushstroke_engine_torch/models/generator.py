"""Geometry-conditioned Generator: mapping + synthesis.

Counterpart of ``brushstroke_engine_tpu/models/generator.py``: the z path
(mapping, truncation, style mixing) and the pre-mapped ws path, with
constant, random or no noise, and the trainable-layer mask of the geometry
phases.  The w-average update is ``models.mapping.update_w_avg`` on the
returned ``ws``.  Positional encoding is not ported yet (a config that asks
for it raises).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from brushstroke_engine_torch.models.mapping import MappingConfig, \
    mapping_apply
from brushstroke_engine_torch.models.synthesis import SynthesisConfig, \
    synthesis_apply


@dataclass(frozen=True)
class GeneratorConfig:
    z_dim: int
    c_dim: int
    w_dim: int
    img_resolution: int
    img_channels: int = 3
    synthesis: SynthesisConfig = None
    mapping_layers: int = 8
    positional_encoding: Optional[str] = None
    posenc_inject_resolutions: Tuple[int, ...] = ()
    posenc_featuremap_mode: str = "fixed"
    posenc_injection_mode: str = "cat"

    @property
    def mapping(self) -> MappingConfig:
        return MappingConfig(z_dim=self.z_dim, c_dim=self.c_dim,
                             w_dim=self.w_dim, num_ws=self.num_ws,
                             num_layers=self.mapping_layers)

    @property
    def num_ws(self) -> int:
        return self.synthesis.num_ws


def make_generator_config(
    z_dim=64, c_dim=0, w_dim=64, img_resolution=128, img_channels=3,
    geom_feature_resolutions=(), geom_feature_channels=(),
    color_format="triad", color_w_channels=0, architecture="orig",
    channel_base=16384, channel_max=128, num_bf16_res=0, conv_clamp=256.0,
    mapping_layers=8,
) -> GeneratorConfig:
    """Build a GeneratorConfig with a consistent SynthesisConfig."""
    syn = SynthesisConfig(
        w_dim=w_dim, img_resolution=img_resolution, img_channels=img_channels,
        geom_feature_resolutions=tuple(geom_feature_resolutions),
        geom_feature_channels=tuple(geom_feature_channels),
        color_format=color_format, color_w_channels=color_w_channels,
        architecture=architecture, channel_base=channel_base,
        channel_max=channel_max, num_bf16_res=num_bf16_res,
        conv_clamp=conv_clamp)
    return GeneratorConfig(
        z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, img_resolution=img_resolution,
        img_channels=img_channels, synthesis=syn,
        mapping_layers=mapping_layers)


def draw_style_mixing(rng, z_shape, device) -> Dict:
    """Raw draws of one style-mixing decision: ``cutoff_u`` and ``apply_u``
    uniform in [0, 1) (0-d) and the second latent ``z2``."""
    gdev = device if rng is None else rng.device
    return {
        "cutoff_u": torch.rand((), generator=rng, device=gdev).to(device),
        "apply_u": torch.rand((), generator=rng, device=gdev).to(device),
        "z2": torch.randn(z_shape, generator=rng, device=gdev).to(device),
    }


def mix_styles(ws, ws2, mixing: Dict, style_mixing_prob: float):
    """``ws`` below the cutoff, ``ws2`` from it on; the cutoff is uniform in
    ``[1, num_ws)`` with probability ``style_mixing_prob``, else ``num_ws``
    (no mixing).  Stays on the device."""
    num_ws = ws.shape[1]
    cutoff = 1 + torch.floor(mixing["cutoff_u"] * (num_ws - 1))
    cutoff = torch.where(mixing["apply_u"] < style_mixing_prob, cutoff,
                         torch.full_like(cutoff, float(num_ws)))
    idx = torch.arange(num_ws, device=ws.device)[None, :, None]
    return torch.where(idx < cutoff, ws, ws2)


def generator_apply(cfg: GeneratorConfig, params, state, *,
                    z=None, ws=None, geom_features=(),
                    positions=None, noise_buffers=None,
                    truncation_psi: float = 1.0,
                    truncation_cutoff: Optional[int] = None,
                    noise_mode: str = "const",
                    rng: Optional[torch.Generator] = None,
                    random_noise: Optional[Dict] = None,
                    return_debug_data: bool = False,
                    return_features: Tuple[int, ...] = (),
                    blended_features: Optional[Dict] = None,
                    style_mixing_prob: float = 0.0,
                    mixing: Optional[Dict] = None,
                    force_fp32: bool = False):
    """Full generator forward.

    Pass ``ws`` for the pre-mapped path or ``z`` for the mapped path.

    Style mixing (z path, ``style_mixing_prob > 0``): layers from a cutoff
    on take the styles of a second z.  ``mixing`` gives the draws explicitly
    (:func:`draw_style_mixing`); without it they come from ``rng``.
    ``rng`` / ``random_noise`` also feed ``noise_mode='random'``.

    Returns (img, debug_data); debug_data is {} unless debug / feature
    outputs were requested.
    """
    if cfg.positional_encoding is not None:
        raise NotImplementedError("positional encoding is not ported yet")
    if ws is None:
        assert z is not None
        ws = mapping_apply(
            cfg.mapping, params["mapping"], z,
            w_avg=state.get("w_avg"), truncation_psi=truncation_psi,
            truncation_cutoff=truncation_cutoff)
        if style_mixing_prob > 0:
            if mixing is None:
                mixing = draw_style_mixing(rng, tuple(z.shape), z.device)
            ws2 = mapping_apply(
                cfg.mapping, params["mapping"], mixing["z2"],
                w_avg=state.get("w_avg"), truncation_psi=truncation_psi,
                truncation_cutoff=truncation_cutoff)
            ws = mix_styles(ws, ws2, mixing, style_mixing_prob)

    out = synthesis_apply(
        cfg.synthesis, params["synthesis"], ws, geom_features,
        noise=state.get("noise"), noise_buffers=noise_buffers,
        positions=positions, noise_mode=noise_mode, rng=rng,
        random_noise=random_noise, force_fp32=force_fp32,
        return_debug_data=return_debug_data,
        return_features=tuple(return_features),
        blended_features=blended_features)

    if return_debug_data or return_features:
        img, debug = out
        if return_debug_data:
            debug["ws"] = ws
    else:
        img, debug = out, {}
    return img, debug


def generator_trainable_mask(cfg: GeneratorConfig, params,
                             mode="all") -> Dict:
    """Boolean tree mask for partial training (reference
    set_trainable_layers, networks_modified.py:285-318).

    Modes (string or list): 'all', 'rgb', 'last_and_rgb', 'linear',
    'all_but_linear'.
    """
    modes = mode if isinstance(mode, (list, tuple)) else [mode]
    last = f"b{cfg.img_resolution}"

    def deep(d, value):
        return {k: deep(v, value) if isinstance(v, dict) else value
                for k, v in d.items()}

    mask = deep(params, False)
    for m in modes:
        if m in ("all", "all_but_linear"):     # geom_linear does not exist
            mask = deep(params, True)
        elif m == "rgb":
            mask["synthesis"][last]["torgb"] = deep(
                params["synthesis"][last]["torgb"], True)
        elif m == "last_and_rgb":
            mask["synthesis"][last] = deep(params["synthesis"][last], True)
        elif m == "linear":
            pass                               # geom_linear does not exist
        else:
            raise ValueError(f"unknown trainable mode {m!r}")
    return mask
