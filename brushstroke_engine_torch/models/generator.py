"""Geometry-conditioned Generator: mapping + synthesis.

Counterpart of ``brushstroke_engine_tpu/models/generator.py`` for rendering:
the z path (mapping, truncation) and the pre-mapped ws path, with constant
(or no) noise.  Style mixing, random noise and w-average updates belong to
training; positional encoding is not ported yet (a config that asks for it
raises).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

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


def generator_apply(cfg: GeneratorConfig, params, state, *,
                    z=None, ws=None, geom_features=(),
                    positions=None, noise_buffers=None,
                    truncation_psi: float = 1.0,
                    truncation_cutoff: Optional[int] = None,
                    noise_mode: str = "const",
                    return_debug_data: bool = False,
                    return_features: Tuple[int, ...] = (),
                    blended_features: Optional[Dict] = None):
    """Full generator forward.

    Pass ``ws`` for the pre-mapped path or ``z`` for the mapped path.

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

    out = synthesis_apply(
        cfg.synthesis, params["synthesis"], ws, geom_features,
        noise=state.get("noise"), noise_buffers=noise_buffers,
        positions=positions, noise_mode=noise_mode,
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
