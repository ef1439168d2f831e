"""Geometry-conditioned Generator: mapping + synthesis + positional encoding.

Counterpart of ``brushstroke_engine_tpu/models/generator.py``: the z (+c)
path (mapping, truncation, style mixing) and the pre-mapped ws path, with
constant, random or no noise, the per-resolution positional encodings of
the patch position, and the trainable-layer mask of the geometry phases.
The w-average update is ``models.mapping.update_w_avg`` on the returned
``ws``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from brushstroke_engine_torch.models import positional
from brushstroke_engine_torch.models.mapping import MappingConfig, \
    mapping_apply
from brushstroke_engine_torch.models.synthesis import SynthesisConfig, \
    synthesis_apply
from brushstroke_engine_torch.parallel.distributed import draw_rows


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
    def pos_encoder(self) -> Optional[positional.PositionalEncoderConfig]:
        if self.positional_encoding is None:
            return None
        return positional.PositionalEncoderConfig.from_string(
            self.positional_encoding, self.img_resolution)

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
    mapping_layers=8, positional_encoding=None, posenc_inject_resolutions=(),
    posenc_featuremap_mode="fixed", posenc_injection_mode="cat",
) -> GeneratorConfig:
    """Build a GeneratorConfig with a consistent SynthesisConfig.

    ``posenc_inject_resolutions`` uses the reference index convention
    (0 -> 4px, 1 -> 8px, ...; networks_modified.py:276-277).
    """
    pos_res = tuple(2 ** (2 + r) for r in posenc_inject_resolutions)
    enc_ch = 0
    if positional_encoding is not None:
        enc_ch = positional.PositionalEncoderConfig.from_string(
            positional_encoding, img_resolution).out_channels
    syn = SynthesisConfig(
        w_dim=w_dim, img_resolution=img_resolution, img_channels=img_channels,
        geom_feature_resolutions=tuple(geom_feature_resolutions),
        geom_feature_channels=tuple(geom_feature_channels),
        color_format=color_format, color_w_channels=color_w_channels,
        architecture=architecture, channel_base=channel_base,
        channel_max=channel_max, num_bf16_res=num_bf16_res,
        conv_clamp=conv_clamp, pos_encoding_channels=enc_ch,
        pos_encoding_resolutions=pos_res,
        pos_encoding_injection_mode=posenc_injection_mode)
    return GeneratorConfig(
        z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, img_resolution=img_resolution,
        img_channels=img_channels, synthesis=syn,
        mapping_layers=mapping_layers,
        positional_encoding=positional_encoding,
        posenc_inject_resolutions=tuple(posenc_inject_resolutions),
        posenc_featuremap_mode=posenc_featuremap_mode,
        posenc_injection_mode=posenc_injection_mode)


def generate_positional_encoding(cfg: GeneratorConfig, positions, batch: int,
                                 rng: Optional[torch.Generator] = None,
                                 device=None):
    """The per-resolution positional encodings (networks_modified.py:320),
    NHWC, or None without positional encoding.  ``positions`` ``[B, 2]`` int
    (y, x); without them they are drawn uniform in ``[0, img_resolution)``
    from ``rng``."""
    enc_cfg = cfg.pos_encoder
    if enc_cfg is None:
        return None
    if positions is None:
        if rng is None:
            raise ValueError("positional encoding needs positions or an rng")
        positions = draw_rows(
            lambda s, **kw: torch.randint(0, cfg.img_resolution, s, **kw),
            (batch, 2), generator=rng, device=rng.device)
    positions = torch.as_tensor(positions, device=device)
    fmaps = [2 ** (2 + r) for r in cfg.posenc_inject_resolutions]
    if cfg.posenc_featuremap_mode == "fixed":
        # One encoding per patch, broadcast over the feature map.
        enc = positional.encode_xy(enc_cfg, positions[:, 1], positions[:, 0])
        return [enc[:, None, None, :].expand(batch, f, f, enc.shape[-1])
                for f in fmaps]
    if cfg.posenc_featuremap_mode == "varying":
        return [positional.encode_grid(enc_cfg, positions[:, 1],
                                       positions[:, 0], f) for f in fmaps]
    raise ValueError(cfg.posenc_featuremap_mode)


def draw_style_mixing(rng, z_shape, device) -> Dict:
    """Raw draws of one style-mixing decision: ``cutoff_u`` and ``apply_u``
    uniform in [0, 1) (0-d) and the second latent ``z2``."""
    gdev = device if rng is None else rng.device
    return {
        "cutoff_u": torch.rand((), generator=rng, device=gdev).to(device),
        "apply_u": torch.rand((), generator=rng, device=gdev).to(device),
        "z2": draw_rows(torch.randn, z_shape, generator=rng,
                        device=gdev).to(device),
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
                    z=None, c=None, ws=None, geom_features=(),
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

    Pass ``ws`` for the pre-mapped path or ``z`` (and the label ``c`` of a
    class-conditional mapping) for the mapped path.  With positional
    encoding, ``positions`` also place the encodings; without them the
    positions are drawn from ``rng``.

    Style mixing (z path, ``style_mixing_prob > 0``): layers from a cutoff
    on take the styles of a second z.  ``mixing`` gives the draws explicitly
    (:func:`draw_style_mixing`); without it they come from ``rng``.
    ``rng`` / ``random_noise`` also feed ``noise_mode='random'``.

    Returns (img, debug_data); debug_data is {} unless debug / feature
    outputs were requested.
    """
    if ws is None:
        assert z is not None
        ws = mapping_apply(
            cfg.mapping, params["mapping"], z, c,
            w_avg=state.get("w_avg"), truncation_psi=truncation_psi,
            truncation_cutoff=truncation_cutoff)
        if style_mixing_prob > 0:
            if mixing is None:
                mixing = draw_style_mixing(rng, tuple(z.shape), z.device)
            ws2 = mapping_apply(
                cfg.mapping, params["mapping"], mixing["z2"], c,
                w_avg=state.get("w_avg"), truncation_psi=truncation_psi,
                truncation_cutoff=truncation_cutoff)
            ws = mix_styles(ws, ws2, mixing, style_mixing_prob)

    pos_encoding = generate_positional_encoding(
        cfg, positions, ws.shape[0], rng=rng, device=ws.device)
    out = synthesis_apply(
        cfg.synthesis, params["synthesis"], ws, geom_features,
        noise=state.get("noise"), noise_buffers=noise_buffers,
        positions=positions, pos_encoding=pos_encoding,
        noise_mode=noise_mode, rng=rng,
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
