"""Flagship model configuration: the canonical NeuBE brush engine.

The port's copy of the configs of ``brushstroke_engine_tpu/flagship.py``:
z = w = 64, channel_base 16384, channel_max 128, the color-triad head, the
default 'sauto' geometry encoder, geometry injected at encoder resolutions
(0, 1).  256 px is the high-resolution painting engine.
"""

from __future__ import annotations

import numpy as np

from brushstroke_engine_torch.engine.brush import TriadGanPaintEngine
from brushstroke_engine_torch.models.generator import (
    GeneratorConfig, make_generator_config,
)
from brushstroke_engine_torch.models.geo_encoder import GeoEncoderConfig
from brushstroke_engine_torch.utils.checkpoint import (
    init_native_params, params_from_jax,
)


def flagship_encoder_config() -> GeoEncoderConfig:
    return GeoEncoderConfig(
        kind="sauto", in_channels=1, out_channels=1, preproc="-11inverse",
        pre_filters=64, down_filters=(128, 256, 256), post_filters=(32, 16),
        up_filters=(256, 128, 64))


def flagship_generator_config(img_resolution: int = 128,
                              inject_res=(0, 1),
                              num_bf16_res: int = 0) -> GeneratorConfig:
    enc = flagship_encoder_config()
    geom_res = tuple(enc.featuremap_resolution(img_resolution, r)
                     for r in inject_res)
    geom_ch = tuple(enc.feature_channels(r) for r in inject_res)
    return make_generator_config(
        z_dim=64, w_dim=64, img_resolution=img_resolution,
        geom_feature_resolutions=geom_res, geom_feature_channels=geom_ch,
        color_format="triad", channel_base=16384, channel_max=128,
        num_bf16_res=num_bf16_res)


def flagship_trees(img_resolution: int = 256, seed: int = 0,
                   noise_strength: float = 0.0):
    """Random flagship weights in the JAX layout (``init_native_params``).

    Init leaves every ``noise_strength`` at 0; a non-zero value makes the
    constant noise count in the render, as it does in a trained model.
    """
    trees = init_native_params(flagship_generator_config(img_resolution),
                               flagship_encoder_config(), seed=seed)
    for block in trees["gen_params"]["synthesis"].values():
        for name in ("conv0", "conv1"):
            if name in block:
                block[name]["noise_strength"] = np.float32(noise_strength)
    return trees


def flagship_engine(trees, img_resolution: int = 256, num_bf16_res: int = 0,
                    device="cuda") -> TriadGanPaintEngine:
    """Triad engine over JAX-layout ``trees``, through ``params_from_jax``
    as a loaded bundle would be."""
    t = {k: params_from_jax(v) for k, v in trees.items()}
    return TriadGanPaintEngine(
        flagship_generator_config(img_resolution, (0, 1), num_bf16_res),
        t["gen_params"], t["gen_state"], flagship_encoder_config(),
        t["enc_params"], t["enc_state"], geom_inject_resolutions=(0, 1),
        device=device)
