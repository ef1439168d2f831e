"""Flagship model configuration: the canonical NeuBE brush engine.

The port's copy of the configs of ``brushstroke_engine_tpu/flagship.py``:
z = w = 64, channel_base 16384, channel_max 128, the color-triad head, the
default 'sauto' geometry encoder, geometry injected at encoder resolutions
(0, 1).  256 px is the high-resolution painting engine; 128 px at batch 64
is the canonical training configuration (:func:`flagship_train_config`).
"""

from __future__ import annotations

import numpy as np

from brushstroke_engine_torch.engine.brush import TriadGanPaintEngine
from brushstroke_engine_torch.models.generator import (
    GeneratorConfig, make_generator_config,
)
from brushstroke_engine_torch.models.discriminator import DiscriminatorConfig
from brushstroke_engine_torch.models.geo_encoder import GeoEncoderConfig
from brushstroke_engine_torch.train.augment import AugmentConfig
from brushstroke_engine_torch.train.state import TrainConfig, \
    init_train_state
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
    _set_noise_strength(trees, noise_strength)
    return trees


def _set_noise_strength(trees, noise_strength: float):
    for block in trees["gen_params"]["synthesis"].values():
        for name in ("conv0", "conv1"):
            if name in block:
                block[name]["noise_strength"] = np.float32(noise_strength)


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


def flagship_train_config(img_resolution: int = 128, batch_size: int = 64,
                          **overrides) -> TrainConfig:
    """The canonical training configuration (``train_flags.txt`` and the
    defaults of ``scripts/train_main.py``): 128 px, batch 64, z = w = 64,
    channel_max 128, triad head, 'orig' discriminator, 'sauto' encoder
    injected at (0, 1), ADA with the 'bgc' pipe, random synthesis noise, style mixing 0.9, R1 gamma
    0.0002 * res^2 / batch, EMA half-life batch * 10 / 32 kimg with ramp-up
    0.05.  ``overrides`` replace ``TrainConfig`` fields (schedules, a run's
    length)."""
    kw = dict(
        gen_cfg=flagship_generator_config(img_resolution, (0, 1)),
        disc_cfg=DiscriminatorConfig(
            c_dim=0, img_resolution=img_resolution, img_channels=3,
            architecture="orig", channel_base=16384, channel_max=128),
        enc_cfg=flagship_encoder_config(), enc_res=(0, 1),
        batch_size=batch_size, g_lr=2e-4, d_lr=2e-4, geom_lr=2e-4,
        r1_gamma=0.0002 * img_resolution ** 2 / batch_size,
        noise_mode="random", style_mixing_prob=0.9,
        main_phase_losses="",
        geom_phase_losses="1.0*iou_inv(uvs)",
        geom_warmstart_losses="1.0*iou_inv(uvs)+1.0*iou(u)",
        geom_interval=200, geom_phase_mode="last_and_rgb",
        geom_warmstart_mode="last_and_rgb", geom_warmstart_kimg=50,
        augment=AugmentConfig.from_spec("bgc"),
        ema_kimg=batch_size * 10.0 / 32.0, ema_rampup=0.05,
        total_kimg=10000)
    kw.update(overrides)
    return TrainConfig(**kw)


def flagship_train_setup(cfg: TrainConfig, seed: int = 0,
                         noise_strength: float = 0.0, device="cuda"):
    """(train state, enc_params, enc_state) on ``device`` with random
    weights from the numpy ``seed``; ``noise_strength`` as in
    :func:`flagship_trees`."""
    trees = init_native_params(cfg.gen_cfg, cfg.enc_cfg, seed=seed,
                               disc_cfg=cfg.disc_cfg)
    _set_noise_strength(trees, noise_strength)
    t = {k: params_from_jax(v) for k, v in trees.items()}
    state = init_train_state(cfg, seed, g_params=t["gen_params"],
                             g_state=t["gen_state"],
                             d_params=t["disc_params"], device=device)
    return state, t["enc_params"], t["enc_state"]


def synthetic_data_iters(img_resolution: int, batch_size: int, seed: int = 0,
                         geom_items: int = 64):
    """(style_iter, geom_iter) of a run without datasets, as the training
    script builds them: noise style images at the training resolution and
    synthetic spline geometry 64 px larger (the loop crops it).  The
    geometry set is small and cached, since rasterizing one item takes
    longer than a training batch.  Both start prefetching at once."""
    from brushstroke_engine_torch.train.dataset import (
        BatchIterator, CachedDataset, NoiseStyleDataset,
        SyntheticGeometryDataset,
    )
    style_ds = NoiseStyleDataset(img_resolution, seed=seed)
    geom_ds = CachedDataset(SyntheticGeometryDataset(
        img_resolution + 64, size=geom_items, seed=seed))
    return (BatchIterator(style_ds, batch_size, seed=seed),
            BatchIterator(geom_ds, batch_size, seed=seed + 1))
