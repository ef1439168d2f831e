"""Shared fixtures of the torch-port parity tests: one small engine config
in both packages, and numpy weight trees in the JAX layout for both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from brushstroke_engine_tpu.models.generator import make_generator_config
from brushstroke_engine_tpu.models.geo_encoder import GeoEncoderConfig
from brushstroke_engine_torch.utils.checkpoint import (
    configs_from_dicts, init_native_params, params_from_jax,
)


def small_configs(img_resolution=32, inject_res=(0, 1)):
    """The JAX package's ``tests.helpers.small_bundle`` configs (2-layer
    'sauto' encoder, 16-dim styles, <= 32 channels), without its init."""
    enc_cfg = GeoEncoderConfig(
        kind="sauto", in_channels=1, out_channels=1, preproc="-11inverse",
        pre_filters=8, down_filters=(16, 16), post_filters=(8,),
        up_filters=(16, 8))
    gen_cfg = make_generator_config(
        z_dim=16, w_dim=16, img_resolution=img_resolution,
        geom_feature_resolutions=tuple(
            enc_cfg.featuremap_resolution(img_resolution, r)
            for r in inject_res),
        geom_feature_channels=tuple(enc_cfg.feature_channels(r)
                                    for r in inject_res),
        color_format="triad", channel_base=2048, channel_max=32)
    return gen_cfg, enc_cfg


def small_model(seed=0, noise_strength=0.4):
    """Both packages' configs plus one set of weights for both.

    Weights: ``init_native_params`` (numpy, JAX layout), with non-zero noise
    strengths so the noise path counts and a non-zero ``w_avg`` so
    truncation does.
    """
    jgen, jenc = small_configs()
    tgen, tenc = configs_from_dicts(dataclasses.asdict(jgen),
                                    dataclasses.asdict(jenc))
    trees = init_native_params(tgen, tenc, seed=seed)
    for block in trees["gen_params"]["synthesis"].values():
        for name in ("conv0", "conv1"):
            if name in block:
                block[name]["noise_strength"] = np.float32(noise_strength)
    trees["gen_state"]["w_avg"] = np.random.RandomState(seed + 1).randn(
        tgen.w_dim).astype(np.float32)
    return dict(jax_cfg=(jgen, jenc), cfg=(tgen, tenc), np=trees,
                jax=jax.tree_util.tree_map(jnp.asarray, trees),
                torch={k: params_from_jax(v) for k, v in trees.items()})


def replay_augment_draws(cfg, key, batch, shape):
    """The raw draws that the JAX ``augment_pipe(cfg, key, images, p)``
    makes for ``images [batch, *shape]``, as the port's ``draws`` dict:
    the key is split and consumed exactly as in
    ``brushstroke_engine_tpu/train/augment.py``."""
    import torch
    from brushstroke_engine_torch.train.augment import draw_spec

    fns = {"uniform": jax.random.uniform, "normal": jax.random.normal}
    ki = iter(jax.random.split(key, 40))
    filter_keys = None
    draws = {}
    for name, kind, shp in draw_spec(cfg, batch, shape):
        if name.startswith("imgfilter"):
            # _imgfilter takes ONE key and splits it 2 * bands ways.
            if filter_keys is None:
                filter_keys = iter(jax.random.split(next(ki), 8))
            k = next(filter_keys)
        else:
            k = next(ki)
        draws[name] = torch.from_numpy(np.array(fns[kind](k, shp)))
    return draws
