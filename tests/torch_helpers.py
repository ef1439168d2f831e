"""Shared fixtures of the torch-port parity tests: one small engine config
in both packages, and numpy weight trees in the JAX layout for both."""

import contextlib
import dataclasses
import importlib.util
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from brushstroke_engine_tpu.models.generator import make_generator_config
from brushstroke_engine_tpu.models.geo_encoder import GeoEncoderConfig
from brushstroke_engine_tpu.ops.precision import precision_mode
from brushstroke_engine_torch.utils.checkpoint import (
    configs_from_dicts, init_native_params, params_from_jax,
)


def small_configs(img_resolution=32, inject_res=(0, 1), color_format="triad",
                  color_w_channels=0):
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
        color_format=color_format, color_w_channels=color_w_channels,
        channel_base=2048, channel_max=32)
    return gen_cfg, enc_cfg


def small_model(seed=0, noise_strength=0.4, **config):
    """Both packages' configs plus one set of weights for both.

    Weights: ``init_native_params`` (numpy, JAX layout), with non-zero noise
    strengths so the noise path counts and a non-zero ``w_avg`` so
    truncation does.  ``config`` goes to :func:`small_configs`.
    """
    jgen, jenc = small_configs(**config)
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


def jax_draws(seed, num_steps, log_every, shape, n=None):
    """The unit normals of the JAX projection loop's w noise: per chunk of
    ``log_every`` steps ``key, sub = split(key)``; step i of the chunk draws
    from ``fold_in(sub, i)`` (split ``n`` ways in ``project_parallel``).
    ``[num_steps, *shape]`` or ``[num_steps, n, *shape]``."""
    key = jax.random.PRNGKey(seed)
    out, step = [], 0
    while step < num_steps:
        k = min(log_every, num_steps - step)
        key, sub = jax.random.split(key)
        for i in range(k):
            ki = jax.random.fold_in(sub, i)
            if n is None:
                out.append(np.asarray(jax.random.normal(ki, shape)))
            else:
                out.append(np.stack([np.asarray(jax.random.normal(kj, shape))
                                     for kj in jax.random.split(ki, n)]))
        step += k
    return np.stack(out)


def assert_optimized_close(got, want, lr_total, share=0.01):
    """A parameter after a few Adam steps, port against JAX: every entry
    within 1e-4 relative (+1e-5 absolute) but at most ``share`` of them --
    entries whose gradient is rounding noise, which Adam's normalization
    can step by up to the learning rate either way -- and those within the
    summed learning rate ``lr_total``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want)
    loose = err > 1e-4 * np.abs(want) + 1e-5
    assert loose.mean() <= share, (loose.mean(), err.max())
    assert err.max() <= 1e-4 * np.abs(want).max() + lr_total, err.max()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_script(name, argv):
    """The JAX package's ``scripts/<name>.py`` main with ``argv``, strict
    f32; returns its standard output."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    old = sys.argv
    sys.argv = [name] + [str(a) for a in argv]
    try:
        with precision_mode("strict"), contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = old
    return out.getvalue()


def jax_native():
    """The JAX package's ``native`` module with its library loaded.  That
    package builds its library in place, so a test process that loads it
    while another process writes it fails once and keeps the failure: load
    it again before a test needs it."""
    from brushstroke_engine_tpu import native
    if not native.available():
        native._load_failed = False
        native.get_lib()
    assert native.available(), "the JAX package's native library"
    return native
