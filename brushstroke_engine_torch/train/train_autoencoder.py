"""Standalone geometry-autoencoder training.

Counterpart of ``brushstroke_engine_tpu/train/train_autoencoder.py``
(reference: forger/train/train_stroke_autoencoder.py): random same-size
crops of triband geometry (G channel = input, B channel = truth), BCE with
logits with optional FG/BG-balanced weights, Adam, and checkpoints.  One
step (:func:`make_ae_train_step`) is the forward with BatchNorm on batch
statistics, the loss, its gradient and the Adam update.

Checkpoints (:func:`save_ae_checkpoint`) are the JAX package's format: a
pickle of the config as a dict and numpy trees in the JAX layout, which
either package's ``load_ae_checkpoint`` reads.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import zipfile
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from brushstroke_engine_torch.models.geo_encoder import (
    GeoEncoderConfig, geo_encoder_apply, preprocess, preprocess_truth,
)
from brushstroke_engine_torch.train.state import Adam
from brushstroke_engine_torch.utils.checkpoint import (
    init_encoder_trees, params_from_jax, params_to_jax,
)
from brushstroke_engine_torch.utils.util import (
    resolve_device, tree_leaves, tree_to, tree_unflatten,
)

logger = logging.getLogger(__name__)

AE_MAGIC = "brushstroke_engine_tpu.geo_encoder.v1"


@dataclass(frozen=True)
class AETrainConfig:
    enc_cfg: GeoEncoderConfig = GeoEncoderConfig(preproc="-11inverse")
    batch_size: int = 16
    learning_rate: float = 1e-3
    num_steps: int = 10000
    widths: tuple = (128,)            # random crop widths (multi-scale)
    balanced_bce: bool = True         # FG/BG-balanced loss weighting
    eval_every: int = 500
    checkpoint_every: int = 1000


def bce_with_logits(logits, targets, weights=None):
    loss = logits.clamp_min(0) - logits * targets + \
        torch.log1p(torch.exp(-logits.abs()))
    if weights is not None:
        return (loss * weights).sum() / weights.sum().clamp_min(1)
    return loss.mean()


def ae_loss(cfg: AETrainConfig, params, state, geom_input, geom_truth):
    """(loss, new BN state) of one batch: ``geom_input`` / ``geom_truth``
    ``[B, W, W, 1]`` in [0, 1] (1 = background)."""
    enc_cfg = cfg.enc_cfg
    logits, new_state = geo_encoder_apply(
        enc_cfg, params, state, preprocess(enc_cfg, geom_input), train=True,
        preprocess_input=False)
    target = preprocess_truth(enc_cfg, geom_truth)
    if enc_cfg.out_channels == 1:
        # Bias-centered sigmoid output (reference base.py:77).
        weights = None
        if cfg.balanced_bce:
            fg = (target < 0.5).float()
            n_fg = fg.sum().clamp_min(1)
            n_bg = (1 - fg).sum().clamp_min(1)
            weights = fg / n_fg + (1 - fg) / n_bg
        return bce_with_logits(logits + 0.5, target, weights), new_state
    # 3-channel decoder: softmax FG/FG/BG (reference base.py:84).
    labels = (target > 0.5).long()[..., 0] * 2
    return F.cross_entropy(logits.permute(0, 3, 1, 2), labels), new_state


def make_ae_train_step(cfg: AETrainConfig):
    """Returns ``(step, opt)``: ``step(params, state, opt_state, geom_input,
    geom_truth) -> (params, state, opt_state, loss)`` leaves its inputs as
    they are; ``opt`` is ``optax.adam(learning_rate)``'s counterpart."""
    opt = Adam(lr=cfg.learning_rate, b1=0.9, b2=0.999)

    def step(params, state, opt_state, geom_input, geom_truth):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        trainable = tree_unflatten(params, leaves)
        loss, new_state = ae_loss(cfg, trainable, state, geom_input,
                                  geom_truth)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        updates, opt_state = opt.update(grads, opt_state)
        new = torch._foreach_add([p.detach() for p in leaves],
                                 tree_leaves(updates))
        return (tree_unflatten(params, new), new_state, opt_state,
                loss.detach())

    return step, opt


def random_crop_batch(tri_batch: np.ndarray, width: int,
                      rng: np.random.Generator):
    """Random same-size crops (multi-width handled by caller)."""
    h, w = tri_batch.shape[1:3]
    y = int(rng.integers(0, max(h - width, 0) + 1))
    x = int(rng.integers(0, max(w - width, 0) + 1))
    return tri_batch[:, y:y + width, x:x + width]


def init_ae(enc_cfg: GeoEncoderConfig, seed: int = 0, device="cuda"):
    """Random (params, state) of the encoder from ``RandomState(seed)`` (the
    shapes and distributions of the JAX ``geo_encoder_init``)."""
    dev = resolve_device(device)
    params, state = init_encoder_trees(enc_cfg, seed)
    return (tree_to(params_from_jax(params), dev),
            tree_to(params_from_jax(state), dev))


def train_autoencoder(cfg: AETrainConfig, tri_iterator: Iterator,
                      run_dir: str, seed: int = 0,
                      resume: Optional[str] = None, device="cuda"):
    """Train the geometry AE on triband batches (uint8 ``[B, H, W, 3]``) on
    ``device``; writes ``ae_latest.pkl`` into ``run_dir`` every
    ``checkpoint_every`` steps and at the end.  Returns ``(params, state,
    losses)``: ``losses`` holds each step's loss as a 0-d tensor."""
    dev = resolve_device(device)
    os.makedirs(run_dir, exist_ok=True)
    params, state = init_ae(cfg.enc_cfg, seed, dev)
    step_fn, opt = make_ae_train_step(cfg)
    opt_state = opt.init(params)
    start_step = 0
    if resume is not None and os.path.isfile(resume):
        with open(resume, "rb") as f:
            start_step = pickle.load(f).get("step", 0)
        _, params, state = load_ae_checkpoint(resume, device=dev)
        logger.info("Resumed AE from %s at step %d", resume, start_step)

    rng = np.random.default_rng(seed)
    losses = []
    for step in range(start_step, cfg.num_steps):
        tri = np.asarray(next(tri_iterator), np.float32) / 255.0
        width = int(rng.choice(cfg.widths))
        tri = torch.from_numpy(
            np.ascontiguousarray(random_crop_batch(tri, width, rng))).to(dev)
        params, state, opt_state, loss = step_fn(
            params, state, opt_state, tri[..., 1:2], tri[..., 2:3])
        losses.append(loss)
        if step % cfg.eval_every == 0:
            logger.info("AE step %d: loss %.4f", step, float(loss))
        if step % cfg.checkpoint_every == 0 or step == cfg.num_steps - 1:
            save_ae_checkpoint(os.path.join(run_dir, "ae_latest.pkl"),
                               cfg.enc_cfg, params, state, step)
    return params, state, losses


def save_ae_checkpoint(path: str, enc_cfg: GeoEncoderConfig, params, state,
                       step: int = 0):
    """The config as a dict and numpy trees in the JAX layout (the JAX
    package's ``save_ae_checkpoint`` format)."""
    with open(path, "wb") as f:
        pickle.dump({"magic": AE_MAGIC,
                     "args": dataclasses.asdict(enc_cfg),
                     "params": params_to_jax(params),
                     "state": params_to_jax(state),
                     "step": step}, f)


def is_ae_checkpoint(path: str) -> bool:
    """Whether ``path`` holds an AE checkpoint of either package (read
    without running code of the file)."""
    from brushstroke_engine_torch.utils import torch_extract as tx
    if zipfile.is_zipfile(path):
        return False        # a torch.save file
    try:
        payload = tx.load_reference_pickle(path)
    except (pickle.UnpicklingError, EOFError):
        return False        # a legacy torch .pt or another format
    return isinstance(payload, dict) and payload.get("magic") == AE_MAGIC


def load_ae_checkpoint(path: str, device="cuda"):
    """(GeoEncoderConfig, params, state) of an AE checkpoint that either
    package wrote; the trees as the port's tensors on ``device``."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        saved = pickle.load(f)
    args = dict(saved["args"])
    for k in ("down_filters", "post_filters", "up_filters"):
        if args.get(k) is not None:
            args[k] = tuple(args[k])
    return (GeoEncoderConfig(**args),
            tree_to(params_from_jax(saved["params"]), dev),
            tree_to(params_from_jax(saved["state"]), dev))
