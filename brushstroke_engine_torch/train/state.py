"""Training state and configuration.

Counterpart of ``brushstroke_engine_tpu/train/state.py``: one explicit tree
``state`` threaded through the phase functions of ``train/steps.py``.  Lazy
regularization scales the shared G/D Adam hyperparameters once at
construction (mb_ratio = interval / (interval + 1)); the geometry phase uses
its own Adam(0, 0.99) over the G params.

Adam is written out over the parameter trees (``torch._foreach`` ops) so
that one step equals ``optax.adam``'s: bias correction on both moments and
``eps`` added outside the square root.  Its state is ``{"count": int, "mu":
tree, "nu": tree}``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from brushstroke_engine_torch.models.discriminator import DiscriminatorConfig
from brushstroke_engine_torch.models.generator import GeneratorConfig
from brushstroke_engine_torch.models.geo_encoder import GeoEncoderConfig
from brushstroke_engine_torch.train.augment import AugmentConfig
from brushstroke_engine_torch.train.losses import ForgerLosses
from brushstroke_engine_torch.utils.checkpoint import (
    init_native_params, params_from_jax,
)
from brushstroke_engine_torch.utils.util import (
    resolve_device, tree_leaves, tree_map, tree_unflatten,
)


@dataclass(frozen=True)
class TrainConfig:
    gen_cfg: GeneratorConfig
    disc_cfg: DiscriminatorConfig
    enc_cfg: GeoEncoderConfig
    enc_res: Tuple[int, ...] = (0, 1)
    batch_size: int = 64
    # Microbatch size for gradient accumulation (reference --batch-gpu).
    # None = whole batch in one round.
    batch_gpu: Optional[int] = None

    # Optimizers (reference train_flags: lr 2e-4 / 2e-4).
    g_lr: float = 2e-4
    d_lr: float = 2e-4
    geom_lr: float = 2e-4
    adam_beta0: float = 0.0
    adam_beta1: float = 0.99
    adam_eps: float = 1e-8

    # Lazy regularization intervals (reference train.py cfg 'auto').
    g_reg_interval: int = 4
    d_reg_interval: int = 16

    # Synthesis noise during training: 'random' per-layer noise as the
    # reference trains; 'const' for deterministic parity tests.
    noise_mode: str = "random"

    # GAN loss hyperparameters (reference loss_modified.py:30-34).
    style_mixing_prob: float = 0.9
    r1_gamma: float = 0.8192
    pl_batch_shrink: int = 2
    pl_decay: float = 0.01
    pl_weight: float = 2.0

    # Loss DSL strings (reference train_flags.txt).
    main_phase_losses: str = ""
    geom_phase_losses: str = "1.0*iou_inv(uvs)"
    geom_warmstart_losses: str = "1.0*iou_inv(uvs)+1.0*iou(u)"
    stitch_phase_losses: str = ""
    partial_loss_with_triband_input: bool = True

    # Phase scheduling.
    geom_interval: int = 200
    stitch_interval: int = 0
    geom_phase_mode: str = "last_and_rgb"
    geom_warmstart_mode: str = "last_and_rgb"
    geom_warmstart_kimg: int = 50
    geom_warmstart_start_kimg: int = 0

    # ADA (reference train.py / training_loop_modified.py:516-519).
    augment: Optional[AugmentConfig] = None
    ada_target: float = 0.6
    ada_interval: int = 4
    ada_kimg: float = 500.0

    # EMA.
    ema_kimg: float = 10.0
    ema_rampup: Optional[float] = None

    # Totals.
    total_kimg: int = 10000
    kimg_per_tick: int = 4

    def losses(self, which: str) -> ForgerLosses:
        s = {"main": self.main_phase_losses,
             "geom": self.geom_phase_losses,
             "warmstart": self.geom_warmstart_losses,
             "stitch": self.stitch_phase_losses}[which]
        fl = ForgerLosses.create_from_string(s)
        fl.set_partial_loss_with_triband_input(
            self.partial_loss_with_triband_input)
        return fl


@dataclass(frozen=True)
class Adam:
    """``optax.adam`` over dict trees of tensors."""
    lr: float
    b1: float
    b2: float
    eps: float = 1e-8

    def init(self, params) -> Dict:
        return {"count": 0,
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, grads, state):
        """Returns (updates tree, new state); the inputs are left as they
        are."""
        g = tree_leaves(grads)
        mu = torch._foreach_mul(tree_leaves(state["mu"]), self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        nu = torch._foreach_mul(tree_leaves(state["nu"]), self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        count = state["count"] + 1
        c1 = 1.0 - self.b1 ** count
        c2 = 1.0 - self.b2 ** count
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, denom)
        torch._foreach_mul_(upd, -self.lr / c1)
        new_state = {"count": count, "mu": tree_unflatten(grads, mu),
                     "nu": tree_unflatten(grads, nu)}
        return tree_unflatten(grads, upd), new_state


def lazy_adam(lr: float, beta0: float, beta1: float, eps: float,
              reg_interval: Optional[int]) -> Adam:
    """Adam with lazy-regularization hyperparameter scaling."""
    if reg_interval is not None and reg_interval > 1:
        mb_ratio = reg_interval / (reg_interval + 1)
        lr = lr * mb_ratio
        beta0 = beta0 ** mb_ratio
        beta1 = beta1 ** mb_ratio
    return Adam(lr=lr, b1=beta0, b2=beta1, eps=eps)


def make_optimizers(cfg: TrainConfig):
    g_opt = lazy_adam(cfg.g_lr, cfg.adam_beta0, cfg.adam_beta1, cfg.adam_eps,
                      cfg.g_reg_interval)
    d_opt = lazy_adam(cfg.d_lr, cfg.adam_beta0, cfg.adam_beta1, cfg.adam_eps,
                      cfg.d_reg_interval)
    geom_opt = Adam(lr=cfg.geom_lr, b1=0.0, b2=0.99, eps=1e-8)
    return g_opt, d_opt, geom_opt


def init_train_state(cfg: TrainConfig, seed: int = 0, g_params=None,
                     g_state=None, d_params=None, device="cuda") -> Dict:
    """Build the full training state tree on ``device`` (raises without CUDA
    unless ``device="cpu"``).  Trees the caller does not give are random
    from the numpy ``seed`` (``init_native_params``); given ones (the port's
    layout) are copied."""
    dev = resolve_device(device)
    if g_params is None or d_params is None:
        trees = init_native_params(cfg.gen_cfg, cfg.enc_cfg, seed=seed,
                                   disc_cfg=cfg.disc_cfg)
        if g_params is None:
            g_params = params_from_jax(trees["gen_params"])
            g_state = params_from_jax(trees["gen_state"])
        if d_params is None:
            d_params = params_from_jax(trees["disc_params"])

    def copy(tree):
        return tree_map(lambda t: t.detach().to(dev, copy=True), tree)

    g_params, g_state, d_params = copy(g_params), copy(g_state), \
        copy(d_params)
    g_opt, d_opt, geom_opt = make_optimizers(cfg)
    zero = torch.zeros((), device=dev)
    return {
        "g_params": g_params,
        "d_params": d_params,
        "g_ema": copy(g_params),
        "w_avg": g_state.get("w_avg", torch.zeros((cfg.gen_cfg.w_dim,),
                                                  device=dev)),
        "noise": g_state["noise"],
        "g_opt": g_opt.init(g_params),
        "d_opt": d_opt.init(d_params),
        "geom_opt": geom_opt.init(g_params),
        "pl_mean": zero.clone(),
        "ada_p": zero.clone(),
        "ada_signs": zero.clone(),
        "ada_count": zero.clone(),
    }
