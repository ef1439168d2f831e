"""Project a real (style image, geometry) pair into W / W+ and noise textures.

Counterpart of ``brushstroke_engine_tpu/tools/projection.py``: Adam on the
style (and, optionally, the per-layer noise textures) against an LPIPS
target, with optional L1 over conservative-foreground pixels, a
background-clarity term and a composite over the estimated background color;
a multiscale noise autocorrelation regularizer, cosine LR ramp-up / down, w
noise that ramps down, per-step noise renormalization, the best-so-far
snapshot, and an early stop on an LPIPS plateau.

:func:`project_parallel` runs N independent optimizations as ONE generator
pass over N*B rows per step (the JAX package vmaps N style programs; a hand
kernel has no vmap): style j owns rows j*B ... j*B+B-1 and one noise plane
per row, each style's loss is the mean over its own rows, the total is the
sum over styles, and Adam, being elementwise, over the stacked parameters is
N Adams.  :func:`project` is the case N = 1, whose noise planes broadcast
over its B rows.

The host reads one small vector per ``log_every`` chunk (the plateau check);
the best-so-far snapshot is selected on the device, so no step waits for the
device.  The w noise of every step is a unit-normal draw; ``draws`` gives
them (the parity tests pass the JAX package's), else they come from a
``torch.Generator`` on the device seeded with ``seed``.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from brushstroke_engine_torch.metrics.geom import get_conservative_fg_bg
from brushstroke_engine_torch.metrics.lpips import lpips_batched
from brushstroke_engine_torch.models.generator import generator_apply
from brushstroke_engine_torch.models.geo_encoder import geo_encoder_encode
from brushstroke_engine_torch.tools.latent import get_w_stats
from brushstroke_engine_torch.train.state import Adam
from brushstroke_engine_torch.utils.util import tree_leaves, tree_unflatten

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class ProjectionConfig:
    num_steps: int = 1000
    w_avg_samples: int = 10000
    initial_learning_rate: float = 0.1
    initial_noise_factor: float = 0.05
    lr_rampdown_length: float = 0.25
    lr_rampup_length: float = 0.05
    noise_ramp_length: float = 0.75
    regularize_noise_weight: float = 10.0
    l1_fg_weight: float = 0.0
    bg_weight: float = 0.0
    w_plus: bool = True
    optimize_noise: bool = True
    with_composite: bool = False
    min_lpips_improvement: float = 1e-4


def _lr_schedule(cfg: ProjectionConfig, step) -> float:
    """Cosine ramp-down of the last ``lr_rampdown_length`` with a linear
    ramp-up over the first ``lr_rampup_length`` (0 at step 0)."""
    t = step / cfg.num_steps
    ramp = min(1.0, (1.0 - t) / cfg.lr_rampdown_length)
    ramp = 0.5 - 0.5 * math.cos(ramp * math.pi)
    ramp = ramp * min(1.0, t / cfg.lr_rampup_length)
    return cfg.initial_learning_rate * ramp


def _noise_autocorr_reg(noise_bufs: Dict):
    """Multiscale autocorrelation penalty of noise textures ``[..., H, W]``:
    per leading index (a scalar for ``[H, W]`` textures), summed over the
    buffers."""
    total = 0.0
    for v in noise_bufs.values():
        noise = v.float()
        lead = noise.shape[:-2]
        while True:
            total = total + (noise * torch.roll(noise, 1, dims=-1)).mean(
                dim=(-2, -1)) ** 2
            total = total + (noise * torch.roll(noise, 1, dims=-2)).mean(
                dim=(-2, -1)) ** 2
            if noise.shape[-2] <= 8:
                break
            h, w = noise.shape[-2:]
            noise = F.avg_pool2d(noise.reshape(-1, 1, h, w), 2).reshape(
                lead + (h // 2, w // 2))
    return total


def compute_masked_color(target, mask):
    """Mean color over masked pixels of each row -> ``[B, 1, 1, 3]`` (the
    background estimate)."""
    m = mask.float()
    num = (target * m).sum(dim=(1, 2), keepdim=True)
    den = m.sum(dim=(1, 2), keepdim=True).clamp_min(1)
    return num / den


def composite_with_bg_color(debug, bg_color):
    """Compose uvs x colors over an estimated background color, in [-1, 1]."""
    uvs = debug["uvs"]
    colors = (debug["colors"] + 1.0) / 2.0
    stroke = torch.einsum("bhwk,bck->bhwc", uvs[..., :2], colors[..., :2])
    alpha = uvs[..., :2].sum(dim=-1, keepdim=True)
    return (stroke + (1 - alpha) * bg_color) * 2.0 - 1.0


def _renormalize(v):
    """Zero mean and unit power per style (all axes but the first)."""
    dims = tuple(range(1, v.dim()))
    return (v - v.mean(dim=dims, keepdim=True)) * torch.rsqrt(
        v.square().mean(dim=dims, keepdim=True) + 1e-12)


def _optimize(engine, targets, geoms, cfg: ProjectionConfig, w_start, w_std,
              noise_start: Dict, seed: int, log_every: int, draws):
    """The projection loop over N styles; see the module docstring.

    targets ``[N, B, W, W, 3]``, geoms ``[N, B, W, W, 1]`` (numpy);
    w_start ``[N, 1, num_ws or 1, w_dim]``; w_std the scalar of
    :func:`get_w_stats`; noise_start ``{key: [N, H, W]}``
    (empty without noise); draws ``[num_steps, N, 1, num_ws or 1, w_dim]``
    or None.  Returns the best-so-far snapshot as numpy arrays.
    """
    gen_cfg = engine.gen_cfg
    dev = engine.device
    n, b = targets.shape[:2]
    num_ws = gen_cfg.num_ws
    flat_target = torch.as_tensor(
        np.asarray(targets, np.float32).reshape((n * b,) + targets.shape[2:]),
        device=dev)
    flat_geom = torch.as_tensor(
        np.asarray(geoms, np.float32).reshape((n * b,) + geoms.shape[2:]),
        device=dev)
    with torch.no_grad():
        feats = geo_encoder_encode(engine.enc_cfg, engine.enc_params,
                                   engine.enc_state, flat_geom,
                                   res=list(engine.enc_res))
        fg, bg = get_conservative_fg_bg(flat_geom)
        bg_color = compute_masked_color(flat_target, bg)  # [N*B, 1, 1, 3]
    fmask = fg.float()
    bmask = bg[..., 0].float()
    params = {"w": torch.as_tensor(w_start, dtype=torch.float32, device=dev),
              "noise": {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                        for k, v in noise_start.items()}}
    opt = Adam(lr=1.0, b1=0.9, b2=0.999)      # lr applied per step below
    opt_state = opt.init(params)
    g_state = {"w_avg": engine.gen_state.get("w_avg"),
               "noise": engine.gen_state["noise"]}
    weights = {"lpips": 1.0, "l1": cfg.l1_fg_weight, "bg": cfg.bg_weight,
               "reg": cfg.regularize_noise_weight}
    gen = None
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
    else:
        draws = torch.as_tensor(np.asarray(draws, np.float32), device=dev)

    def per_style(x):
        """Row values ``[N*B, ...]`` -> per-style sums ``[N]``."""
        return x.reshape(n, -1).sum(dim=1)

    def style_losses(p, w_noise):
        ws = p["w"] + w_noise                        # [N, 1, nw | 1, w_dim]
        if not cfg.w_plus:
            ws = ws.expand(-1, -1, num_ws, -1)
        ws = ws.expand(-1, b, -1, -1).reshape(n * b, num_ws, -1)
        # One style broadcasts its [H, W] planes over its rows; N styles
        # give each row its style's plane.
        noise = {k: v[0] if n == 1 else v.repeat_interleave(b, dim=0)
                 for k, v in p["noise"].items()}
        img, debug = generator_apply(
            gen_cfg, engine.gen_params, g_state, ws=ws, geom_features=feats,
            noise_mode="const", noise_buffers=noise or None,
            return_debug_data=True)
        synth = img
        if cfg.with_composite:
            synth = composite_with_bg_color(debug, bg_color)
        losses = {"lpips": lpips_batched(flat_target, synth).reshape(
            n, b).mean(dim=1)}
        if cfg.l1_fg_weight > 0:
            losses["l1"] = per_style((flat_target - synth).abs() * fmask) / \
                (per_style(fmask) * 3).clamp_min(1)
        if cfg.bg_weight > 0:
            losses["bg"] = per_style((1.0 - debug["uvs"][..., 2]) * bmask) / \
                per_style(bmask).clamp_min(1)
        losses["reg"] = _noise_autocorr_reg(p["noise"])
        return sum(weights[k] * v for k, v in losses.items()), losses

    def step_once(step, unit):
        nonlocal params, opt_state
        t = step / cfg.num_steps
        w_noise_scale = w_std * cfg.initial_noise_factor * \
            max(0.0, 1.0 - t / cfg.noise_ramp_length) ** 2
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        totals, losses = style_losses(params, unit * w_noise_scale)
        grads = torch.autograd.grad(totals.sum(), leaves)
        with torch.no_grad():
            upd, opt_state = opt.update(tree_unflatten(params, grads),
                                        opt_state)
            lr = _lr_schedule(cfg, step)
            new = [leaf.detach() + u * lr
                   for leaf, u in zip(leaves, tree_leaves(upd))]
            params = tree_unflatten(params, new)
            params["noise"] = {k: _renormalize(v)
                               for k, v in params["noise"].items()}
        return losses["lpips"].detach()

    best = {"lpips": torch.full((n,), math.inf, device=dev),
            "step": torch.zeros((n,), device=dev),
            "w": params["w"].clone(),
            "noise": {k: v.clone() for k, v in params["noise"].items()}}
    prev_best = None
    step = 0
    while step < cfg.num_steps:
        k = min(log_every, cfg.num_steps - step)
        if draws is None:
            unit = torch.randn((k,) + tuple(params["w"].shape),
                               generator=gen, device=dev)
        else:
            unit = draws[step:step + k]
        lps = []
        for i in range(k):
            lp = step_once(step + i, unit[i])
            with torch.no_grad():
                better = lp < best["lpips"]

                def sel(new, old):
                    m = better.reshape((n,) + (1,) * (new.dim() - 1))
                    return torch.where(m, new, old)

                best = {"lpips": torch.where(better, lp, best["lpips"]),
                        "step": torch.where(better, float(step + i),
                                            best["step"]),
                        "w": sel(params["w"], best["w"]),
                        "noise": {key: sel(v, best["noise"][key])
                                  for key, v in params["noise"].items()}}
            lps.append(lp.mean())
        step += k
        # The one read of the chunk: its per-step LPIPS and the best.
        read = torch.stack(lps + [best["lpips"].mean()]).cpu().tolist()
        bl = read[-1]
        logger.info("Step %d: lpips %.4f (best %.4f)", step, read[-2], bl)
        logger.debug("chunk lpips %s", read[:-1])
        if prev_best is not None and \
                prev_best - bl < cfg.min_lpips_improvement:
            logger.info("LPIPS plateau at step %d", step)
            break
        prev_best = bl
    bgc = bg_color.reshape(n, b, 3).cpu().numpy()
    return {"lpips": best["lpips"].cpu().numpy(),
            "step": best["step"].cpu().numpy(),
            "w": best["w"].cpu().numpy(),
            "noise": {k: v.cpu().numpy() for k, v in best["noise"].items()},
            "bg": bgc.mean(axis=1)}


def _noise_keys(engine):
    """The noise textures in the order the JAX package draws them (its
    engine's trees are committed through ``jax.device_put``, which sorts
    dict keys)."""
    return sorted(engine.gen_state["noise"])


def project(engine, target, geom, cfg: ProjectionConfig = ProjectionConfig(),
            resume_from: Optional[Dict] = None, seed: int = 0,
            log_every: int = 100, draws=None) -> Dict:
    """Optimize a style for (target, geom) patches.

    Args:
      engine: a GanPaintEngine (gen params / state + encoder).
      target: ``[B, W, W, 3]`` float images in [-1, 1].
      geom: ``[B, W, W, 1]`` float geometry, 0 = FG.
      draws: the unit normals of the w noise, ``[num_steps, 1, num_ws or 1,
        w_dim]``; default: a ``torch.Generator`` seeded with ``seed``.

    Returns dict {'w': [1, num_ws, w_dim], 'noise': {...}, 'bg': [3],
    'step': int, 'lpips': float}.
    """
    gen_cfg = engine.gen_cfg
    w_avg, w_std = get_w_stats(gen_cfg, engine.gen_params["mapping"],
                               num_samples=cfg.w_avg_samples, seed=seed)
    num_ws = gen_cfg.num_ws
    w_start = np.tile(w_avg, (1, num_ws, 1)) if cfg.w_plus else w_avg
    if resume_from is not None and "w" in resume_from:
        w_prev = np.asarray(resume_from["w"], np.float32)
        if w_prev.shape == w_start.shape:
            w_start = w_prev
        else:
            w_start = np.tile(w_prev.reshape(1, 1, -1), (1, num_ws, 1))

    rng = np.random.RandomState(seed)
    noise = {}
    if cfg.optimize_noise:
        prev = (resume_from or {}).get("noise") or {}
        for k in _noise_keys(engine):
            if k in prev:
                noise[k] = np.asarray(prev[k], np.float32)[None]
            else:
                shape = tuple(engine.gen_state["noise"][k].shape)
                noise[k] = rng.randn(*shape)[None]
    out = _optimize(engine, np.asarray(target)[None], np.asarray(geom)[None],
                    cfg, np.asarray(w_start)[None], w_std, noise, seed,
                    log_every,
                    None if draws is None else np.asarray(draws)[:, None])
    return {"w": out["w"][0], "noise": {k: v[0] for k, v in
                                        out["noise"].items()},
            "bg": out["bg"][0], "step": int(out["step"][0]),
            "lpips": float(out["lpips"][0])}


def project_parallel(engine, targets, geoms,
                     cfg: ProjectionConfig = ProjectionConfig(),
                     seed: int = 0, log_every: int = 100,
                     draws=None) -> List[Dict]:
    """Project N independent styles in one pass over N*B rows per step.

    Args:
      engine: a GanPaintEngine.
      targets: ``[N, B, W, W, 3]`` float in [-1, 1].
      geoms: ``[N, B, W, W, 1]`` float, 0 = FG.
      draws: the unit normals of the w noise, ``[num_steps, N, 1, num_ws or
        1, w_dim]``; default: a ``torch.Generator`` seeded with ``seed``.

    Returns a list of N result dicts shaped like :func:`project`'s.
    """
    gen_cfg = engine.gen_cfg
    n = np.asarray(targets).shape[0]
    w_avg, w_std = get_w_stats(gen_cfg, engine.gen_params["mapping"],
                               num_samples=cfg.w_avg_samples, seed=seed)
    w_start = np.tile(w_avg, (n, 1, gen_cfg.num_ws if cfg.w_plus else 1, 1))
    rng = np.random.RandomState(seed)
    noise = {}
    if cfg.optimize_noise:
        for k in _noise_keys(engine):
            noise[k] = rng.randn(n, *tuple(engine.gen_state["noise"][k].shape))
    out = _optimize(engine, np.asarray(targets), np.asarray(geoms), cfg,
                    w_start, w_std, noise, seed, log_every, draws)
    return [{"lpips": float(out["lpips"][i]), "step": int(out["step"][i]),
             "w": out["w"][i],
             "noise": {k: v[i] for k, v in out["noise"].items()},
             "bg": out["bg"][i]}
            for i in range(n)]
