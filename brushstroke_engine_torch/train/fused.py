"""The fused training step: a whole batch cycle in one call.

Counterpart of ``brushstroke_engine_tpu/train/fused.py``, the production
shape of the trainer: the warm-start switch, Dmain, lazy Dreg (R1), Gmain,
lazy Greg (path length), Gstitch and Ggeom on their intervals and the ADA p
update run as one step from one geometry encode, so the host feeds data and
reads scalars at ticks only.  It is built from the phase functions of
``train/steps.py`` and their ``draws`` convention.

The draws differ from the loop's phase-by-phase path, as in the JAX step:

  * one geometry encode per batch, shared by every phase; the second crop of
    the stitch phase is encoded on stitch batches only;
  * ``z1`` feeds Dmain and the warm step, ``z2`` is shared by Gmain and
    Greg, ``z3`` feeds Ggeom and ``z_st`` Gstitch (the loop path draws a
    fresh z per phase).

``batch_idx`` and ``warm`` are host values here, so the TPU's ``lax.cond``
branches are plain ``if``.  What carries over is the stats contract: every
phase's keys (:func:`fused_stat_keys`) are present on every batch, and a
phase that did not run reports NaN.  Nothing inside the step reads a device
value on the host.

``draws`` (all optional; explicit draws let two devices or two packages run
the same numbers): ``"z1"``, ``"z2"``, ``"z3"``, ``"z_st"`` latents;
``"bank": (style_idx, tri_idx)`` for the bank draw; and per phase
``"dmain"``, ``"dreg"``, ``"gmain"``, ``"greg"``, ``"ggeom"``, ``"warm"``,
``"stitch"`` the dict (a list per round with ``cfg.batch_gpu``) that the
phase function takes.  ``host_rng`` (a numpy ``Generator``) makes the loss
DSL's crop draws where a phase's draws do not.  With ``chunk=K`` the step
runs K batches and ``draws`` is a list of K such dicts.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from brushstroke_engine_torch.train import steps as ts
from brushstroke_engine_torch.train.device_dataset import (
    _no_mesh, crop_tri, gen_crops, sample_banks,
)
from brushstroke_engine_torch.train.state import TrainConfig
from brushstroke_engine_torch.train.stitching import RandomStitcher

# The keys each phase reports, before its loss items (JAX ``steps.py``).
PHASE_STATS: Dict[str, Tuple[str, ...]] = {
    "dmain": ("Loss/D/loss", "Loss/scores/fake", "Loss/scores/real",
              "Loss/signs/real"),
    "dreg": ("Loss/r1_penalty", "Loss/D/reg"),
    "gmain": ("Loss/G/loss", "Loss/G/total_loss"),
    "greg": ("Loss/pl_penalty", "Loss/G/reg"),
    "ggeom": ("Loss/forger/Ggeom/total",),
    "warm": ("Loss/forger/Ggeom-warm/total",),
    "stitch": ("Loss/forger/Gstitch/total",),
}
# Phase -> (the loss DSL it adds items of, the items' key prefix).
PHASE_ITEMS = {"gmain": ("main", "Loss/forger/Gmain"),
               "ggeom": ("geom", "Loss/forger/Ggeom"),
               "warm": ("warmstart", "Loss/forger/Ggeom-warm"),
               "stitch": ("stitch", "Loss/forger/Gstitch")}


def _phases(cfg: TrainConfig):
    """The phases this configuration has, in the fused order."""
    out = ["dmain", "dreg", "gmain", "greg"]
    if cfg.stitch_interval > 0 and cfg.losses("stitch").items:
        out.append("stitch")
    if cfg.geom_interval > 0 and cfg.losses("geom").items:
        out.append("ggeom")
    if cfg.geom_warmstart_kimg > 0:
        out.append("warm")
    return out


def fused_stat_keys(cfg: TrainConfig) -> Dict[str, Tuple[str, ...]]:
    """Every stat key of the fused step, by phase: :data:`PHASE_STATS`
    plus the loss items of the configured DSL strings."""
    out = {}
    for phase in _phases(cfg):
        keys = PHASE_STATS[phase]
        if phase in PHASE_ITEMS:
            which, prefix = PHASE_ITEMS[phase]
            keys = keys + tuple(f"{prefix}/{i.full_name}"
                                for i in cfg.losses(which).items)
        out[phase] = keys
    return out


def ema_beta_f32(cfg: TrainConfig, nimg) -> float:
    """The G_ema decay at image count ``nimg`` with its ramp-up, in f32:
    ``2^(-B / max(ema_nimg, 1e-8))`` (JAX ``fused.py`` chunk mode)."""
    ema_nimg = np.float32(cfg.ema_kimg * 1000.0)
    if cfg.ema_rampup is not None:
        ema_nimg = min(ema_nimg, np.float32(nimg) * np.float32(
            cfg.ema_rampup))
    return float(np.exp2(np.float32(-cfg.batch_size) / np.maximum(
        np.float32(ema_nimg), np.float32(1e-8))))


def make_fused_train_step(cfg: TrainConfig, device_data: bool = False,
                          chunk: int = 0, crop_margin: int = 10,
                          min_overlap: int = 50, mesh=None):
    """The fused step.  Signatures (each returns ``(state, stats)``):

    * host data: ``step(state, enc_params, enc_state, real_img, geom_input,
      geom_truth, batch_idx, warm, ema_beta, rng=None, draws=None,
      host_rng=None, geom_input2=None, crop1=None, crop2=None,
      g_orig_params=None)``; with stitching configured, pass the second
      crop's ``geom_input2`` and both crops as host ``(y, x, h, w)`` ints;
    * ``device_data=True``: ``step(state, enc_params, enc_state,
      style_bank, tri_bank, batch_idx, warm, ema_beta, crop1, crop2=None,
      rng=None, draws=None, host_rng=None, g_orig_params=None)`` -- the
      batch is sampled from the uint8 banks on their device and cropped
      there (``train/device_dataset.py``);
    * ``chunk=K > 0`` (with ``device_data``): ``step(state, enc_params,
      enc_state, style_bank, tri_bank, batch_idx0, nimg0, host_rng,
      rng=None, draws=None, g_orig_params=None)`` runs K batches; per batch
      the crops come from ``host_rng`` (``gen_crops``), the warm flag from
      ``nimg0 + i * B`` and the EMA beta from :func:`ema_beta_f32`; stats
      come back stacked ``[K]``.

    ``rng``: the device ``torch.Generator`` of latents, noise, augment and
    bank draws.  ``g_orig_params``: the frozen original generator, which
    the warm and Ggeom phases need when their losses read ``fake_orig``
    (the clarity finetune).  A device mesh (``mesh=``) is not ported
    (ROADMAP.md item 2.9).
    """
    _no_mesh(mesh)
    if chunk and not device_data:
        raise ValueError("chunk > 0 needs device_data=True (per-batch data "
                         "must live on the device)")
    phases = _phases(cfg)
    keys = fused_stat_keys(cfg)
    warm_step = ts.make_geom_step(cfg, warmstart=True) \
        if "warm" in phases else None
    geom_step = ts.make_geom_step(cfg, warmstart=False) \
        if "ggeom" in phases else None
    stitching = "stitch" in phases
    stitcher = RandomStitcher(crop_margin=crop_margin,
                              min_overlap=min_overlap)
    needs_orig_warm = warm_step is not None and \
        cfg.losses("warmstart").require_original_fake_image()
    needs_orig_geom = geom_step is not None and \
        cfg.losses("geom").require_original_fake_image()
    rounds = ts._num_rounds(cfg, cfg.batch_size)
    res = cfg.gen_cfg.img_resolution

    def core(state, enc_params, enc_state, real_img, geom_input, geom_truth,
             batch_idx, warm, ema_beta, rng, draws, host_rng, geom_input2,
             crop1, crop2, g_orig_params):
        d = draws or {}
        dev = real_img.device
        n, zdim = real_img.shape[0], cfg.gen_cfg.z_dim

        def z(name):
            if name in d:
                return d[name].to(dev)
            return torch.randn((n, zdim), generator=rng, device=dev)

        def pd(name, rounded=True):
            """The draws of a phase; the loss DSL's crops come from
            ``host_rng`` where they are not given."""
            p = d.get(name)
            if rounded and rounds > 1:
                return p
            p = dict(p or {})
            if host_rng is not None:
                p.setdefault("loss_rng", host_rng)
            return p

        feats = ts.encode_geometry(cfg, enc_params, enc_state, geom_input)
        nan = torch.full((), float("nan"), device=dev)
        stats = {k: nan for ks in keys.values() for k in ks}
        if warm and warm_step is not None:
            state, s = warm_step(
                state, feats, geom_truth, z("z1"), rng, ema_beta,
                g_orig_params=g_orig_params if needs_orig_warm else None,
                draws=pd("warm", rounded=False))
            stats.update(s)
            return state, stats

        z1, z2 = z("z1"), z("z2")
        state, s = ts.d_main_step(cfg, state, real_img, feats, z1, rng,
                                  draws=pd("dmain"))
        stats.update(s)
        if cfg.d_reg_interval > 0 and batch_idx % cfg.d_reg_interval == 0:
            state, s = ts.d_reg_step(cfg, state, real_img, rng,
                                     draws=pd("dreg"))
            stats.update(s)
        state, s = ts.g_main_step(cfg, state, feats, geom_truth, z2, rng,
                                  ema_beta, draws=pd("gmain"))
        stats.update(s)
        if cfg.g_reg_interval > 0 and batch_idx % cfg.g_reg_interval == 0:
            state, s = ts.g_reg_step(cfg, state, feats, z2, rng, ema_beta,
                                     draws=pd("greg", rounded=False))
            stats.update(s)
        if stitching and batch_idx % cfg.stitch_interval == 0:
            feats2 = ts.encode_geometry(cfg, enc_params, enc_state,
                                        geom_input2)
            state, s = ts.g_stitch_step(
                cfg, state, feats, feats2, z("z_st"), crop1, crop2, rng,
                ema_beta, draws=pd("stitch"), stitcher=stitcher)
            stats.update(s)
        if geom_step is not None and batch_idx % cfg.geom_interval == 0:
            state, s = geom_step(
                state, feats, geom_truth, z("z3"), rng, ema_beta,
                g_orig_params=g_orig_params if needs_orig_geom else None,
                draws=pd("ggeom", rounded=False))
            stats.update(s)
        if cfg.augment is not None and batch_idx > 0 and \
                batch_idx % cfg.ada_interval == 0:
            state = ts.ada_update(cfg, state,
                                  float(cfg.batch_size * cfg.ada_interval))
        return state, stats

    def need_stitch_data(*given):
        if stitching and any(g is None for g in given):
            raise ValueError("stitching is configured: pass geom_input2, "
                             "crop1 and crop2")

    if not device_data:
        def step(state, enc_params, enc_state, real_img, geom_input,
                 geom_truth, batch_idx, warm, ema_beta, rng=None, draws=None,
                 host_rng=None, geom_input2=None, crop1=None, crop2=None,
                 g_orig_params=None):
            need_stitch_data(geom_input2, crop1, crop2)
            return core(state, enc_params, enc_state, real_img, geom_input,
                        geom_truth, batch_idx, warm, ema_beta, rng, draws,
                        host_rng, geom_input2, crop1, crop2, g_orig_params)

        return step

    def sampled(state, enc_params, enc_state, style_bank, tri_bank,
                batch_idx, warm, ema_beta, crop1, crop2, rng, draws,
                host_rng, g_orig_params):
        need_stitch_data(crop1, crop2)
        real_img, tri = sample_banks(style_bank, tri_bank, cfg.batch_size,
                                     rng, (draws or {}).get("bank"))
        geom_input, geom_truth = crop_tri(tri, crop1, res)
        geom_input2 = crop_tri(tri, crop2, res)[0] if stitching else None
        return core(state, enc_params, enc_state, real_img, geom_input,
                    geom_truth, batch_idx, warm, ema_beta, rng, draws,
                    host_rng, geom_input2, crop1, crop2, g_orig_params)

    if not chunk:
        def device_step(state, enc_params, enc_state, style_bank, tri_bank,
                        batch_idx, warm, ema_beta, crop1, crop2=None,
                        rng=None, draws=None, host_rng=None,
                        g_orig_params=None):
            return sampled(state, enc_params, enc_state, style_bank,
                           tri_bank, batch_idx, warm, ema_beta, crop1, crop2,
                           rng, draws, host_rng, g_orig_params)

        return device_step

    warm_start = cfg.geom_warmstart_start_kimg * 1000.0
    warm_len = cfg.geom_warmstart_kimg * 1000.0

    def chunk_step(state, enc_params, enc_state, style_bank, tri_bank,
                   batch_idx0, nimg0, host_rng, rng=None, draws=None,
                   g_orig_params=None):
        tri_hw = tuple(tri_bank.shape[1:3])
        if draws is not None and len(draws) != chunk:
            raise ValueError(f"a chunk of {chunk} batches needs {chunk} "
                             f"draws")
        per = []
        for i in range(chunk):
            nimg = float(np.float32(nimg0 + i * cfg.batch_size))
            warm = warm_step is not None and nimg >= warm_start and \
                nimg - warm_start < warm_len
            crop1, crop2 = gen_crops(host_rng, tri_hw, res, stitching,
                                     crop_margin, min_overlap)
            state, s = sampled(
                state, enc_params, enc_state, style_bank, tri_bank,
                batch_idx0 + i, warm, ema_beta_f32(cfg, nimg), crop1, crop2,
                rng, None if draws is None else draws[i], host_rng,
                g_orig_params)
            per.append(s)
        return state, {k: torch.stack([torch.as_tensor(p[k]).float()
                                       for p in per]) for k in per[0]}

    return chunk_step
