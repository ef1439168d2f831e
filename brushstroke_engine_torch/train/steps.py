"""Training phase functions.

Counterpart of ``brushstroke_engine_tpu/train/steps.py``: each phase (Dmain,
Dreg/r1, Gmain, Greg/path-length, Ggeom, Ggeom-warm, Gstitch) is a function
``state, batch, draws -> state, stats`` that leaves its input state as it
was.  Regularizers that need gradient-of-gradient (R1, PL) use
``torch.autograd.grad(create_graph=True)``; the second backward runs through
the ADA warp's kernel pair and the FIR-epilogue kernel's backward.

Random draws: every phase takes a ``torch.Generator`` ``rng`` and an optional
``draws`` dict that overrides what would be drawn from it (the parity tests
hand both packages the same numbers):

  * ``"g"``: generator draws ``{"mixing": draw_style_mixing(...), "noise":
    {"b{res}.conv{i}": [B, res, res, 1]}}``; ``"g_orig"`` likewise for the
    frozen original generator of the clarity finetune;
  * ``"aug_fake"``, ``"aug_real"``, ``"aug"``: ``draw_augment`` dicts for the
    discriminator passes of Dmain, and of Dreg / Gmain;
  * ``"pl_noise"``: the unit-normal image noise of the path-length phase;
  * ``"positions1"``, ``"aug_composite"``: Gstitch's canvas positions of
    the first crop and the augment draws of its composite D pass;
  * ``"loss_rng"``: crop draws of the loss DSL (``rng.integers``).

With gradient accumulation (``cfg.batch_gpu``) ``draws`` is a list, one dict
per round.  Stats are 0-d tensors on the device; nothing is read back.

Under a data-parallel group (``parallel.distributed.rank_context``, entered
by the mesh's steps) each phase sees this rank's rows of the global batch:
the gradients are averaged over the ranks in one flattened all-reduce before
the scrub, as the JAX package's global gradient is scrubbed; the ADA sign
counts are the global batch's; Gpl runs on the global first ``B //
pl_batch_shrink`` rows, each rank its even share of them, with the global
``pl_lengths`` mean; the draws are made at the global shape and sliced.
``batch_gpu`` rounds are the global batch's: round ``i`` is the global rows
``[i * batch_gpu, (i + 1) * batch_gpu)``, each rank its even share of them.
Gstitch's discriminator passes see all of ``fake1`` and then all of
``fake2`` (``row_parts``), as one process does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from brushstroke_engine_torch.models.discriminator import discriminator_apply
from brushstroke_engine_torch.models.generator import (
    draw_style_mixing, generator_apply, generator_trainable_mask, mix_styles,
)
from brushstroke_engine_torch.models.geo_encoder import geo_encoder_encode
from brushstroke_engine_torch.models.mapping import mapping_apply, \
    update_w_avg
from brushstroke_engine_torch.parallel.distributed import (
    all_gather_rows, all_reduce_sum, batch_mean, draw_rows,
    mean_over_ranks_, num_ranks, row_parts, rows_of,
)
from brushstroke_engine_torch.train.augment import augment_pipe, draw_augment
from brushstroke_engine_torch.train.state import TrainConfig, make_optimizers
from brushstroke_engine_torch.utils.util import (
    tree_leaves, tree_map, tree_unflatten,
)


def encode_geometry(cfg: TrainConfig, enc_params, enc_state, geom):
    """Frozen geometry encoding (no grads; reference loop :409-410)."""
    with torch.no_grad():
        return geo_encoder_encode(cfg.enc_cfg, enc_params, enc_state, geom,
                                  res=list(cfg.enc_res))


def _run_g(cfg: TrainConfig, g_params, state, z, geom_feats, rng,
           draws: Optional[Dict] = None, style_mixing_prob=None):
    """Generator forward of a training phase: (img, debug_data)."""
    smp = cfg.style_mixing_prob if style_mixing_prob is None \
        else style_mixing_prob
    draws = draws or {}
    return generator_apply(
        cfg.gen_cfg, g_params, {"w_avg": state["w_avg"],
                                "noise": state["noise"]},
        z=z, geom_features=geom_feats, noise_mode=cfg.noise_mode, rng=rng,
        random_noise=draws.get("noise"), return_debug_data=True,
        style_mixing_prob=smp, mixing=draws.get("mixing"))


def _run_d(cfg: TrainConfig, d_params, img, rng, ada_p, draws=None):
    if cfg.augment is not None:
        if draws is None:
            draws = draw_augment(cfg.augment, rng, img.shape[0],
                                 tuple(img.shape[1:]), img.device)
        img = augment_pipe(cfg.augment, draws, img, ada_p)
    return discriminator_apply(cfg.disc_cfg, d_params, img)


def _trainable(params):
    """A copy of the tree whose leaves record gradients."""
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


def _grads(loss, params):
    """d loss / d params as a tree (zeros where the loss does not reach)."""
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)])


def _apply_updates(opt, params, grads, opt_state, mask=None):
    """One Adam step on scrubbed gradients.  ``mask`` (a tree of bools)
    zeroes the gradients and the updates of frozen tensors, so their values
    stay exactly as they were.  Under a group the gradients are first
    averaged over the ranks (one flattened bucket)."""
    grads = tree_unflatten(grads, mean_over_ranks_(tree_leaves(grads)))
    grads = tree_map(lambda g: torch.nan_to_num(g, nan=0.0, posinf=1e5,
                                                neginf=-1e5), grads)
    if mask is not None:
        grads = tree_map(lambda g, m: g * float(m), grads, mask)
    updates, new_opt_state = opt.update(grads, opt_state)
    if mask is not None:
        updates = tree_map(lambda u, m: u * float(m), updates, mask)
    new = torch._foreach_add(tree_leaves(params), tree_leaves(updates))
    return tree_unflatten(params, new), new_opt_state


def ema_update(g_ema, g_params, beta):
    """``p + (e - p) * beta`` leaf by leaf; ``beta`` a float or 0-d tensor."""
    p = tree_leaves(g_params)
    diff = torch._foreach_sub(tree_leaves(g_ema), p)
    if isinstance(beta, torch.Tensor):
        diff = [d * beta for d in diff]
    else:
        torch._foreach_mul_(diff, float(beta))
    return tree_unflatten(g_params, torch._foreach_add(p, diff))


def _num_rounds(cfg: TrainConfig, batch: int) -> int:
    """Gradient-accumulation round count from cfg.batch_gpu (reference
    --batch-gpu microbatching) for this rank's ``batch`` rows: the rounds
    of the global batch (``batch * world`` rows)."""
    world = num_ranks()
    batch = batch * world
    if not cfg.batch_gpu or cfg.batch_gpu >= batch:
        return 1
    if batch % cfg.batch_gpu != 0:
        raise ValueError(
            f"batch {batch} not divisible by batch_gpu {cfg.batch_gpu}")
    if cfg.batch_gpu % world:
        raise ValueError(f"a round of batch_gpu {cfg.batch_gpu} rows does "
                         f"not split over {world} ranks")
    return batch // cfg.batch_gpu


def _map_rows(fn, tree):
    """``fn`` applied to every tensor of a tree (dict / list) of batched
    tensors."""
    if isinstance(tree, dict):
        return {k: _map_rows(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_rows(fn, v) for v in tree]
    return fn(tree)


def _num_rows(tree) -> int:
    """Row count of the first tensor of a tree (dict / list)."""
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree.shape[0]


def _accum_grads(loss_fn, params, batch_tree, draws, rounds: int):
    """Accumulate grads over ``rounds`` microbatches, one after the other
    (bounds peak memory like the reference's batch_gpu rounds; each round
    has its own draws).  Under a group a round is the global round's rows
    of this rank: the batch tree is gathered once and each round takes its
    share.

    ``loss_fn(params, mb, draws) -> (loss, aux)``.  Returns (mean loss, list
    of per-round aux, mean grads).
    """
    params = _trainable(params)
    if rounds == 1:
        loss, aux = loss_fn(params, batch_tree, draws or {})
        return loss.detach(), [aux], _grads(loss, params)
    if draws is not None and len(draws) != rounds:
        raise ValueError(f"{rounds} rounds need a list of {rounds} draws")
    world = num_ranks()
    if world > 1:
        with torch.no_grad():
            batch_tree = _map_rows(all_gather_rows, batch_tree)
    n = _num_rows(batch_tree) // rounds
    mine = rows_of(n // world)
    gsum, lsum, auxs = None, 0.0, []
    for i in range(rounds):
        rows = slice(i * n, (i + 1) * n) if world == 1 else \
            slice(i * n + mine.start, i * n + mine.stop)
        loss, aux = loss_fn(params, _map_rows(lambda t: t[rows], batch_tree),
                            draws[i] if draws is not None else {})
        g = tree_leaves(_grads(loss, params))
        gsum = g if gsum is None else torch._foreach_add(gsum, g)
        lsum = lsum + loss.detach()
        auxs.append(aux)
    torch._foreach_div_(gsum, float(rounds))
    return lsum / rounds, auxs, tree_unflatten(params, gsum)


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detach(v) for v in tree)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


# ---------------------------------------------------------------------------
# D phases
# ---------------------------------------------------------------------------

def d_main_step(cfg: TrainConfig, state, real_img, geom_feats, z, rng=None,
                draws=None):
    """Dmain: softplus(D(G(z))) + softplus(-D(real)) (loss_modified:226-245).

    Honors cfg.batch_gpu gradient accumulation: the generator forward and
    both D passes run per microbatch."""
    _, d_opt, _ = make_optimizers(cfg)
    rounds = _num_rounds(cfg, z.shape[0])

    def loss_fn(d_params, mb, dr):
        with torch.no_grad():
            gen_img, _ = _run_g(cfg, state["g_params"], state, mb["z"],
                                mb["feats"], rng, dr.get("g"))
        gen_logits = _run_d(cfg, d_params, gen_img, rng, state["ada_p"],
                            dr.get("aug_fake"))
        real_logits = _run_d(cfg, d_params, mb["real"], rng, state["ada_p"],
                             dr.get("aug_real"))
        loss = F.softplus(gen_logits).mean() \
            + F.softplus(-real_logits).mean()
        return loss, (gen_logits.detach(), real_logits.detach())

    batch = {"real": real_img, "feats": list(geom_feats), "z": z}
    loss, auxs, grads = _accum_grads(loss_fn, state["d_params"], batch,
                                     draws, rounds)
    gen_logits = torch.cat([a[0] for a in auxs]).reshape(-1)
    real_logits = torch.cat([a[1] for a in auxs]).reshape(-1)
    new_d, new_opt = _apply_updates(d_opt, state["d_params"], grads,
                                    state["d_opt"])
    signs = torch.sign(real_logits)
    state = dict(state, d_params=new_d, d_opt=new_opt,
                 ada_signs=state["ada_signs"] + all_reduce_sum(signs.sum()),
                 ada_count=state["ada_count"]
                 + real_logits.shape[0] * num_ranks())
    stats = {"Loss/D/loss": loss,
             "Loss/scores/fake": gen_logits.mean(),
             "Loss/scores/real": real_logits.mean(),
             "Loss/signs/real": signs.mean()}
    return state, stats


def d_reg_step(cfg: TrainConfig, state, real_img, rng=None, draws=None):
    """Dr1: R1 gradient penalty on reals (loss_modified:249-272), a double
    backward through the discriminator and the ADA warp.

    Honors cfg.batch_gpu -- R1's double backward is the peak-memory phase."""
    _, d_opt, _ = make_optimizers(cfg)
    gain = float(cfg.d_reg_interval)
    rounds = _num_rounds(cfg, real_img.shape[0])

    def loss_fn(d_params, mb, dr):
        real = mb["real"].detach().requires_grad_(True)
        logits = _run_d(cfg, d_params, real, rng, state["ada_p"],
                        dr.get("aug"))
        (r1_grads,) = torch.autograd.grad(logits.sum(), real,
                                          create_graph=True)
        r1_penalty = r1_grads.square().sum(dim=(1, 2, 3))
        loss = r1_penalty.mean() * (cfg.r1_gamma / 2) * gain
        return loss, r1_penalty.mean().detach()

    loss, auxs, grads = _accum_grads(loss_fn, state["d_params"],
                                     {"real": real_img}, draws, rounds)
    penalty = torch.stack(auxs).mean()
    new_d, new_opt = _apply_updates(d_opt, state["d_params"], grads,
                                    state["d_opt"])
    state = dict(state, d_params=new_d, d_opt=new_opt)
    return state, {"Loss/r1_penalty": penalty, "Loss/D/reg": loss}


# ---------------------------------------------------------------------------
# G phases
# ---------------------------------------------------------------------------

def g_main_step(cfg: TrainConfig, state, geom_feats, geom_truth, z, rng=None,
                ema_beta=0.0, draws=None):
    """Gmain: softplus(-D(G(z))) + main_phase_losses (loss_modified:149-178).

    Honors cfg.batch_gpu gradient accumulation (w_avg takes the final
    round's EMA value; each round starts from the same pre-step w_avg).
    """
    g_opt, _, _ = make_optimizers(cfg)
    main_losses = cfg.losses("main")
    rounds = _num_rounds(cfg, z.shape[0])

    def loss_fn(g_params, mb, dr):
        img, debug = _run_g(cfg, g_params, state, mb["z"], mb["feats"], rng,
                            dr.get("g"))
        new_w_avg = update_w_avg(cfg.gen_cfg.mapping, debug["ws"],
                                 state["w_avg"])
        logits = _run_d(cfg, state["d_params"], img, rng, state["ada_p"],
                        dr.get("aug"))
        loss = F.softplus(-logits).mean()
        debug = dict(debug, fake_img=img)
        forger_loss, items = main_losses.compute(debug, mb["truth"],
                                                 rng=dr.get("loss_rng"))
        return loss + forger_loss, (loss.detach(), _detach(items), new_w_avg)

    batch = {"feats": list(geom_feats), "truth": geom_truth, "z": z}
    total, auxs, grads = _accum_grads(loss_fn, state["g_params"], batch,
                                      draws, rounds)
    gan_loss = torch.stack([a[0] for a in auxs]).mean()
    items = {k: torch.stack([a[1][k] for a in auxs]).mean()
             for k in auxs[0][1]}
    new_g, new_opt = _apply_updates(g_opt, state["g_params"], grads,
                                    state["g_opt"])
    new_ema = ema_update(state["g_ema"], new_g, ema_beta)
    state = dict(state, g_params=new_g, g_opt=new_opt, g_ema=new_ema,
                 w_avg=auxs[-1][2])
    stats = {"Loss/G/loss": gan_loss, "Loss/G/total_loss": total}
    stats.update({f"Loss/forger/Gmain/{k}": v for k, v in items.items()})
    return state, stats


def g_reg_step(cfg: TrainConfig, state, geom_feats, z, rng=None,
               ema_beta=0.0, draws=None):
    """Gpl: path-length regularization on a shrunk batch
    (loss_modified:207-223): the gradient of d(img)/d(ws), a double backward
    through the generator."""
    g_opt, _, _ = make_optimizers(cfg)
    gain = float(cfg.g_reg_interval)
    world = num_ranks()
    bs = z.shape[0] * world // cfg.pl_batch_shrink
    if world == 1:
        z = z[:bs]
        geom_feats = [f[:bs] for f in geom_feats]
    else:
        # The global first bs rows, each rank its even share of them.
        if bs % world:
            raise ValueError(f"{bs} path-length rows do not split over "
                             f"{world} ranks")
        mine = rows_of(bs // world)
        z = all_gather_rows(z)[:bs][mine]
        geom_feats = [all_gather_rows(f)[:bs][mine] for f in geom_feats]
    draws = draws or {}
    g_draws = draws.get("g") or {}
    g_state = {"w_avg": state["w_avg"], "noise": state["noise"]}

    g_params = _trainable(state["g_params"])
    mcfg = cfg.gen_cfg.mapping
    # Map z -> ws explicitly so the image can be differentiated w.r.t. ws.
    ws = mapping_apply(mcfg, g_params["mapping"], z, w_avg=state["w_avg"])
    if cfg.style_mixing_prob > 0:
        # The reference's Gpl runs G with default style mixing; PL grads are
        # w.r.t. the mixed ws.
        mixing = g_draws.get("mixing") or draw_style_mixing(
            rng, tuple(z.shape), z.device)
        ws2 = mapping_apply(mcfg, g_params["mapping"], mixing["z2"],
                            w_avg=state["w_avg"])
        ws = mix_styles(ws, ws2, mixing, cfg.style_mixing_prob)

    img, _ = generator_apply(
        cfg.gen_cfg, g_params, g_state, ws=ws, geom_features=geom_feats,
        noise_mode=cfg.noise_mode, rng=rng,
        random_noise=g_draws.get("noise"))
    pl_noise = draws.get("pl_noise")
    if pl_noise is None:
        pl_noise = draw_rows(
            torch.randn, img.shape, generator=rng,
            device=img.device if rng is None else rng.device).to(img.device)
    pl_noise = pl_noise / float(img.shape[1] * img.shape[2]) ** 0.5

    # Weight gradients flow through the second backward exactly as in the
    # reference.
    (pl_grads,) = torch.autograd.grad((img * pl_noise).sum(), ws,
                                      create_graph=True)
    pl_lengths = torch.sqrt(pl_grads.square().sum(dim=2).mean(dim=1))
    pl_mean = state["pl_mean"] + cfg.pl_decay * \
        (batch_mean(pl_lengths) - state["pl_mean"])
    pl_penalty = (pl_lengths - pl_mean).square()
    loss = pl_penalty.mean() * cfg.pl_weight * gain

    grads = _grads(loss, g_params)
    new_g, new_opt = _apply_updates(g_opt, state["g_params"], grads,
                                    state["g_opt"])
    new_ema = ema_update(state["g_ema"], new_g, ema_beta)
    state = dict(state, g_params=new_g, g_opt=new_opt, g_ema=new_ema,
                 pl_mean=pl_mean.detach())
    return state, {"Loss/pl_penalty": pl_penalty.mean().detach(),
                   "Loss/G/reg": loss.detach()}


def make_geom_step(cfg: TrainConfig, warmstart: bool):
    """Build the Ggeom / Ggeom-warm step with its layer mask
    (loss_modified:181-204; trainable layers per reference :296-301)."""
    losses = cfg.losses("warmstart" if warmstart else "geom")
    mode = cfg.geom_warmstart_mode if warmstart else cfg.geom_phase_mode
    needs_orig = losses.require_original_fake_image()
    phase = "Ggeom-warm" if warmstart else "Ggeom"

    def step(state, geom_feats, geom_truth, z, rng=None, ema_beta=0.0,
             g_orig_params=None, draws=None):
        _, _, geom_opt = make_optimizers(cfg)
        mask = generator_trainable_mask(cfg.gen_cfg, state["g_params"], mode)
        draws = draws or {}

        fake_orig = None
        if needs_orig:
            if g_orig_params is None:
                raise ValueError(
                    f"{phase}: a fake_orig loss needs g_orig_params")
            with torch.no_grad():
                fake_orig, _ = _run_g(cfg, g_orig_params, state, z,
                                      geom_feats, rng, draws.get("g_orig"),
                                      style_mixing_prob=0.0)

        g_params = _trainable(state["g_params"])
        img, debug = _run_g(cfg, g_params, state, z, geom_feats, rng,
                            draws.get("g"),
                            style_mixing_prob=0.0 if needs_orig else None)
        debug = dict(debug, fake_img=img)
        if fake_orig is not None:
            debug["fake_orig"] = fake_orig
        loss, items = losses.compute(debug, geom_truth,
                                     rng=draws.get("loss_rng"))

        grads = _grads(loss, g_params)
        new_g, new_opt = _apply_updates(geom_opt, state["g_params"], grads,
                                        state["geom_opt"], mask=mask)
        new_ema = ema_update(state["g_ema"], new_g, ema_beta)
        state = dict(state, g_params=new_g, geom_opt=new_opt, g_ema=new_ema)
        stats = {f"Loss/forger/{phase}/total": loss.detach()}
        stats.update({f"Loss/forger/{phase}/{k}": v.detach()
                      for k, v in items.items()})
        return state, stats

    return step


def g_stitch_step(cfg: TrainConfig, state, geom_feats1, geom_feats2, z,
                  crop1, crop2, rng=None, ema_beta=0.0, draws=None,
                  stitcher=None):
    """Gstitch: the stitch-phase losses on two overlapping crops and their
    cross-composites (loss_modified.accumulate_gradients_stitch, :108-138).

    G renders both crops with constant noise and no style mixing; D sees
    ``concat(fake1, fake2)`` and ``concat(composites)``, each pass with its
    own augment draws (``"aug_fake"``, ``"aug_composite"``), and the first
    crop's canvas positions are ``"positions1"`` or drawn from ``rng``.
    ``crop1`` / ``crop2``: ``(row, col, h, w)`` host ints.  With
    ``cfg.batch_gpu`` rounds, a round takes the same samples of both crops'
    features (a composite pairs sample i of one crop with sample i of the
    other).  ``stitcher``: a ``RandomStitcher`` (default margins if None).
    """
    from brushstroke_engine_torch.train.stitching import RandomStitcher
    g_opt, _, _ = make_optimizers(cfg)
    losses = cfg.losses("stitch")
    stitcher = stitcher or RandomStitcher()
    rounds = _num_rounds(cfg, z.shape[0])
    g_state = {"w_avg": state["w_avg"], "noise": state["noise"]}

    def loss_fn(g_params, mb, dr):
        res = stitcher.generate_with_stitching(
            cfg.gen_cfg, g_params, g_state, mb["z"], mb["feats1"],
            mb["feats2"], crop1, crop2, rng, positions1=dr.get("positions1"))
        fake = torch.cat([res["fake1"], res["fake2"]])
        composite = torch.cat([res["fake1_composite"],
                               res["fake2_composite"]])
        # Under a group each D pass sees the global fake1 rows, then the
        # global fake2 rows, as one process does.
        with row_parts(2):
            fake_logits = _run_d(cfg, state["d_params"], fake, rng,
                                 state["ada_p"], dr.get("aug_fake"))
            composite_logits = _run_d(cfg, state["d_params"], composite,
                                      rng, state["ada_p"],
                                      dr.get("aug_composite"))
        debug = {"fake": fake, "fake_logits": fake_logits,
                 "fake_composite": composite,
                 "fake_composite_logits": composite_logits,
                 "patch1": res["patch1"], "patch2": res["patch2"]}
        loss, items = losses.compute(debug, None, rng=dr.get("loss_rng"))
        return loss, _detach(items)

    batch = {"feats1": list(geom_feats1), "feats2": list(geom_feats2),
             "z": z}
    loss, auxs, grads = _accum_grads(loss_fn, state["g_params"], batch,
                                     draws, rounds)
    items = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    new_g, new_opt = _apply_updates(g_opt, state["g_params"], grads,
                                    state["g_opt"])
    new_ema = ema_update(state["g_ema"], new_g, ema_beta)
    state = dict(state, g_params=new_g, g_opt=new_opt, g_ema=new_ema)
    stats = {"Loss/forger/Gstitch/total": loss}
    stats.update({f"Loss/forger/Gstitch/{k}": v for k, v in items.items()})
    return state, stats


def make_stitch_step(cfg: TrainConfig, stitcher=None):
    """Gstitch as a step with the JAX package's argument order, ``step(state,
    geom_feats1, geom_feats2, z, crop1, crop2, rng, ema_beta,
    positions1=None, draws=None)``: :func:`g_stitch_step` with ``stitcher``
    (a default ``RandomStitcher`` if None) made once here.  ``positions1``
    (the whole batch's) stands in for ``draws["positions1"]``; with
    ``cfg.batch_gpu`` rounds each round takes its rows of it."""
    from brushstroke_engine_torch.train.stitching import RandomStitcher
    stitcher = stitcher or RandomStitcher()

    def step(state, geom_feats1, geom_feats2, z, crop1, crop2, rng=None,
             ema_beta=0.0, positions1=None, draws=None):
        if positions1 is not None:
            rounds = _num_rounds(cfg, z.shape[0])
            if rounds == 1:
                draws = dict(draws or {}, positions1=positions1)
            else:
                draws = [dict(d, positions1=p) for d, p in zip(
                    draws or [{}] * rounds, positions1.chunk(rounds))]
        return g_stitch_step(cfg, state, geom_feats1, geom_feats2, z, crop1,
                             crop2, rng=rng, ema_beta=ema_beta, draws=draws,
                             stitcher=stitcher)

    return step


def ada_update(cfg: TrainConfig, state, nimg_per_interval: float):
    """ADA p adjustment from accumulated real-sign statistics
    (training_loop_modified.py:516-519); stays on the device."""
    mean_sign = state["ada_signs"] / torch.clamp_min(state["ada_count"], 1)
    adjust = torch.sign(mean_sign - cfg.ada_target) * \
        (nimg_per_interval / (cfg.ada_kimg * 1000.0))
    new_p = torch.clamp_min(state["ada_p"] + adjust, 0.0)
    return dict(state, ada_p=new_p,
                ada_signs=torch.zeros_like(state["ada_signs"]),
                ada_count=torch.zeros_like(state["ada_count"]))
