"""Post-hoc background-clarity finetuning of library styles.

Counterpart of ``brushstroke_engine_tpu/tools/clarity.py``: for each style
of a W brush library, optimize its W+ for background clarity while staying
perceptually close to the original render.  The default objective

    0.5*iou_inv(uvs) + 0.5*iou(u) + 50*lpips(fake_orig) + 50*l1(fake_orig)

goes through the training loss DSL (``train/losses.py:ForgerLosses``).  Each
step encodes a fresh geometry batch and renders it twice: ``fake_orig`` with
the frozen starting W (no gradient), and the current W.
"""

from __future__ import annotations

import logging
import pickle
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from brushstroke_engine_torch.models.generator import generator_apply
from brushstroke_engine_torch.models.geo_encoder import geo_encoder_encode
from brushstroke_engine_torch.models.mapping import mapping_apply
from brushstroke_engine_torch.train.losses import ForgerLosses
from brushstroke_engine_torch.train.state import Adam

logger = logging.getLogger(__name__)

DEFAULT_LOSSES = ("0.5*iou_inv(uvs)+0.5*iou(u)"
                  "+50*lpips(fake_orig)+50*l1(fake_orig)")


@dataclass(frozen=True)
class ClarityConfig:
    num_steps: int = 300
    learning_rate: float = 0.01
    losses: str = DEFAULT_LOSSES


def clarity_loss(engine, losses: ForgerLosses, w, w_frozen, geom,
                 noise_buffers=None):
    """The objective at style ``w`` ``[1, num_ws, w_dim]`` on one geometry
    batch ``[B, W, W, 1]`` (a tensor on the engine's device): (total, items).
    """
    with torch.no_grad():
        feats = geo_encoder_encode(engine.enc_cfg, engine.enc_params,
                                   engine.enc_state, geom,
                                   res=list(engine.enc_res))
    g_state = {"w_avg": engine.gen_state.get("w_avg"),
               "noise": engine.gen_state["noise"]}
    b = geom.shape[0]

    def render(ws):
        return generator_apply(
            engine.gen_cfg, engine.gen_params, g_state,
            ws=ws.expand(b, -1, -1), geom_features=feats, noise_mode="const",
            noise_buffers=noise_buffers, return_debug_data=True)

    with torch.no_grad():
        fake_orig, _ = render(w_frozen)
    img, debug = render(w)
    debug = dict(debug, fake_img=img, fake_orig=fake_orig)
    return losses.compute(debug, geom)


def optimize_style_clarity(engine, w_init, geometry_batches,
                           cfg: ClarityConfig = ClarityConfig(),
                           noise_buffers: Optional[Dict] = None,
                           seed: int = 0) -> Dict:
    """Optimize one style's W+ for clarity.

    Args:
      engine: GanPaintEngine.
      w_init: ``[1, num_ws, w_dim]`` starting style.
      geometry_batches: iterator of ``[B, W, W, 1]`` float geometry patches
        (0 = FG); a fresh batch is consumed each step.
      noise_buffers: ``{key: [H, W]}`` noise textures of the style, or None.
      seed: unused (the default objective draws nothing); kept for the JAX
        package's signature.

    Returns {'w': optimized W+, 'loss': the last step's total}.
    """
    dev = engine.device
    losses = ForgerLosses.create_from_string(cfg.losses)
    w_frozen = torch.as_tensor(np.array(w_init, np.float32), device=dev)
    if noise_buffers:
        noise_buffers = {k: torch.as_tensor(np.asarray(v, np.float32),
                                            device=dev)
                         for k, v in noise_buffers.items()}
    params = {"w": w_frozen.clone()}
    opt = Adam(lr=cfg.learning_rate, b1=0.9, b2=0.999)
    opt_state = opt.init(params)
    total = None
    for step in range(cfg.num_steps):
        geom = torch.as_tensor(np.asarray(next(geometry_batches), np.float32),
                               device=dev)
        w = params["w"].requires_grad_(True)
        total, _ = clarity_loss(engine, losses, w, w_frozen, geom,
                                noise_buffers)
        (grad,) = torch.autograd.grad(total, [w])
        with torch.no_grad():
            upd, opt_state = opt.update({"w": grad}, opt_state)
            params = {"w": w.detach() + upd["w"]}
        if (step + 1) % 50 == 0 or step + 1 == cfg.num_steps:
            logger.info("clarity step %d: loss %.4f", step + 1,
                        float(total.detach()))
    return {"w": params["w"].cpu().numpy(),
            "loss": float("inf") if total is None
            else float(total.detach())}


def optimize_library_clarity(engine, library, geometry_batches,
                             out_path: Optional[str] = None,
                             cfg: ClarityConfig = ClarityConfig()) -> Dict:
    """Optimize every style of a brush library; write ``OPT_<name>.pkl``
    (``{style_id: {'w': ..., 'noise': ...}}``, the JAX package's schema)."""
    from brushstroke_engine_torch.engine.brush import GanBrushOptions

    results = {}
    for style_id in library.get_style_ids():
        opts = GanBrushOptions()
        library.set_style(style_id, opts)
        if opts.style_ws is not None:
            w0 = opts.style_ws
        else:
            with torch.no_grad():
                w0 = mapping_apply(
                    engine.gen_cfg.mapping, engine.gen_params["mapping"],
                    torch.as_tensor(np.asarray(opts.style_z, np.float32),
                                    device=engine.device),
                    None, w_avg=engine.gen_state.get("w_avg")).cpu().numpy()
        raw_nb = opts.custom_args.get("noise_buffers")
        nb = None
        if raw_nb:
            nb = {k: np.asarray(v).reshape(np.asarray(v).shape[-2:])
                  for k, v in raw_nb.items()}
        res = optimize_style_clarity(engine, w0, geometry_batches, cfg,
                                     noise_buffers=nb)
        entry = {"w": res["w"]}
        if raw_nb:
            entry["noise"] = raw_nb
        results[style_id] = entry
        logger.info("optimized style %s: loss %.4f", style_id, res["loss"])

    if out_path is not None:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)
    return results
