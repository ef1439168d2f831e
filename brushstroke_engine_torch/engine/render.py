"""Render core for the paint engines.

Counterpart of ``brushstroke_engine_tpu/engine/render.py``: geometry
encoding, generator synthesis, UVS clarity mapping, user-color override and
RGBA compositing for a batch of stroke patches.  PyTorch runs it eagerly;
there is no compile step to key on static arguments.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from brushstroke_engine_torch.models.generator import (
    GeneratorConfig, generator_apply,
)
from brushstroke_engine_torch.models.geo_encoder import (
    GeoEncoderConfig, geo_encoder_encode,
)
from brushstroke_engine_torch.utils.util import resolve_device


def map_uvs_s(uvs, sfactor):
    """Background-clarity UVS remap (reference mapper.py:52-72).

    S' = clamp(sfactor * S, 0, 1); U, V rescaled to keep the partition of
    unity: (U', V') = (U, V) * (1 - S') / (U + V).
    """
    u = uvs[..., 0:1]
    v = uvs[..., 1:2]
    s = uvs[..., 2:3]
    sp = torch.clamp(sfactor * s, max=1.0)
    delta = 1.0 - sp
    eps = 1e-6
    uv = torch.clamp(u + v, min=eps)
    uvfactor = torch.where(delta <= eps, torch.zeros_like(delta), delta / uv)
    return torch.cat([uvfactor * u, uvfactor * v, sp], dim=-1)


def _as_tensor(x, device, dtype=None):
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x, device=device, dtype=dtype)


@torch.inference_mode()
def render_core(gen_cfg: GeneratorConfig, enc_cfg: GeoEncoderConfig,
                enc_res: Tuple[int, ...], render_mode: str,
                return_features: Tuple[int, ...], color_format: str,
                gen_params, gen_state, enc_params, enc_state,
                geom, z, ws, positions, noise_buffers,
                color_override, color_mask, blended_features, sfactor,
                device="cuda"):
    """Render a batch of stroke patches on ``device``.

    Args:
      geom: ``[B, W, W, 1]`` float in [0,1], 1 = background.
      z: ``[B, z_dim]`` or None;  ws: ``[B, num_ws, w_dim]`` or None.
      positions: ``[B, 2]`` int (y, x) canvas positions or None.
      noise_buffers: per-style noise dict (reference key format) or None.
      color_override: ``[B, 3, 3]`` user colors or None.
      color_mask: ``[1, 1, 3]`` (or ``[B, 1, 3]``) float, 1 where override
        applies.
      blended_features: {res: (feats, alpha)} or None.
      sfactor: scalar clarity factor or None (disables UVS mapping).
      device: where to render; the parameter trees must already be there.
        Array inputs (numpy or tensors) are moved there.

    Returns:
      dict with 'rgba' ``[B, W, W, 4]`` in [0,1], 'uvs', 'colors',
      'raw_img', 'alpha_fg' and 'canvas' (canvas format), and any
      'features{res}' requested.
    """
    dev = resolve_device(device)
    f32 = torch.float32
    geom = _as_tensor(geom, dev, f32)
    z = _as_tensor(z, dev, f32)
    ws = _as_tensor(ws, dev, f32)
    positions = _as_tensor(positions, dev)
    if noise_buffers is not None:
        noise_buffers = {k: _as_tensor(v, dev, f32)
                         for k, v in noise_buffers.items()}
    if blended_features is not None:
        blended_features = {r: (_as_tensor(f, dev), _as_tensor(a, dev, f32))
                            for r, (f, a) in blended_features.items()}

    feats = geo_encoder_encode(enc_cfg, enc_params, enc_state, geom,
                               res=list(enc_res))
    img, debug = generator_apply(
        gen_cfg, gen_params, gen_state, z=z, ws=ws, geom_features=feats,
        positions=positions, noise_buffers=noise_buffers,
        noise_mode="const", return_debug_data=True,
        return_features=return_features, blended_features=blended_features)

    uvs = debug["uvs"]                              # [B, W, W, 3]
    colors = (debug["colors"] + 1.0) / 2.0          # [B, 3(rgb), 3(slot)]

    if sfactor is not None:
        uvs = map_uvs_s(uvs, float(sfactor))
    if color_override is not None:
        mask = _as_tensor(color_mask, dev, f32)
        colors = mask * _as_tensor(color_override, dev, f32) \
            + (1.0 - mask) * colors

    stroke = torch.einsum("bhwk,bck->bhwc", uvs, colors)
    ones = torch.ones_like(stroke[..., :1])
    if color_format == "triad":
        if render_mode == "clear":
            alpha = uvs[..., 0:2].sum(dim=-1, keepdim=True)
        elif render_mode == "full":
            alpha = ones
        else:
            raise ValueError(
                f"triad engine: unknown render mode {render_mode}")
        rgba = torch.cat([stroke, alpha], dim=-1)
    else:
        # The canvas head (reference brush.py:905-947): its own alpha and a
        # generated canvas color in [-1, 1].
        alpha_fg = debug["alpha_fg"]
        gen_canvas = debug["canvas"]
        if render_mode == "clear":
            rgba = torch.cat([stroke, alpha_fg], dim=-1)
        elif render_mode == "stroke":
            rgba = torch.cat([stroke, ones], dim=-1)
        elif render_mode == "canvas":
            rgba = torch.cat([(gen_canvas + 1.0) / 2.0, ones], dim=-1)
        elif render_mode == "full":
            comp = (1 - alpha_fg) * (gen_canvas + 1.0) / 2.0 \
                + alpha_fg * stroke
            rgba = torch.cat([comp, ones], dim=-1)
        else:
            raise ValueError(
                f"canvas engine: unknown render mode {render_mode}")

    out = {"rgba": rgba, "uvs": uvs, "colors": colors, "raw_img": img}
    for r in return_features:
        out[f"features{r}"] = debug[f"features{r}"]
        out[f"features{r}_preblend"] = debug[f"features{r}_preblend"]
    for k in ("alpha_fg", "canvas"):
        if k in debug:
            out[k] = debug[k]
    return out


@torch.inference_mode()
def sfactor_core(gen_cfg: GeneratorConfig, enc_cfg: GeoEncoderConfig,
                 enc_res: Tuple[int, ...], k: int,
                 gen_params, gen_state, enc_params, enc_state,
                 geom_med, bmask, z, ws):
    """Per-style background-clarity factor (reference mapper.get_sfactor,
    mapper.py:117-136).

    Renders the medium curated geometry, takes per patch the k-th largest S
    over known-background pixels (thick-geometry mask), then
    sfactor = 1 / min over patches.  All tensors on one device.
    """
    feats = geo_encoder_encode(enc_cfg, enc_params, enc_state, geom_med,
                               res=list(enc_res))
    n = geom_med.shape[0]
    if ws is not None:
        ws, z = ws.expand(n, *ws.shape[1:]), None
    else:
        z = z.expand(n, z.shape[-1])
    _, debug = generator_apply(
        gen_cfg, gen_params, gen_state, z=z, ws=ws, geom_features=feats,
        noise_mode="const", return_debug_data=True)
    s = debug["uvs"][..., 2]                       # [N, W, W]
    s_masked = torch.where(bmask, s, torch.full_like(s, -float("inf")))
    topk = torch.topk(s_masked.reshape(n, -1), k, dim=1).values  # [N, k]
    return 1.0 / topk[:, -1].min()
