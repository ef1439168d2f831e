"""Device-resident feature canvas: a painting session whose features never
leave the device.

Counterpart of the single-session part of
``brushstroke_engine_tpu/engine/device_canvas.py``.  The canvas
(intermediate generator activations + validity mask) lives on the engine's
device, and each stroke

  reads its window -> builds the blend alpha from the mask -> encodes and
  renders with the blended features -> writes the window back in place

so the only host traffic per stroke is the geometry in and the uint8 RGBA
out.  Windows are clamped into the canvas as ``jax.lax.dynamic_slice``
clamps them, while the generator's noise still sees the requested position.
The pooled multi-session batcher is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from brushstroke_engine_torch.engine.render import render_core
from brushstroke_engine_torch.utils.util import resolve_device


class CanvasState(NamedTuple):
    """Feature canvas: ``[1, H/d, W/d, C]`` features + ``[H/d, W/d]`` mask
    (float32, 1.0 where features are valid)."""
    features: torch.Tensor
    mask: torch.Tensor


def init_canvas_state(canvas_height: int, canvas_width: int,
                      down_factor: int, feature_channels: int,
                      dtype=torch.float32, device="cuda") -> CanvasState:
    dev = resolve_device(device)
    h = -(-canvas_height // down_factor)
    w = -(-canvas_width // down_factor)
    return CanvasState(
        features=torch.zeros((1, h, w, feature_channels), dtype=dtype,
                             device=dev),
        mask=torch.zeros((h, w), dtype=torch.float32, device=dev))


def clamp_start(start: int, size: int, window: int) -> int:
    """Start of a ``window`` inside ``[0, size)``, clamped as
    ``jax.lax.dynamic_slice`` clamps it."""
    return min(max(start, 0), size - window)


def _blend_alpha(mask_window, blend_margin: int, crop_margin: int):
    """Blend weight for stored features over a whole-tile dirty area
    (``canvas.generate_dirty_area_alpha`` specialised to the full-patch
    case).  Returns (alpha ``[h,w,1]``, update ``[h,w]``)."""
    h, w = mask_window.shape
    dev = mask_window.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    # Clamp so the dirty interior never vanishes for small blend windows.
    m = min(blend_margin + crop_margin, h // 4)
    blend_margin = max(min(blend_margin, h // 4), 1)
    lo = m
    hi_r = h - m
    hi_c = w - m
    # Distance-based ramp from the interior dirty area to the borders.
    d_r = torch.minimum(ys - lo, hi_r - 1 - ys)
    d_c = torch.minimum(xs - lo, hi_c - 1 - xs)
    d = torch.minimum(d_r, d_c)
    ramp = torch.clamp(1.0 + d / blend_margin, 0.0, 1.0)  # 1 inside, 0 at edge
    # Keep stored features where they exist and we are near the border.
    alpha = (1.0 - ramp) * mask_window
    update = torch.maximum((ramp > 0.99).float(),
                           mask_window * (alpha > 0).float())
    if crop_margin > 0:
        border = torch.zeros((h, w), device=dev)
        border[crop_margin:h - crop_margin, crop_margin:w - crop_margin] = 1.0
        update = update * border
    return alpha[..., None], update


def render_stroke_step(gen_cfg, enc_cfg, enc_res, render_mode: str,
                       blend_res: int, blend_margin: int, crop_margin: int,
                       bundle_params, canvas: CanvasState,
                       geom_patch, position, z, ws,
                       color_override, color_mask):
    """One interactive stroke; ``canvas`` is updated in place.  Returns
    (rgba ``[1,W,W,4]`` on the canvas's device, ``canvas``).

    Args:
      bundle_params: (gen_params, gen_state, enc_params, enc_state), on the
        canvas's device.
      geom_patch: ``[1, W, W, 1]`` float, 1 = background.
      position: (y, x) canvas coords (multiples of the down factor).
      z / ws: style (exactly one not None).
      color_override / color_mask: optional user colors (``[1,3,3]`` /
        ``[1,1,3]``).
    """
    patch = geom_patch.shape[1]
    down = patch // blend_res
    y, x = (int(v) for v in position)
    _, fh, fw, _ = canvas.features.shape
    fy = clamp_start(y // down, fh, blend_res)
    fx = clamp_start(x // down, fw, blend_res)
    win = (slice(fy, fy + blend_res), slice(fx, fx + blend_res))
    feats_win = canvas.features[:, win[0], win[1], :]
    mask_win = canvas.mask[win]

    alpha, update = _blend_alpha(mask_win, max(blend_margin // down, 1),
                                 crop_margin // down)
    # The device step composites like the triad head whatever the engine's
    # format: 'clear' takes U + V as alpha, every other mode is opaque.
    out = render_core(
        gen_cfg, enc_cfg, enc_res,
        "clear" if render_mode == "clear" else "full", (blend_res,), "triad",
        *bundle_params, geom_patch, z, ws, np.asarray([[y, x]], np.int64),
        None, color_override, color_mask,
        {blend_res: (feats_win, alpha[None])}, None,
        device=canvas.features.device)

    # Write back features where update is set.
    new_feats = out[f"features{blend_res}"].to(canvas.features.dtype)
    upd = update[None, :, :, None]
    merged = feats_win * (1 - upd) + new_feats * upd
    feats_win.copy_(merged)
    mask_win.copy_(torch.maximum(mask_win, update))
    return out["rgba"], canvas


def render_stroke_packed(gen_cfg, enc_cfg, enc_res, render_mode: str,
                         blend_res: int, blend_margin: int, crop_margin: int,
                         bundle_params, canvas: CanvasState,
                         packed, z, ws, color_override, color_mask):
    """:func:`render_stroke_step` behind the JAX package's one-vector
    request layout: ``packed`` is float32 ``[pw*pw + 2]``, the geometry
    patch followed by (y, x).  Returns (uint8 RGBA ``[pw, pw, 4]`` on the
    canvas's device, ``canvas``)."""
    packed = np.asarray(packed, np.float32)
    pw = int(round((packed.shape[0] - 2) ** 0.5))
    geom_patch = packed[:pw * pw].reshape(1, pw, pw, 1)
    position = packed[pw * pw:].astype(np.int32)
    rgba, canvas = render_stroke_step(
        gen_cfg, enc_cfg, enc_res, render_mode, blend_res, blend_margin,
        crop_margin, bundle_params, canvas, geom_patch, position, z, ws,
        color_override, color_mask)
    rgba_u8 = torch.clamp(rgba[0] * 255.0, 0, 255).to(torch.uint8)
    return rgba_u8, canvas


class DevicePaintSession:
    """An interactive painting session whose feature canvas stays on the
    engine's device.  API mirrors PaintingHelper.render_stroke for full
    patches."""

    def __init__(self, engine, canvas_height: int, canvas_width: int,
                 feature_blending_level: int = 2, blend_margin: int = 16,
                 crop_margin: int = 0):
        self.engine = engine
        self.level = feature_blending_level
        self.down = 2 ** (feature_blending_level - 1)
        self.blend_res = engine.patch_width // self.down
        self.blend_margin = blend_margin
        self.crop_margin = crop_margin
        ch = engine.gen_cfg.synthesis.channels(self.blend_res)
        self.canvas = init_canvas_state(canvas_height, canvas_width,
                                        self.down, ch, device=engine.device)
        self._params = (engine.gen_params, engine.gen_state,
                        engine.enc_params, engine.enc_state)
        # Device copies of the style tensors (z/ws/color override): they
        # change on a brush change, not per stroke.
        self._style_host = None
        self._style_dev = (None, None, None, None)

    def _style_arrays(self, opts):
        opts.prepare_style(1)
        override, cmask = opts.color_override(1)
        host = tuple(None if a is None else np.asarray(a, np.float32)
                     for a in (opts.style_z, opts.style_ws, override, cmask))
        if self._style_host is not None and all(
                (a is None) == (b is None)
                and (a is None or np.array_equal(a, b))
                for a, b in zip(host, self._style_host)):
            return self._style_dev
        self._style_host = host
        self._style_dev = tuple(
            None if a is None else torch.from_numpy(a).to(self.engine.device)
            for a in host)
        return self._style_dev

    def render_stroke_dispatch(self, stroke_patch: np.ndarray, opts,
                               x: int, y: int):
        """Enqueue one stroke; returns (uint8 RGBA tensor on the device,
        out meta).  The canvas advances at once, so the next stroke can be
        enqueued before this one's pixels are fetched."""
        eng = self.engine
        geom = np.asarray(eng.prepare_geom_input(stroke_patch),
                          np.float32).ravel()
        x = (x // self.down) * self.down
        y = (y // self.down) * self.down
        packed = np.concatenate([geom, np.asarray([y, x], np.float32)])
        z, ws, override, cmask = self._style_arrays(opts)
        rgba, self.canvas = render_stroke_packed(
            eng.gen_cfg, eng.enc_cfg, tuple(eng.enc_res),
            eng.render_mode, self.blend_res, self.blend_margin,
            self.crop_margin, self._params, self.canvas, packed, z, ws,
            override, cmask)
        return rgba, {"x": x + self.crop_margin, "y": y + self.crop_margin}

    def fetch(self, rgba) -> np.ndarray:
        """Download one dispatched stroke's uint8 RGBA."""
        img = rgba.cpu().numpy()
        if self.crop_margin > 0:
            m = self.crop_margin
            img = img[m:-m, m:-m]
        return img

    def render_stroke(self, stroke_patch: np.ndarray, opts,
                      x: int, y: int):
        """stroke_patch: uint8 ``[W, W, 4]``; returns uint8 RGBA + out
        meta."""
        rgba, meta = self.render_stroke_dispatch(stroke_patch, opts, x, y)
        return self.fetch(rgba), meta
