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

The pool (:class:`PoolState`, :func:`render_strokes_pool`,
:class:`DeviceCanvasPool`) holds N sessions' canvases as slots of one
stacked tensor and renders one stroke of each of them in one generator pass.
"""

from __future__ import annotations

from typing import List, NamedTuple

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
    case).  Returns (alpha ``[...,h,w,1]``, update ``[...,h,w]``) for a mask
    window ``[...,h,w]``."""
    h, w = mask_window.shape[-2:]
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
                       color_override, color_mask, quant_scales=None):
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
      quant_scales: the engine's static int8 scales (``_quant_key``) or
        None.
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
        device=canvas.features.device, quant_scales=quant_scales)

    # Write back features where update is set.
    new_feats = out[f"features{blend_res}"].to(canvas.features.dtype)
    upd = update[None, :, :, None]
    merged = feats_win * (1 - upd) + new_feats * upd
    feats_win.copy_(merged)
    mask_win.copy_(torch.maximum(mask_win, update))
    return out["rgba"], canvas


class PoolState(NamedTuple):
    """S stacked session canvases: ``[S, H/d, W/d, C]`` features +
    ``[S, H/d, W/d]`` mask.  Slot S-1 is scratch (the warm-up renders there
    and no session reads it)."""
    features: torch.Tensor
    mask: torch.Tensor


@torch.inference_mode()
def render_strokes_pool(gen_cfg, enc_cfg, enc_res, render_mode: str,
                        blend_res: int, blend_margin: int, crop_margin: int,
                        bundle_params, pool: PoolState, slots: List[int],
                        alpha_u8, pos, z, ws, color_override, color_mask,
                        quant_scales=None):
    """N sessions' strokes in one generator pass; ``pool`` is updated in
    place.  Row i equals :func:`render_stroke_step` of that stroke on slot
    ``slots[i]``'s canvas.

    Args:
      slots: N pool rows; real rows hold distinct slots (a flush takes at
        most one stroke per session).
      alpha_u8: ``[N, pw*pw]`` uint8 tensor on the pool's device: the
        strokes' raw alpha as it arrives on the wire (one byte per pixel
        crosses to the device); the inversion to geometry runs here.
      pos: N (y, x) canvas coords (multiples of the down factor).
      z / ws: ``[N, z_dim]`` or ``[N, num_ws, w_dim]`` tensors; one is None.
      color_override / color_mask: ``[N, 3, 3]`` / ``[N, 1, 3]`` (a zero
        mask row leaves that row's colors as they are).
      quant_scales: the engine's static int8 scales (``_quant_key``) or
        None.

    Returns uint8 RGBA ``[N, pw, pw, 4]`` on the pool's device.
    """
    n = alpha_u8.shape[0]
    pw = int(round(alpha_u8.shape[1] ** 0.5))
    dev = pool.features.device
    geom = 1.0 - alpha_u8.reshape(n, pw, pw, 1).float() / 255.0
    down = pw // blend_res
    _, fh, fw, _ = pool.features.shape
    ar = np.arange(blend_res)
    iy = np.stack([clamp_start(int(y) // down, fh, blend_res) + ar
                   for y, _ in pos])
    ix = np.stack([clamp_start(int(x) // down, fw, blend_res) + ar
                   for _, x in pos])
    si = torch.as_tensor(np.asarray(slots), device=dev)[:, None, None]
    iy = torch.from_numpy(iy).to(dev)[:, :, None]
    ix = torch.from_numpy(ix).to(dev)[:, None, :]
    feats_win = pool.features[si, iy, ix]             # [N, R, R, C]
    mask_win = pool.mask[si, iy, ix]                  # [N, R, R]
    alpha, update = _blend_alpha(mask_win, max(blend_margin // down, 1),
                                 crop_margin // down)
    out = render_core(
        gen_cfg, enc_cfg, enc_res,
        "clear" if render_mode == "clear" else "full", (blend_res,), "triad",
        *bundle_params, geom, z, ws, np.asarray(pos, np.int64), None,
        color_override, color_mask, {blend_res: (feats_win, alpha)}, None,
        device=dev, quant_scales=quant_scales)
    new_feats = out[f"features{blend_res}"].to(pool.features.dtype)
    upd = update[..., None]
    # One scatter for all rows.  Real rows hold distinct slots, so no two
    # of them write the same element; only the warm-up's rows share a slot,
    # the scratch one, whose content no session reads.
    pool.features[si, iy, ix] = feats_win * (1 - upd) + new_feats * upd
    pool.mask[si, iy, ix] = torch.maximum(mask_win, update)
    return torch.clamp(out["rgba"] * 255.0, 0, 255).to(torch.uint8)


class DeviceCanvasPool:
    """Slot allocator over one stacked canvas (:class:`PoolState`) on the
    engine's device.

    Sessions that share a canvas configuration (shape, blending level, crop)
    draw from one pool; a cross-session flush renders one pending stroke of
    each through :func:`render_strokes_pool`.  The last slot is scratch.
    """

    def __init__(self, engine, canvas_height: int, canvas_width: int,
                 feature_blending_level: int = 2, blend_margin: int = 16,
                 crop_margin: int = 0, capacity: int = 8):
        self.engine = engine
        self.level = feature_blending_level
        self.down = 2 ** (feature_blending_level - 1)
        self.blend_res = engine.patch_width // self.down
        self.blend_margin = blend_margin
        self.crop_margin = crop_margin
        self.canvas_shape = (canvas_height, canvas_width)
        self.channels = engine.gen_cfg.synthesis.channels(self.blend_res)
        self._params = (engine.gen_params, engine.gen_state,
                        engine.enc_params, engine.enc_state)
        self._free = list(range(capacity))
        self._capacity = capacity
        h = -(-canvas_height // self.down)
        w = -(-canvas_width // self.down)
        # Made (and later changed) in inference mode, as the render that
        # writes into it runs there.
        with torch.inference_mode():
            self.state = PoolState(
                features=torch.zeros((capacity + 1, h, w, self.channels),
                                     device=engine.device),
                mask=torch.zeros((capacity + 1, h, w), device=engine.device))

    @property
    def scratch_slot(self) -> int:
        return self.state.mask.shape[0] - 1

    def acquire(self) -> int:
        """Claim a slot (a fresh canvas: its mask is zeroed).  When none is
        free the pool doubles: one reallocation and copy, the old scratch
        row becoming a regular slot and the new last row the scratch."""
        if not self._free:
            grow = self._capacity
            self._capacity *= 2
            self._free = list(range(grow, self._capacity))
            old = self.state
            with torch.inference_mode():
                self.state = PoolState(*(torch.cat(
                    [t, t.new_zeros((grow,) + t.shape[1:])])
                    for t in (old.features, old.mask)))
        slot = self._free.pop(0)
        self.reset_slot(slot)
        return slot

    def reset_slot(self, slot: int):
        """New canvas for a session: invalidate its stored features."""
        with torch.inference_mode():
            self.state.mask[slot] = 0.0

    def release(self, slot: int):
        if slot not in self._free:
            self._free.append(slot)

    def render_batch(self, requests):
        """Render N sessions' strokes in one generator pass.

        Args:
          requests: dicts with ``slot``, ``geom`` (the stroke's uint8 alpha
            ``[pw*pw]`` as it came off the wire), ``x``, ``y`` (canvas ints,
            aligned down here) and ``opts`` (GanBrushOptions; all rows z or
            all rows W).

        Returns (uint8 RGBA tensor ``[N, pw, pw, 4]`` on the device, N out
        metas).  Cropping ``crop_margin`` is the caller's, after the copy.
        """
        eng = self.engine
        n = len(requests)
        use_ws = requests[0]["opts"].style_ws is not None
        override = np.zeros((n, 3, 3), np.float32)
        cmask = np.zeros((n, 1, 3), np.float32)
        pos, style, metas = [], [], []
        for i, req in enumerate(requests):
            o = req["opts"]
            o.prepare_style(1)
            if (o.style_ws is not None) != use_ws:
                raise ValueError("mixed z/ws rows in a pooled render batch")
            x = (int(req["x"]) // self.down) * self.down
            y = (int(req["y"]) // self.down) * self.down
            pos.append((y, x))
            style.append(o.style_ws[0] if use_ws else o.style_z[0])
            ov, mk = o.color_override(1)
            if ov is not None:
                override[i] = ov[0]
                cmask[i, 0] = mk[0, 0]
            metas.append({"x": x + self.crop_margin,
                          "y": y + self.crop_margin})
        dev = eng.device
        alpha = torch.from_numpy(np.stack(
            [np.asarray(r["geom"], np.uint8) for r in requests])).to(dev)
        style = torch.from_numpy(np.stack(style).astype(np.float32)).to(dev)
        rgba = render_strokes_pool(
            eng.gen_cfg, eng.enc_cfg, tuple(eng.enc_res), eng.render_mode,
            self.blend_res, self.blend_margin, self.crop_margin,
            self._params, self.state, [int(r["slot"]) for r in requests],
            alpha, pos, None if use_ws else style, style if use_ws else None,
            torch.from_numpy(override).to(dev),
            torch.from_numpy(cmask).to(dev), quant_scales=eng._quant_key())
        return rgba, metas


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
        pw = eng.patch_width
        geom = eng.prepare_geom_input(stroke_patch).reshape(1, pw, pw, 1)
        x = (x // self.down) * self.down
        y = (y // self.down) * self.down
        z, ws, override, cmask = self._style_arrays(opts)
        rgba, self.canvas = render_stroke_step(
            eng.gen_cfg, eng.enc_cfg, tuple(eng.enc_res),
            eng.render_mode, self.blend_res, self.blend_margin,
            self.crop_margin, self._params, self.canvas, geom, (y, x), z, ws,
            override, cmask, quant_scales=eng._quant_key())
        rgba_u8 = torch.clamp(rgba[0] * 255.0, 0, 255).to(torch.uint8)
        return rgba_u8, {"x": x + self.crop_margin,
                         "y": y + self.crop_margin}

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
