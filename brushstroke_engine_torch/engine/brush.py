"""Paint engines: GAN-backed stroke renderers with user color control.

Counterpart of ``brushstroke_engine_tpu/engine/brush.py`` for the triad
engine: ``GanBrushOptions``, ``GanPaintEngine`` / ``TriadGanPaintEngine``
with ``render_stroke``, ``render_batch``, ``random_style`` and
``prepare_geom_input``.  The numeric path is :func:`render.render_core`;
these classes handle uint8 <-> device conversion and brush state.  The int8
path, the serving mesh and the canvas engine are not ported yet.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np

from brushstroke_engine_torch.engine.library import seed_to_z
from brushstroke_engine_torch.engine.render import render_core
from brushstroke_engine_torch.models.generator import GeneratorConfig
from brushstroke_engine_torch.models.geo_encoder import GeoEncoderConfig
from brushstroke_engine_torch.utils.util import resolve_device, tree_to

logger = logging.getLogger(__name__)


def _prep_color(x):
    """uint8 [0..255] or float [0..1], [3] or [B,3] -> float32 [B,3]."""
    if x is None:
        return None
    c = np.asarray(x)
    if c.dtype == np.uint8:
        c = c.astype(np.float32) / 255.0
    else:
        c = c.astype(np.float32)
    if c.ndim == 1:
        c = c[None]
    return c


class GanBrushOptions:
    """Brush state: style (z or W + noise buffers), user colors, position,
    debug flag (reference brush.py:410-527)."""

    def __init__(self, primary_color=None, secondary_color=None, debug=False):
        self.color0 = _prep_color(primary_color)
        self.color1 = _prep_color(secondary_color)
        self.canvas_color = None
        self.style_z = None
        self.style_id = None
        self.library_id = ""
        self.style_ws = None
        self.debug = debug
        self.position = None          # [B, 2] int64 (y, x)
        self.custom_args: Dict = {}
        self.enable_uvs_mapping = False

    def set_position(self, x, y):
        if np.isscalar(x):
            self.position = np.asarray([[y, x]], np.int64)
        else:
            self.position = np.stack([np.asarray(y), np.asarray(x)],
                                     axis=1).astype(np.int64)

    def get_position(self):
        return self.position

    def set_color(self, color_idx: int, in_color):
        if color_idx == 0:
            self.color0 = _prep_color(in_color)
        elif color_idx == 1:
            self.color1 = _prep_color(in_color)
        elif color_idx == 2:
            self.canvas_color = _prep_color(in_color)
        else:
            logger.error(f"Wrong color idx {color_idx}")

    def set_style(self, style_z, style_id=None):
        self.style_z = None if style_z is None else np.asarray(style_z)
        self.style_id = style_id
        self.style_ws = None

    def set_style_w(self, style_w, style_id=None, custom_args=None):
        self.style_ws = None if style_w is None else np.asarray(style_w)
        self.style_id = style_id
        self.style_z = None
        self.custom_args = dict(custom_args) if custom_args else {}

    def prepare_style(self, batch_size: int):
        def prep(x):
            if x is None:
                return None
            if x.shape[0] != batch_size:
                if x.shape[0] != 1:
                    # Styles are per-brush (identical rows): re-broadcast
                    # from row 0.
                    x = x[:1]
                reps = (batch_size,) + (1,) * (x.ndim - 1)
                return np.tile(x, reps)
            return x
        self.style_z = prep(self.style_z)
        self.style_ws = prep(self.style_ws)

    def color_override(self, batch_size: int):
        """Returns (override [B,3,3], mask [1,1,3]) or (None, None)."""
        if self.color0 is None and self.color1 is None \
                and self.canvas_color is None:
            return None, None
        override = np.zeros((batch_size, 3, 3), np.float32)
        mask = np.zeros((1, 1, 3), np.float32)
        for idx, col in enumerate([self.color0, self.color1,
                                   self.canvas_color]):
            if col is not None:
                override[:, :, idx] = col
                mask[0, 0, idx] = 1.0
        return override, mask


class GanPaintEngine:
    """GAN-backed engine core: holds the generator and frozen geometry
    encoder parameter trees on ``device`` and calls the render core.

    The trees are the port's tensors (:func:`utils.checkpoint.params_from_jax`
    or :func:`utils.checkpoint.load_native`).  ``device`` defaults to CUDA and
    raises without it; pass ``device="cpu"`` to render on the CPU.
    """

    color_format = "triad"

    def __init__(self, gen_cfg: GeneratorConfig, gen_params, gen_state,
                 enc_cfg: GeoEncoderConfig, enc_params, enc_state,
                 geom_inject_resolutions=(0,),
                 gan_checkpoint: str = "", encoder_checkpoint: str = "",
                 device="cuda"):
        self.device = resolve_device(device)
        self.gen_cfg = gen_cfg
        # Weights are moved to the device once, not per render.
        self.gen_params, self.gen_state, self.enc_params, self.enc_state = (
            tree_to(t, self.device)
            for t in (gen_params, gen_state, enc_params, enc_state))
        self.enc_cfg = enc_cfg
        self.enc_res = tuple(geom_inject_resolutions)
        self.gan_checkpoint = gan_checkpoint
        self.encoder_checkpoint = encoder_checkpoint
        self.patch_width = gen_cfg.img_resolution
        self.render_modes = {"clear", "full"}
        self.render_mode = "clear"

        # Imported here to avoid a cycle (the mapper renders via this engine).
        from brushstroke_engine_torch.engine.mapper import StyleUVSMapper
        self.uvs_mapper = StyleUVSMapper(self)

    def set_render_mode(self, mode):
        if mode not in self.render_modes:
            raise RuntimeError(f"Render mode should be one of "
                               f"{self.render_modes}")
        self.render_mode = mode

    def summary(self):
        return "{} GAN: {} encoder: {}".format(
            type(self).__name__, self.gan_checkpoint,
            self.encoder_checkpoint)

    def random_style(self, seed):
        # Bit-compatible with reference brush identities (brush.py:667-670).
        return seed_to_z(seed, self.gen_cfg.z_dim)

    def prepare_geom_input(self, stroke_patch: np.ndarray) -> np.ndarray:
        """W x W x {1,4} uint8 (opaque 255 = FG) -> [1, W, W, 1] float
        (0 = FG stroke, 1 = BG), reference brush.py:672-681."""
        alpha = stroke_patch[:, :, -1:].astype(np.float32) / 255.0
        return (1.0 - alpha)[None]

    def _render(self, geom, z, ws, positions, noise_buffers, override, mask,
                blended_features, sfactor, return_features):
        return render_core(
            self.gen_cfg, self.enc_cfg, self.enc_res, self.render_mode,
            tuple(return_features), self.color_format,
            self.gen_params, self.gen_state, self.enc_params, self.enc_state,
            geom, z, ws, positions, noise_buffers, override, mask,
            blended_features, sfactor, device=self.device)

    def _run_core(self, geom, opts: GanBrushOptions,
                  blended_features=None, return_features=()):
        b = geom.shape[0]
        opts.prepare_style(b)
        override, mask = opts.color_override(b)
        sfactor = None
        if opts.enable_uvs_mapping:
            sfactor = self.uvs_mapper.get_sfactor(opts)
        noise_buffers = opts.custom_args.get("noise_buffers") or None
        if noise_buffers is not None:
            noise_buffers = {k: np.asarray(v, np.float32).reshape(
                np.asarray(v).shape[-2:]) for k, v in noise_buffers.items()}
        return self._render(geom, opts.style_z, opts.style_ws,
                            opts.get_position(), noise_buffers, override,
                            mask, blended_features, sfactor, return_features)

    def render_batch(self, geoms, opts_list, blended_features=None,
                     return_features=()):
        """Render B independent single-patch requests as ONE call.

        Args:
          geoms: ``[B, W, W, 1]`` float geometry rows.
          opts_list: B GanBrushOptions; all rows must share style kind
            (all-z or all-ws), position presence, and must not use stored
            noise buffers or UVS mapping.
          blended_features: {res: (feats [B,R,R,C], alpha [B,R,R,1])} or None.

        Returns the render-core output dict ('rgba' [B,W,W,4], ...).
        """
        b = geoms.shape[0]
        use_ws = opts_list[0].style_ws is not None
        rows = []
        for o in opts_list:
            o.prepare_style(1)
            if (o.style_ws is not None) != use_ws:
                raise ValueError("mixed z/ws rows in a render batch")
            if o.custom_args.get("noise_buffers"):
                raise ValueError("stored-noise brushes cannot batch")
            if o.enable_uvs_mapping:
                raise ValueError("uvs-mapped rows cannot batch")
            rows.append(o.style_ws[0] if use_ws else o.style_z[0])
        style = np.stack(rows).astype(np.float32)

        positions = None
        if opts_list[0].get_position() is not None:
            positions = np.concatenate(
                [np.asarray(o.get_position())[:1] for o in opts_list])

        # Always pass override+mask (zero mask = no-op).
        override = np.zeros((b, 3, 3), np.float32)
        mask = np.zeros((b, 1, 3), np.float32)
        for i, o in enumerate(opts_list):
            ov, mk = o.color_override(1)
            if ov is not None:
                override[i] = ov[0]
                mask[i, 0] = mk[0, 0]

        return self._render(geoms, None if use_ws else style,
                            style if use_ws else None, positions, None,
                            override, mask, blended_features, None,
                            return_features)

    def render_stroke(self, stroke_patch, canvas_patch, opts,
                      **generator_kwargs):
        """uint8 W x W x 4 stroke patch -> (uint8 W x W x 4 RGBA, debug)."""
        geom = self.prepare_geom_input(stroke_patch)
        geom = geom.reshape(1, self.patch_width, self.patch_width, 1)
        out = self._run_core(
            geom, opts,
            blended_features=generator_kwargs.get("blended_features"),
            return_features=generator_kwargs.get("return_features", ()))
        debug_img = self._make_debug_image(geom, out) if opts.debug else None
        res = out["rgba"][0].cpu().numpy()
        res = np.clip(res * 255.0, 0, 255).astype(np.uint8)
        return np.ascontiguousarray(res), debug_img

    def _make_debug_image(self, geom, out):
        """Contact sheet: input geometry | u | v | s | composite."""
        pw = self.patch_width
        margin = 5
        uvs = out["uvs"][0].cpu().numpy()
        rgba = np.clip(out["rgba"][0].cpu().numpy() * 255, 0, 255)
        panels = [np.tile(np.asarray(geom[0]) * 255, (1, 1, 3)),
                  *[np.tile(uvs[..., i:i + 1] * 255, (1, 1, 3))
                    for i in range(3)],
                  rgba[..., :3]]
        sheet = np.zeros((pw, len(panels) * (pw + margin), 4), np.uint8)
        x = 0
        for p in panels:
            sheet[:, x:x + pw, :3] = p.astype(np.uint8)
            sheet[:, x:x + pw, 3] = 255
            x += pw + margin
        return np.ascontiguousarray(sheet)


class TriadGanPaintEngine(GanPaintEngine):
    """Color-triad (UVS) engine: composite = sum_k uvs_k * color_k, alpha =
    U + V in clear mode (reference brush.py:720-805)."""

    color_format = "triad"

