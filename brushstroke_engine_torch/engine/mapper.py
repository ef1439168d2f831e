"""Per-style background-clarity ("UVS") mapping, brush icons and color chips.

Counterpart of ``StyleUVSMapper`` in
``brushstroke_engine_tpu/engine/mapper.py``: for a style, render 5 curated
medium-thickness geometry patches, take the 15th-largest background S over
known-background pixels (from the thick variants), and derive
``sfactor = 1 / val``.  At render time ``S' = clamp(sfactor * S)`` with U, V
rescaled (see render.map_uvs_s).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from brushstroke_engine_torch.data.curated_geometry import (
    curated_geometry_batch, MAPPER_SHAPES, MAPPER_MED_RADIUS,
    MAPPER_THICK_RADIUS,
)
from brushstroke_engine_torch.engine.render import map_uvs_s, sfactor_core

logger = logging.getLogger(__name__)


class StyleUVSMapper:
    TOP_K = 15

    def __init__(self, engine):
        self.sfactors = {}
        self.engine = engine
        self._geom_med = None
        self._bmask = None

    def _init_geometry(self):
        width = self.engine.patch_width
        dev = self.engine.device
        med = curated_geometry_batch(MAPPER_SHAPES, MAPPER_MED_RADIUS, width)
        thick = curated_geometry_batch(MAPPER_SHAPES, MAPPER_THICK_RADIUS,
                                       width)
        self._geom_med = torch.from_numpy(med[..., None]).to(dev)  # [5,W,W,1]
        self._bmask = torch.from_numpy(thick > 0.99).to(dev)   # certain BG

    def get_sfactor(self, brush_opts) -> float:
        style_id = brush_opts.style_id
        if style_id in self.sfactors:
            return self.sfactors[style_id]
        if self._geom_med is None:
            self._init_geometry()
        logger.info(f"Computing clear background mapping of style {style_id}")
        e = self.engine

        def first_row(a):
            if a is None:
                return None
            return torch.as_tensor(a[:1], dtype=torch.float32,
                                   device=e.device)

        sfactor = float(sfactor_core(
            e.gen_cfg, e.enc_cfg, e.enc_res, self.TOP_K,
            e.gen_params, e.gen_state, e.enc_params, e.enc_state,
            self._geom_med, self._bmask,
            first_row(brush_opts.style_z), first_row(brush_opts.style_ws)))
        self.sfactors[style_id] = sfactor
        return sfactor

    def map_style(self, brush_opts, uvs, colors):
        """Host-side remap (the render core usually does this itself)."""
        sfactor = self.get_sfactor(brush_opts)
        uvs = torch.as_tensor(np.asarray(uvs, np.float32))
        return map_uvs_s(uvs, sfactor).numpy(), colors

    # ----- icons / color chips (reference mapper.py:96-115) -----

    def _render_single(self, brush_opts):
        if self._geom_med is None:
            self._init_geometry()
        return self.engine._run_core(self._geom_med[:1], brush_opts)

    def get_colors_raw(self, brush_opts) -> np.ndarray:
        out = self._render_single(brush_opts)
        # The render core's colors are already in [0, 1].
        return out["colors"].cpu().numpy() * 2.0 - 1.0

    def get_colors(self, brush_opts) -> str:
        colors = ((self.get_colors_raw(brush_opts)[0] / 2 + 0.5) * 255)
        colors = colors.astype(np.uint8)
        return ":".join(
            "rgb(%s)" % ",".join(str(int(x)) for x in colors[..., i])
            for i in range(3))

    def get_brush_icon(self, brush_opts, on_white: bool = True) -> np.ndarray:
        logger.info(f"Rendering icon for style {brush_opts.style_id}")
        out = self._render_single(brush_opts)
        render = out["raw_img"][0].cpu().numpy()     # [W, W, 3] in [-1, 1]
        if on_white:
            s = out["uvs"][0, ..., 2:3].cpu().numpy()
            render = render * (1 - s) + s
        return np.clip((render / 2 + 0.5) * 255, 0, 255).astype(np.uint8)
