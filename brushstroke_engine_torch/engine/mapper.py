"""Per-style background-clarity ("UVS") mapping.

Counterpart of ``StyleUVSMapper.get_sfactor`` in
``brushstroke_engine_tpu/engine/mapper.py``: for a style, render 5 curated
medium-thickness geometry patches, take the 15th-largest background S over
known-background pixels (from the thick variants), and derive
``sfactor = 1 / val``.  At render time ``S' = clamp(sfactor * S)`` with U, V
rescaled (see render.map_uvs_s).
"""

from __future__ import annotations

import logging

import torch

from brushstroke_engine_torch.data.curated_geometry import (
    curated_geometry_batch, MAPPER_SHAPES, MAPPER_MED_RADIUS,
    MAPPER_THICK_RADIUS,
)
from brushstroke_engine_torch.engine.render import sfactor_core

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
