"""Session canvas state: geometry canvas, feature canvas, stroke orchestration.

Counterpart of ``brushstroke_engine_tpu/engine/canvas.py`` (the reference
FeatureCanvas + PaintingHelper, forger/ui/brush.py:33-407).  The feature
canvas stores intermediate generator activations in canvas space so that
overlapping patches blend without seams; PaintingHelper computes the
distance-based blend alpha for each dirty region, feeds the stored features
into the render core and writes the returned features back.

Host/device split: area bookkeeping, the geometry canvas and the feature
validity mask are numpy (cheap, dynamic); the features stay on the engine's
device, so a stroke moves no feature tensor between host and device.
"""

from __future__ import annotations

import copy
import logging
import math
from typing import Optional

import numpy as np
import torch

from brushstroke_engine_torch.engine import areas
from brushstroke_engine_torch.engine.areas import Area
from brushstroke_engine_torch.engine.brush import GanBrushOptions

logger = logging.getLogger(__name__)


class FeatureCanvas:
    """Persistent ``[1, H/d, W/d, C]`` feature store (a tensor on the device
    of the first features written) + host validity mask (reference
    brush.py:33-92, NHWC here)."""

    def __init__(self, canvas_height: int, canvas_width: int,
                 down_factor: int):
        self.canvas_width = canvas_width
        self.canvas_height = canvas_height
        self.down_factor = down_factor
        self.width = int(math.ceil(canvas_width / down_factor))
        self.height = int(math.ceil(canvas_height / down_factor))
        self.features: Optional[torch.Tensor] = None
        self.mask: Optional[np.ndarray] = None

    def _init_canvases(self, feature_patch: torch.Tensor):
        c = feature_patch.shape[-1]
        self.features = torch.zeros((1, self.height, self.width, c),
                                    dtype=feature_patch.dtype,
                                    device=feature_patch.device)
        self.mask = np.zeros((self.height, self.width), bool)

    def down_area(self, area: Area) -> Area:
        d = self.down_factor
        if (area.rows % d or area.cols % d or area.rstart % d
                or area.cstart % d):
            logger.warning(f"Area {area} not divisible by {d} in feature "
                           f"canvas")
        return areas.make_area(area.rstart // d, area.cstart // d,
                               area.rows // d, area.cols // d)

    def get_features(self, area: Area):
        if self.mask is None:
            return None, None
        return (self.mask[area.rstart:area.rend, area.cstart:area.cend],
                self.features[:, area.rstart:area.rend,
                              area.cstart:area.cend, :])

    def set_features(self, area: Area, feature_patch: torch.Tensor,
                     update_mask=None):
        if self.features is None:
            self._init_canvases(feature_patch)
        sl = (slice(area.rstart, area.rend), slice(area.cstart, area.cend))
        region = self.features[:, sl[0], sl[1], :]
        if update_mask is None:
            self.mask[sl] = True
            region.copy_(feature_patch)
        else:
            m = np.asarray(update_mask)
            self.mask[sl] |= m
            m_dev = torch.from_numpy(m).to(region.device)[None, :, :, None]
            region.copy_(torch.where(m_dev, feature_patch.to(region.dtype),
                                     region))


def generate_dirty_area_alpha(dirty_area: Area, width: int, margin: int,
                              crop_margin: int = 0) -> np.ndarray:
    """Distance-based blend weight: 1 inside the dirty area, linear falloff
    over ``margin`` pixels outside (reference brush.py:159-187)."""
    if dirty_area.min_width == width:
        dirty_area = areas.make_area(
            margin + crop_margin, margin + crop_margin,
            width - 2 * margin - 2 * crop_margin,
            width - 2 * margin - 2 * crop_margin)

    x = np.arange(width, dtype=np.float64)
    grid_y, grid_x = np.meshgrid(x, x, indexing="ij")

    dist_sq_x = np.minimum((grid_x - dirty_area.cstart) ** 2,
                           (grid_x - dirty_area.cend + 1) ** 2)
    dist_sq_y = np.minimum((grid_y - dirty_area.rstart) ** 2,
                           (grid_y - dirty_area.rend + 1) ** 2)

    dist_sq = dist_sq_x + dist_sq_y
    cs, ce = dirty_area.cstart, dirty_area.cend
    rs, re = dirty_area.rstart, dirty_area.rend
    dist_sq[0:rs, cs:ce] = dist_sq_y[0:rs, cs:ce]
    dist_sq[re:, cs:ce] = dist_sq_y[re:, cs:ce]
    dist_sq[rs:re, 0:cs] = dist_sq_x[rs:re, 0:cs]
    dist_sq[rs:re, ce:] = dist_sq_x[rs:re, ce:]
    dist = np.sqrt(dist_sq)

    result = 1.0 - dist / margin
    result[result < 0] = 0
    result[rs:re, cs:ce] = 1
    return result.astype(np.float32)


class PaintingHelper:
    """Per-session canvas/render orchestration (reference brush.py:95-407)."""

    _test_stroke = None

    @staticmethod
    def test_stroke(width: int = 256):
        """A synthetic stroke fixture (the reference loads a bundled PNG)."""
        if PaintingHelper._test_stroke is None or \
                PaintingHelper._test_stroke.shape[0] != width:
            from brushstroke_engine_torch.data.curated_geometry import \
                curated_geometry_patch
            geom = curated_geometry_patch("curve", 16, width)
            rgba = np.zeros((width, width, 4), np.uint8)
            rgba[..., 3] = ((1.0 - geom) * 255).astype(np.uint8)
            PaintingHelper._test_stroke = rgba
        return PaintingHelper._test_stroke

    def __init__(self, paint_engine, style_seed=None, debug_dir=None):
        self.engine = paint_engine
        self.seed_rng = np.random.default_rng(seed=style_seed)
        self.brush_options = GanBrushOptions()
        self.brush_options.set_style(*self.random_brush_style())
        self.debug_dir = debug_dir
        self.render_id = 0

        self.geom_canvas: Optional[np.ndarray] = None
        self.feature_canvas: Optional[FeatureCanvas] = None
        self.feature_blending_level = 0   # 0 off, 1 full res, 2 res/2, ...
        self.feature_blending_margin = 16

    # ----- canvas management -----

    def make_new_canvas(self, rows, cols, feature_blending=None):
        pw = getattr(self.engine, "patch_width", 0) or 0
        if rows < pw or cols < pw:
            # A canvas smaller than one generator patch has no valid render
            # geometry (the blend/update masks are patch-sized).
            raise ValueError(
                f"canvas {rows}x{cols} smaller than patch_width {pw}")
        self.geom_canvas = np.ones((rows, cols), np.float32)
        logger.info(f"Requesting new canvas {rows}x{cols}")
        self.set_feature_blending(self.feature_blending_level
                                  if feature_blending is None
                                  else feature_blending)

    def set_feature_blending(self, feature_blending_level=0):
        down_factor = 2 ** (feature_blending_level - 1)
        self.feature_blending_level = feature_blending_level
        if feature_blending_level > 0:
            self.feature_canvas = FeatureCanvas(
                self.geom_canvas.shape[-2], self.geom_canvas.shape[-1],
                down_factor=down_factor)
        else:
            self.feature_canvas = None

    # ----- brush management -----

    def set_new_brush(self, seed=None):
        style_z, seed = self.random_brush_style(seed)
        self.brush_options.set_style(style_z, seed)
        return seed

    def set_render_mode(self, mode=None):
        self.engine.set_render_mode(mode)

    def generate_style_seed(self):
        return int(self.seed_rng.integers(low=0, high=10000, size=1)[0])

    def random_brush_style(self, seed=None):
        if seed is None:
            seed = self.generate_style_seed()
        return self.engine.random_style(seed), seed

    def default_brush_options(self):
        return copy.copy(self.brush_options)

    # ----- feature blending -----

    def _get_blended_features(self, feature_canvas, dirty_area, gen_area,
                              crop_margin):
        blend_margin = self.feature_blending_margin \
            // feature_canvas.down_factor
        crop_margin = crop_margin // feature_canvas.down_factor
        blending_resolution = int(
            self.engine.patch_width // (2 ** (self.feature_blending_level - 1)))

        update_mask = np.zeros((blending_resolution, blending_resolution),
                               bool)
        dirty_sc = feature_canvas.down_area(dirty_area)
        gen_sc = feature_canvas.down_area(gen_area)

        relative_dirty = areas.make_area_relative(dirty_sc, gen_sc)
        alpha = generate_dirty_area_alpha(relative_dirty, gen_sc.min_width,
                                          margin=blend_margin,
                                          crop_margin=crop_margin)
        update_mask[alpha > 0.99] = True

        mask, features = feature_canvas.get_features(gen_sc)
        if mask is not None:
            update_mask[np.logical_and(mask, alpha > 0)] = True
            alpha = alpha.copy()
            alpha[np.logical_not(mask)] = 1
            alpha = 1 - alpha
            blended = (features, torch.from_numpy(alpha[None, :, :, None])
                       .to(features.device))
        else:
            blended = None

        if crop_margin > 0:
            update_mask[:crop_margin, :] = False
            update_mask[-crop_margin:, :] = False
            update_mask[:, :crop_margin] = False
            update_mask[:, -crop_margin:] = False
        return blending_resolution, blended, update_mask

    def get_blended_features(self, dirty_area, gen_area, crop_margin):
        if self.feature_canvas is not None:
            res, blended, update_mask = self._get_blended_features(
                self.feature_canvas, dirty_area, gen_area, crop_margin)
            if blended is not None:
                return [res], {res: blended}, update_mask
            return [res], {}, update_mask
        return [], {}, None

    def update_blended_features(self, blended_resolutions, raw_net_output,
                                gen_area, update_mask=None):
        if self.feature_canvas is not None:
            gen_sc = self.feature_canvas.down_area(gen_area)
            feats = raw_net_output[f"features{blended_resolutions[0]}"]
            self.feature_canvas.set_features(gen_sc, feats, update_mask)

    # ----- partial-patch support -----

    def _sync_geom_canvas(self, dirty_area, geom, h, w):
        """Keep the persistent geometry canvas in sync with full-patch
        renders so later partial patches see earlier strokes."""
        if self.geom_canvas is None or dirty_area is None:
            return
        rows, cols = self.geom_canvas.shape
        da = areas.clip_area(dirty_area, rows, cols)
        if da.min_width <= 0:
            return
        # Offset into the patch by however much clipping moved the start
        # (x/y may be negative; slicing from the patch corner would write the
        # wrong sub-region).
        ro = da.rstart - dirty_area.rstart
        co = da.cstart - dirty_area.cstart
        self.geom_canvas[da.rstart:da.rend, da.cstart:da.cend] = \
            np.asarray(geom).reshape(h, w)[ro:ro + da.rows, co:co + da.cols]

    def _align_area_down(self, area: Area, d: int, rows: int,
                         cols: int) -> Area:
        """Floor starts / ceil ends to multiples of d, clipped to canvas."""
        r0 = (area.rstart // d) * d
        c0 = (area.cstart // d) * d
        r1 = min(-((-area.rend) // d) * d, rows)
        c1 = min(-((-area.cend) // d) * d, cols)
        return areas.make_area_direct(r0, c0, r1, c1)

    def _expand_partial_patch(self, dirty_area, geom, h, w):
        """Write a smaller-than-patch dirty region into the geometry canvas
        and expand it to a full ``patch_width`` square with surrounding
        context.  Returns (dirty_area, gen_area, [1,pw,pw,1] geometry)."""
        pw = self.engine.patch_width
        if self.geom_canvas is None:
            raise RuntimeError(
                "Must call make_new_canvas before rendering partial patches")
        if dirty_area is None:
            raise RuntimeError(
                "Must provide x,y meta for partial geometry input")
        if w > pw or h > pw:
            raise RuntimeError(
                f"Patch {h}x{w} exceeds engine patch width {pw}")
        rows, cols = self.geom_canvas.shape
        if rows < pw or cols < pw:
            raise RuntimeError(
                f"Canvas {rows}x{cols} smaller than patch width {pw}")

        self._sync_geom_canvas(dirty_area, geom, h, w)

        # Expand the dirty area for blend context, then to a full patch.
        dirty_area = areas.pad_area_bounded(
            dirty_area, margin=self.feature_blending_margin, max_dim=pw)
        dirty_area = areas.clip_area(dirty_area, rows, cols)
        gen_area = areas.expand_area(dirty_area, pw, rows, cols)
        if self.feature_canvas is not None:
            d = self.feature_canvas.down_factor
            dirty_area = self._align_area_down(dirty_area, d, rows, cols)

            # Place a d-aligned pw window that still covers the aligned
            # dirty area: merely flooring the window start can leave the
            # ceil-aligned dirty end sticking out past the rendered patch.
            def _start(d_start, d_end, limit):
                g0 = min(d_start, ((limit - pw) // d) * d)
                g0 = max(g0, d_end - pw, 0)
                return (g0 // d) * d

            gen_area = areas.make_area(
                _start(dirty_area.rstart, dirty_area.rend, rows),
                _start(dirty_area.cstart, dirty_area.cend, cols), pw, pw)
            # At unaligned canvas edges the dirty area must still never
            # extend past the rendered patch.
            dirty_area = areas.make_area_direct(
                max(dirty_area.rstart, gen_area.rstart),
                max(dirty_area.cstart, gen_area.cstart),
                min(dirty_area.rend, gen_area.rend),
                min(dirty_area.cend, gen_area.cend))
        geom_full = self.geom_canvas[gen_area.rstart:gen_area.rend,
                                     gen_area.cstart:gen_area.cend]
        return dirty_area, gen_area, geom_full[None, :, :, None]

    # ----- stroke rendering -----

    def prepare_render(self, stroke_patch, meta=None):
        """Everything before the device call: geometry prep, area
        bookkeeping, blended-feature gather.  Returns a dict consumed by
        :meth:`finish_render`."""
        h, w, _ = stroke_patch.shape
        dirty_area = None
        gen_area = areas.make_area(0, 0, h, w)
        crop_margin = 0
        if meta is not None:
            x = int(meta.get("x"))
            y = int(meta.get("y"))
            if self.feature_canvas is not None:
                d = self.feature_canvas.down_factor
                x = (x // d) * d
                y = (y // d) * d
            dirty_area = areas.make_area(y, x, h, w)
            gen_area = areas.make_area(y, x, h, w)
            if "crop_margin" in meta:
                crop_margin = int(meta.get("crop_margin"))

        geom = self.engine.prepare_geom_input(stroke_patch)
        pw = self.engine.patch_width
        if w != pw or h != pw:
            # Partial patch: write the dirty geometry into the persistent
            # geometry canvas, expand to a full patch of context, render
            # that.
            dirty_area, gen_area, geom = self._expand_partial_patch(
                dirty_area, geom, h, w)
            h = w = pw
        else:
            self._sync_geom_canvas(dirty_area, geom, h, w)
            geom = geom.reshape(1, h, w, 1)

        generator_kwargs = {}
        blended_resolutions = []
        feature_update_mask = None
        if self.feature_blending_level > 0:
            if dirty_area is None:
                raise ValueError("feature blending needs x,y meta")
            blended_resolutions, blended_features, feature_update_mask = \
                self.get_blended_features(dirty_area, gen_area, crop_margin)
            generator_kwargs["blended_features"] = blended_features
            generator_kwargs["return_features"] = tuple(blended_resolutions)

        return {
            "geom": geom,
            "gen_area": gen_area,
            "crop_margin": crop_margin,
            "generator_kwargs": generator_kwargs,
            "blended_resolutions": blended_resolutions,
            "feature_update_mask": feature_update_mask,
        }

    def finish_render(self, prep, rgba_row, raw_out):
        """Write back features, crop, build the response image + meta."""
        gen_area = prep["gen_area"]
        crop_margin = prep["crop_margin"]
        self.update_blended_features(prep["blended_resolutions"], raw_out,
                                     gen_area, prep["feature_update_mask"])
        gen_area = areas.offset_area(gen_area, crop_margin)
        img = rgba_row
        if crop_margin > 0:
            img = img[crop_margin:-crop_margin, crop_margin:-crop_margin]
        out_meta = {"x": gen_area.cstart, "y": gen_area.rstart}
        # Scaled and cast where it was rendered: the copy out is uint8.
        img = torch.clamp(img * 255.0, 0, 255).to(torch.uint8).cpu().numpy()
        self.render_id += 1
        return np.ascontiguousarray(img), out_meta

    def render_stroke(self, stroke_patch, canvas_patch, opts, meta=None):
        if not self.engine.supports_device_render:
            # Mock/simple engines implement render_stroke directly.
            if canvas_patch is None:
                canvas_patch = np.zeros(stroke_patch.shape, np.uint8)
            img, debug = self.engine.render_stroke(stroke_patch,
                                                   canvas_patch, opts)
            out_meta = {"x": 0, "y": 0}
            if meta is not None:
                out_meta = {"x": int(meta.get("x", 0)),
                            "y": int(meta.get("y", 0))}
            return img, debug, out_meta

        prep = self.prepare_render(stroke_patch, meta)
        rgba, raw_out, debug_img = self.engine._render_stroke_device(
            prep["geom"], canvas_patch, opts, **prep["generator_kwargs"])
        img, out_meta = self.finish_render(prep, rgba[0], raw_out)
        return img, debug_img, out_meta
