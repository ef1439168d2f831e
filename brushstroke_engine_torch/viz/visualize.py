"""Visual diagnostics: grids, stroke composites and the training sheets.

Counterpart of ``brushstroke_engine_tpu/viz/visualize.py``: ``make_grid``,
``compose_stroke`` / ``compose_stroke_with_canvas``, the ``visualize_raw_data``
contact sheet, ``TrainingVisualizer`` (fixed-geometry fakes, geometry
control and color control sheets at every image-snapshot tick, and the
stitching sheet of adjacent patches at correct against random canvas
positions) and the encoder reconstruction sheet
``output_encoder_diagnostics``.  Sheets are assembled in numpy from the
engine's renders and written as PNG by ``utils.img_proc.write_png``, which
needs no Pillow.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from brushstroke_engine_torch.data.curated_geometry import (
    MAPPER_SHAPES, curated_geometry_batch,
)
from brushstroke_engine_torch.utils.img_proc import write_image, write_png

logger = logging.getLogger(__name__)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2,
              pad_value: float = 1.0) -> np.ndarray:
    """``[N, H, W, C]`` -> one ``[gh, gw, C]`` grid image."""
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    out = np.full((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c),
                  pad_value, images.dtype)
    for i in range(n):
        r, cc = divmod(i, ncol)
        y = pad + r * (h + pad)
        x = pad + cc * (w + pad)
        out[y:y + h, x:x + w] = images[i]
    return out


def compose_stroke(uvs, colors) -> np.ndarray:
    """uvs ``[B, H, W, 3]`` x colors ``[B, 3, 3]`` -> ``[B, H, W, 3]``."""
    return np.einsum("bhwk,bck->bhwc", _np(uvs), _np(colors))


def compose_stroke_with_canvas(uvs, colors, mode: str = "white",
                               canvas=None) -> np.ndarray:
    """Composite the stroke over a canvas; mode 'white', 'canvas' (the
    given canvas) or 'blur' (the canvas blurred)."""
    stroke = compose_stroke(uvs, colors)
    alpha = _np(uvs)[..., :2].sum(-1, keepdims=True)
    if mode == "white" or canvas is None:
        bg = np.ones_like(stroke)
    elif mode == "blur":
        from brushstroke_engine_torch.metrics.geom import gaussian_smoothing
        bg = _np(gaussian_smoothing(torch.as_tensor(_np(canvas))))
    else:
        bg = _np(canvas)
    return alpha * stroke + (1 - alpha) * bg


def visualize_raw_data(render_out: Dict, geom=None) -> np.ndarray:
    """Contact sheet: geometry | U | V | S | composite (+ canvas / alpha for
    canvas-format engines), one uint8 image, a row per item."""
    uvs = _np(render_out["uvs"])
    b, h, w, _ = uvs.shape
    panels = []
    if geom is not None:
        panels.append(np.tile(_np(geom), (1, 1, 1, 3)))
    for i in range(3):
        panels.append(np.tile(uvs[..., i:i + 1], (1, 1, 1, 3)))
    panels.append(_np(render_out["rgba"])[..., :3])
    for key in ("canvas", "alpha_fg"):
        if key in render_out:
            p = _np(render_out[key])
            if p.shape[-1] == 1:
                p = np.tile(p, (1, 1, 1, 3))
            elif key == "canvas":
                p = (p + 1) / 2
            panels.append(p)
    rows = [np.concatenate([p[i] for p in panels], axis=1)
            for i in range(b)]
    return to_uint8(np.concatenate(rows, axis=0))


def output_encoder_diagnostics(path: Optional[str], enc_cfg, enc_params,
                               enc_state, geom_batch) -> np.ndarray:
    """Encoder reconstruction sheet (reference :295-312): one row per
    geometry ``[B, H, W, 1]`` in [0, 1], input | reconstruction; written as
    PNG to ``path`` unless it is None.  The encoder runs where its weights
    are."""
    from brushstroke_engine_torch.models.geo_encoder import (
        geo_encoder_apply, postprocess,
    )
    dev = next(iter(enc_params["encoder"].values()))["conv"]["weight"].device
    geom = torch.as_tensor(np.asarray(geom_batch, np.float32), device=dev)
    with torch.no_grad():
        recon, _ = geo_encoder_apply(enc_cfg, enc_params, enc_state, geom)
        recon = _np(postprocess(enc_cfg, recon))
    if recon.shape[-1] != 1:
        recon = recon[..., :1]
    sheet = np.concatenate([np.asarray(geom_batch, np.float32), recon],
                           axis=2)
    out = np.concatenate(list(to_uint8(np.tile(sheet, (1, 1, 1, 3)))),
                         axis=0)
    if path is not None:
        write_png(path, out)
    return out


def save_image(path: str, img: np.ndarray):
    """Write a uint8 image, making its directory: ``write_image`` (a PNG
    needs no Pillow)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_image(path, img)


class TrainingVisualizer:
    """Writes the diagnostic sheets at image-snapshot ticks."""

    def __init__(self, batch_size: int = 8, width: int = 128,
                 num_fixed_styles: int = 8, seed: int = 0):
        self.batch_size = batch_size
        self.width = width
        self.rng = np.random.RandomState(seed)
        self.fixed_z: Optional[np.ndarray] = None
        self.fixed_geom: Optional[np.ndarray] = None
        self.num_fixed_styles = num_fixed_styles

    def init(self, z_dim: int, geom_batch: Optional[np.ndarray] = None):
        self.fixed_z = self.rng.randn(self.num_fixed_styles,
                                      z_dim).astype(np.float32)
        if geom_batch is None:
            geom_batch = curated_geometry_batch(
                MAPPER_SHAPES, radius=16, width=self.width)[..., None]
        self.fixed_geom = np.asarray(geom_batch, np.float32)

    def _render(self, engine, z, geom, positions=None, colors=None):
        from brushstroke_engine_torch.engine.brush import GanBrushOptions
        opts = GanBrushOptions()
        opts.set_style(z)
        if colors is not None:
            for i, c in enumerate(colors):
                if c is not None:
                    opts.set_color(i, c)
        if positions is not None:
            opts.set_position(positions[:, 1], positions[:, 0])
        return engine._run_core(np.asarray(geom, np.float32), opts)

    def do_visualize(self, out_dir: str, engine, tag: str):
        """Write the diagnostic sheets for the current snapshot."""
        os.makedirs(out_dir, exist_ok=True)
        assert self.fixed_z is not None, "call init() first"
        n = min(self.num_fixed_styles, len(self.fixed_geom))
        geom = self.fixed_geom[:n]
        z = self.fixed_z[:n]

        # 1) Fixed-geometry fakes.
        out = self._render(engine, z, geom)
        write_png(os.path.join(out_dir, f"fakes_{tag}.png"),
                   visualize_raw_data(out, geom))

        # 2) Geometry control: one style over every curated geometry.
        z_one = np.tile(z[:1], (n, 1))
        out = self._render(engine, z_one, geom)
        write_png(os.path.join(out_dir, f"geom_control_{tag}.png"),
                   visualize_raw_data(out, geom))

        # 3) Color control: one style and geometry, the primary color swept.
        colors = np.asarray([[255, 0, 0], [0, 255, 0], [0, 0, 255],
                             [255, 255, 0], [255, 0, 255]], np.uint8)
        rows = []
        for c in colors[:n]:
            out = self._render(engine, z[:1], geom[:1],
                               colors=[c, None, None])
            rows.append(_np(out["rgba"])[0, ..., :3])
        write_png(os.path.join(out_dir, f"color_control_{tag}.png"),
                   to_uint8(np.concatenate(rows, axis=1)))
        return True

    def visualize_stitching(self, out_dir: str, engine, tag: str,
                            canvas_geom: Optional[np.ndarray] = None):
        """Stitching sheet: two adjacent patches of one canvas geometry
        rendered at their correct canvas positions (top row) and at random
        ones (bottom row), written as ``stitching_<tag>.png`` (reference
        :512-544)."""
        w = engine.patch_width
        if canvas_geom is None:
            from brushstroke_engine_torch.data.curves import \
                random_spline_stroke
            canvas_geom = random_spline_stroke(
                np.random.default_rng(0), 2 * w)
        z = self.fixed_z[:1]
        halves = []
        for mode in ("correct", "random"):
            row = []
            for x in (0, w // 2):
                patch = canvas_geom[:w, x:x + w][None, ..., None]
                if mode == "correct":
                    pos = np.asarray([[0, x]], np.int64)
                else:
                    pos = self.rng.randint(0, w, size=(1, 2))
                out = self._render(engine, z, patch, positions=pos)
                row.append(_np(out["rgba"])[0, ..., :3])
            halves.append(np.concatenate(row, axis=1))
        sheet = to_uint8(np.concatenate(halves, axis=0))
        os.makedirs(out_dir, exist_ok=True)
        write_png(os.path.join(out_dir, f"stitching_{tag}.png"), sheet)
        return sheet
