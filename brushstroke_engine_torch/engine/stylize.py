"""Stylization of line drawings: tile an image of any size into overlapping
patches, render each with the paint engine (feature blending across seams)
and assemble an RGBA canvas.

Counterpart of ``brushstroke_engine_tpu/engine/stylize.py`` (the reference
generate_stitching_crops, forger/viz/style_transfer.py:15-48, and the
paint_image_main CLI, forger/viz/paint_image_main.py:104-193).  Three
renderers:

* :func:`stylize_image`: tile by tile through a ``PaintingHelper``, in scan
  order (each tile reads the features its neighbours wrote).
* :func:`stylize_image_batched`: checkerboard waves.  With stride >= patch/2
  the tiles of one (row % 2, col % 2) class never overlap each other, so a
  wave renders as batches; blending flows between waves through a feature
  canvas on the device.  The RGBA canvas is assembled on the host.
* :func:`stylize_image_ondevice`: the same waves with the geometry, the
  feature canvas and the uint8 RGBA canvas all on the device; one copy to
  the host at the end.  With ``mesh`` (a local mesh,
  ``parallel/mesh.py``) each chunk's tiles split over the mesh's cards.
"""

from __future__ import annotations

import logging
import math
from typing import List, Tuple

import numpy as np
import torch

from brushstroke_engine_torch.engine.device_canvas import clamp_start

logger = logging.getLogger(__name__)


def generate_stitching_crops(img_shape: Tuple[int, int], patch_width: int,
                             overlap_margin: int, geom: np.ndarray = None,
                             mode: str = "all") -> List[Tuple[int, int, int, int]]:
    """Grid of overlapping (y, x, h, w) crops covering the image.

    Stride = patch_width - 2 * overlap_margin; the last row/col is clamped so
    crops stay inside the (pre-padded) image.  mode='nonempty' skips crops
    whose geometry patch contains no stroke pixels.
    """
    rows, cols = img_shape[:2]
    stride = patch_width - 2 * overlap_margin
    crops = []
    ys = list(range(0, max(rows - 2 * overlap_margin - 1, 1), stride))
    xs = list(range(0, max(cols - 2 * overlap_margin - 1, 1), stride))
    for y in ys:
        y = min(y, rows - patch_width)
        for x in xs:
            x = min(x, cols - patch_width)
            if mode == "nonempty" and geom is not None:
                patch = geom[y:y + patch_width, x:x + patch_width]
                if float(patch.min()) > 0.5:
                    continue
            crops.append((y, x, patch_width, patch_width))
    return crops


def pad_geometry(geom: np.ndarray, patch_width: int,
                 overlap_margin: int) -> Tuple[np.ndarray, int]:
    """Pad a geometry image (1.0 = BG) so the crop grid covers it exactly."""
    rows, cols = geom.shape[:2]
    stride = patch_width - 2 * overlap_margin
    new_rows = max(patch_width,
                   int(math.ceil((rows - 2 * overlap_margin) / stride))
                   * stride + 2 * overlap_margin)
    new_cols = max(patch_width,
                   int(math.ceil((cols - 2 * overlap_margin) / stride))
                   * stride + 2 * overlap_margin)
    out = np.ones((new_rows, new_cols), geom.dtype)
    out[:rows, :cols] = geom
    return out, stride


def read_geometry_image(img: np.ndarray, binarize: bool = True
                        ) -> np.ndarray:
    """Any-format image -> float geometry (1 = BG, 0 = stroke)
    (reference _read_any_geo, paint_image_main.py:30-57)."""
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[-1] == 4:
        gray = 1.0 - arr[..., 3].astype(np.float32) / 255.0
    elif arr.ndim == 3:
        gray = arr[..., :3].astype(np.float32).mean(-1) / 255.0
    else:
        gray = arr.astype(np.float32)
        if gray.max() > 1.5:
            gray = gray / 255.0
    if binarize:
        from brushstroke_engine_torch.utils.img_proc import threshold_otsu
        t = threshold_otsu(gray)
        gray = (gray > t).astype(np.float32)
    return gray


def stylize_image(helper, geom: np.ndarray, brush_options, *,
                  overlap_margin: int = 10, crop_margin: int = 10,
                  feature_blending_level: int = 2,
                  on_white: bool = False,
                  mode: str = "all") -> np.ndarray:
    """Render a full line drawing with a brush style, tile by tile.

    Args:
      helper: a PaintingHelper bound to a paint engine.
      geom: [H, W] float geometry, 1 = background.
      brush_options: GanBrushOptions with the style set.

    Returns:
      [H', W', 4] uint8 RGBA stylized canvas (padded size).
    """
    patch_width = helper.engine.patch_width
    geom, _ = pad_geometry(geom, patch_width, overlap_margin)
    rows, cols = geom.shape

    helper.make_new_canvas(rows, cols,
                           feature_blending=feature_blending_level)
    crops = generate_stitching_crops((rows, cols), patch_width,
                                     overlap_margin, geom=geom, mode=mode)
    canvas = np.zeros((rows, cols, 4), np.uint8)

    for (y, x, h, w) in crops:
        patch = geom[y:y + h, x:x + w]
        stroke_patch = np.zeros((h, w, 4), np.uint8)
        stroke_patch[..., 3] = ((1.0 - patch) * 255).astype(np.uint8)
        brush_options.set_position(x, y)
        img, _, meta = helper.render_stroke(
            stroke_patch, None, brush_options,
            meta={"x": x, "y": y, "crop_margin": crop_margin})
        oy, ox = meta["y"], meta["x"]
        hh, ww = img.shape[:2]
        canvas[oy:oy + hh, ox:ox + ww] = img

    if on_white:
        canvas = composite_on_white(canvas)
    return canvas


def composite_on_white(canvas: np.ndarray) -> np.ndarray:
    alpha = canvas[..., 3:4].astype(np.float32) / 255.0
    rgb = canvas[..., :3].astype(np.float32) * alpha + 255.0 * (1 - alpha)
    return np.concatenate(
        [np.clip(rgb, 0, 255).astype(np.uint8),
         np.full_like(canvas[..., 3:4], 255)], axis=-1)


def _window_index(ys, xs, size, shape, device):
    """Advanced-index pair selecting ``len(ys)`` windows of ``size`` x
    ``size`` at (ys, xs) of a 2-D ``shape``, each start clamped into the
    array as ``dynamic_slice`` clamps it: index ``a[iy, ix]`` -> ``[B, size,
    size, ...]``."""
    rng = torch.arange(size, device=device)
    iy = torch.tensor([clamp_start(int(y), shape[0], size) for y in ys],
                      device=device)[:, None] + rng
    ix = torch.tensor([clamp_start(int(x), shape[1], size) for x in xs],
                      device=device)[:, None] + rng
    return iy[:, :, None], ix[:, None, :]


def _gather_feature_windows(ffeat, fmask, fys, fxs, border):
    """Batched read of feature-canvas windows.

    The window size comes from ``border.shape``; returns (feats
    ``[B,R,R,C]``, alpha ``[B,R,R,1]``, upd ``[B,R,R]``).  alpha keeps stored
    features where they exist (the mask itself, a whole-tile simplification
    of the interactive dirty-area ramp); upd marks texels this tile may
    write (crop border excluded).
    """
    idx = _window_index(fys, fxs, border.shape[0], fmask.shape, fmask.device)
    feats = ffeat[0][idx]
    masks = fmask[idx]
    alpha = masks[..., None]
    upd = (1.0 - masks) * border[None]
    return feats, alpha, upd


def _scatter_feature_windows(ffeat, fmask, new_feats, upds, fys, fxs):
    """Write-back of a wave's feature windows, in place.

    Tiles within a wave never overlap, and a chunk's padding repeats its
    last tile, whose second write stores the values of the first; so one
    vectorised scatter gives the JAX package's sequential loop's result."""
    r = new_feats.shape[1]
    idx = _window_index(fys, fxs, r, fmask.shape, fmask.device)
    win = ffeat[0][idx]
    u = upds[..., None]
    ffeat[0][idx] = win * (1 - u) + new_feats * u
    fmask[idx] = torch.maximum(fmask[idx], upds)


def _prepare_wave_chunks(crops, stride: int, batch_size: int):
    """Group crops into checkerboard waves, chunk each wave to a fixed
    batch (padding tail chunks with the last tile), and stack the tile
    origins into [n_chunks, batch] arrays ordered wave by wave."""
    waves = {}
    for (y, x, h, w) in crops:
        key = ((y // stride) % 2, (x // stride) % 2)
        waves.setdefault(key, []).append((y, x))
    ys, xs = [], []
    for key in sorted(waves):
        tiles = waves[key]
        for start in range(0, len(tiles), batch_size):
            chunk = tiles[start:start + batch_size]
            pad = chunk + [chunk[-1]] * (batch_size - len(chunk))
            ys.append([y for (y, _x) in pad])
            xs.append([x for (_y, x) in pad])
    return np.asarray(ys, np.int32), np.asarray(xs, np.int32)


def _feature_canvas(engine, rows, cols, patch_width, feature_blending_level,
                    crop_margin):
    """(blend_res, ffeat, fmask, border) of a wave renderer on the engine's
    device, or all None without blending."""
    if feature_blending_level <= 0:
        return None, None, None, None
    down = 2 ** (feature_blending_level - 1)
    blend_res = patch_width // down
    feat_ch = engine.gen_cfg.synthesis.channels(blend_res)
    fh = -(-rows // down)
    fw = -(-cols // down)
    dev = engine.device
    ffeat = torch.zeros((1, fh, fw, feat_ch), dtype=torch.float32,
                        device=dev)
    fmask = torch.zeros((fh, fw), dtype=torch.float32, device=dev)
    cm = crop_margin // down
    border = np.zeros((blend_res, blend_res), np.float32)
    if cm > 0:
        border[cm:-cm, cm:-cm] = 1.0
    else:
        border[:] = 1.0
    return blend_res, ffeat, fmask, torch.from_numpy(border).to(dev)


def _stylize_waves(engine, geom, brush_options, overlap_margin,
                   crop_margin, feature_blending_level, batch_size, on_white,
                   mode, on_device, mesh=None):
    """The checkerboard-wave renderer behind both wave stylizers: the chunks
    of :func:`_prepare_wave_chunks` in order, each a gather of its feature
    windows, one ``_run_core`` of ``batch_size`` tiles, a scatter of the
    windows, and the cropped tiles written into the canvas.  With
    ``on_device`` the geometry and the RGBA canvas live on the engine's
    device too; otherwise the canvas is assembled on the host from each
    chunk's uint8 copy.  A chunk's padding repeats its last tile, whose
    second write stores what the first did.  Each chunk's ``_run_core``
    runs under the engine's static int8 scales (``_quant_key``) when
    ``enable_int8_serving`` set them, from site 0 per chunk."""
    patch_width = engine.patch_width
    stride = patch_width - 2 * overlap_margin
    if stride * 2 < patch_width:
        raise ValueError("checkerboard waves need overlap_margin <= "
                         "patch_width/4")
    geom, _ = pad_geometry(geom, patch_width, overlap_margin)
    rows, cols = geom.shape
    crops = generate_stitching_crops((rows, cols), patch_width,
                                     overlap_margin, geom=geom, mode=mode)
    dev = engine.device
    blend_res, ffeat, fmask, border = _feature_canvas(
        engine, rows, cols, patch_width, feature_blending_level, crop_margin)
    rf = () if blend_res is None else (blend_res,)
    if on_device:
        # Binary geometry (the binarized path) ships as uint8: 4x less
        # traffic, recovered exactly on the device.
        geom32 = np.asarray(geom, np.float32)
        g255 = geom32 * 255.0
        if np.array_equal(g255, np.round(g255)):
            geom = torch.from_numpy(g255.astype(np.uint8)).to(dev).float() \
                / 255.0
        else:
            geom = torch.from_numpy(geom32).to(dev)
        canvas = torch.zeros((rows, cols, 4), dtype=torch.uint8, device=dev)
    else:
        canvas = np.zeros((rows, cols, 4), np.uint8)
    cm = crop_margin
    inner = patch_width - 2 * cm
    chunks = zip(*(a.tolist() for a in _prepare_wave_chunks(
        crops, stride, batch_size))) if crops else ()

    for cys, cxs in chunks:
        if on_device:
            geoms = geom[_window_index(cys, cxs, patch_width, geom.shape,
                                       dev)][..., None]
        else:
            geoms = np.stack([geom[y:y + patch_width, x:x + patch_width]
                              for y, x in zip(cys, cxs)])[..., None]
        brush_options.set_position(np.asarray(cxs), np.asarray(cys))
        blended = None
        if blend_res is not None:
            down = patch_width // blend_res
            fys = [y // down for y in cys]
            fxs = [x // down for x in cxs]
            feats_win, alpha, upds = _gather_feature_windows(
                ffeat, fmask, fys, fxs, border)
            blended = {blend_res: (feats_win, alpha)}
        out = engine._run_core(geoms, brush_options,
                               blended_features=blended, return_features=rf,
                               mesh=mesh)
        if blend_res is not None:
            _scatter_feature_windows(
                ffeat, fmask, out[f"features{blend_res}"].float(), upds,
                fys, fxs)
        # uint8 cast on the device: 4x less to copy than f32.
        rgba = (torch.clamp(out["rgba"], 0.0, 1.0) * 255).to(torch.uint8)
        rgba = rgba[:, cm:patch_width - cm, cm:patch_width - cm]
        if on_device:
            canvas[_window_index([y + cm for y in cys],
                                 [x + cm for x in cxs], inner, canvas.shape,
                                 dev)] = rgba
        else:
            rgba = rgba.cpu().numpy()
            for i, (y, x) in enumerate(zip(cys, cxs)):
                canvas[y + cm:y + cm + inner, x + cm:x + cm + inner] = rgba[i]

    if on_device:
        canvas = canvas.cpu().numpy()
    return composite_on_white(canvas) if on_white else canvas


def stylize_image_ondevice(engine, geom: np.ndarray, brush_options, *,
                           overlap_margin: int = 10, crop_margin: int = 10,
                           feature_blending_level: int = 2,
                           batch_size: int = 32,
                           on_white: bool = False,
                           mode: str = "all",
                           mesh=None) -> np.ndarray:
    """Whole-canvas stylization with the canvas on the device.

    Same wave decomposition as :func:`stylize_image_batched`.  The geometry
    goes to the device once; the feature canvas and the uint8 RGBA canvas
    live there; the chunk loop runs in Python over those tensors; the only
    copy back is the finished canvas.

    ``mesh``: a local mesh (``parallel.mesh.make_mesh``) over which each
    chunk's ``batch_size`` tiles split, every card's share issued before
    any is gathered; ``batch_size`` must divide by the mesh size.  The
    weights are copied to each card once and cached on the engine; the
    geometry, the feature canvas and the RGBA canvas stay on the engine's
    device.
    """
    if mesh is not None:
        if mesh.group is not None:
            raise ValueError("stylizing splits tiles over a local mesh")
        if batch_size % mesh.size:
            raise ValueError(f"batch_size {batch_size} must divide by the "
                             f"mesh size {mesh.size}")
    return _stylize_waves(engine, geom, brush_options, overlap_margin,
                          crop_margin, feature_blending_level, batch_size,
                          on_white, mode, on_device=True, mesh=mesh)


def stylize_image_batched(engine, geom: np.ndarray, brush_options, *,
                          overlap_margin: int = 10, crop_margin: int = 10,
                          feature_blending_level: int = 2,
                          batch_size: int = 16,
                          on_white: bool = False,
                          mode: str = "all") -> np.ndarray:
    """Canvas stylization in checkerboard waves.

    The reference renders tiles strictly in sequence because each tile reads
    features written by earlier overlapping ones.  With stride >= patch/2,
    tiles of one (row % 2, col % 2) class never overlap each other, so each
    of the 4 waves renders in batches of ``batch_size``; blending between
    waves flows through the feature canvas, which stays on the device.  The
    host receives each chunk's uint8 RGBA and assembles the canvas.
    """
    return _stylize_waves(engine, geom, brush_options, overlap_margin,
                          crop_margin, feature_blending_level, batch_size,
                          on_white, mode, on_device=False)
