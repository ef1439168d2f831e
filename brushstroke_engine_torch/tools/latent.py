"""W-space statistics and exploration utilities.

Counterpart of ``brushstroke_engine_tpu/tools/latent.py``:

  * :func:`get_w_stats`: w mean / std over mapping samples, which every W
    optimization starts from (z drawn on the host with numpy's
    ``RandomState``, the mapping on the parameters' device, 512 at a time);
  * :func:`ws_for_seeds` and :func:`dump_ws`: W vectors for style seeds
    (``tools/get_ws_main.py``);
  * :func:`pca_directions` and :func:`seed_grid`: principal directions of a
    W sample and a W-space neighbourhood grid (``tools/visualize_pca_main.py``,
    ``tools/seed_expand.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from brushstroke_engine_torch.models.mapping import mapping_apply
from brushstroke_engine_torch.utils.util import tree_leaves


def get_w_stats(gen_cfg, mapping_params, num_samples: int = 10000,
                seed: int = 0, batch: int = 512
                ) -> Tuple[np.ndarray, float]:
    """Mean W ``[1, 1, w_dim]`` and scalar std over mapping samples, on the
    device that holds ``mapping_params``."""
    device = tree_leaves(mapping_params)[0].device
    rng = np.random.RandomState(seed)
    ws_all = []
    with torch.no_grad():
        for i in range(0, num_samples, batch):
            n = min(batch, num_samples - i)
            z = torch.as_tensor(rng.randn(n, gen_cfg.z_dim).astype(np.float32),
                                device=device)
            ws = mapping_apply(gen_cfg.mapping, mapping_params, z, None)
            ws_all.append(ws[:, 0, :].cpu().numpy())      # [n, w_dim]
    w = np.concatenate(ws_all, axis=0)
    w_avg = w.mean(axis=0, keepdims=True)[None]          # [1, 1, w_dim]
    w_std = float(np.sqrt(np.square(w - w_avg[0]).sum(1).mean()))
    return w_avg.astype(np.float32), w_std


def ws_for_seeds(engine, seeds: List[int]) -> np.ndarray:
    """Broadcast W vectors ``[len(seeds), num_ws, w_dim]`` for style seeds."""
    zs = np.concatenate([engine.random_style(s) for s in seeds], axis=0)
    with torch.no_grad():
        ws = mapping_apply(
            engine.gen_cfg.mapping, engine.gen_params["mapping"],
            torch.as_tensor(zs, dtype=torch.float32, device=engine.device),
            None, w_avg=engine.gen_state.get("w_avg"))
    return ws.cpu().numpy()


def dump_ws(engine, seeds: List[int], out_file: str):
    """Binary float64 W dump compatible with the reference PCA tooling."""
    ws = ws_for_seeds(engine, seeds)[:, 0, :].astype(np.float64)
    ws.tofile(out_file)
    return ws


def pca_directions(ws: np.ndarray, num_components: int = 8
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Principal directions of a W sample set -> (components, variances)."""
    w = ws.reshape(ws.shape[0], -1)
    centered = w - w.mean(0, keepdims=True)
    _, s, vt = np.linalg.svd(centered, full_matrices=False)
    var = (s ** 2) / max(w.shape[0] - 1, 1)
    return vt[:num_components], var[:num_components]


def seed_grid(engine, center_seed: int, radius_scale: float = 0.2,
              grid: int = 5, seed: int = 0) -> np.ndarray:
    """W-space neighbourhood grid ``[grid * grid, num_ws, w_dim]`` around a
    style: the centre W moved along 2 random orthogonal directions."""
    ws = ws_for_seeds(engine, [center_seed])          # [1, num_ws, w_dim]
    rng = np.random.RandomState(seed)
    d1 = rng.randn(*ws.shape[1:])
    d2 = rng.randn(*ws.shape[1:])
    d1 /= np.linalg.norm(d1)
    d2 -= d1 * (d1 * d2).sum() / max((d1 * d1).sum(), 1e-8)
    d2 /= np.linalg.norm(d2)
    lin = np.linspace(-radius_scale, radius_scale, grid)
    out = np.stack([
        ws[0] + a * d1 * np.linalg.norm(ws) + b * d2 * np.linalg.norm(ws)
        for a in lin for b in lin])
    return out.astype(np.float32)
