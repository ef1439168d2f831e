"""Perceptual path length of the geometry-conditioned generator.

Counterpart of ``brushstroke_engine_tpu/metrics/ppl.py`` (reference
metric-zoo PPL, thirdparty/.../metrics/perceptual_path_length.py): LPIPS
between renders at two latents ``epsilon`` apart along an interpolation
(lerp in w, slerp in z), divided by ``epsilon^2``, with the geometry
features held fixed.  The draws are the JAX package's: a numpy
``RandomState(seed)`` gives ``z0``, ``z1`` and ``t`` per batch, in that
order.  ``t + epsilon`` is clipped to 1 in w space and not in z space.

Dividing by ``epsilon^2`` (1e8 at the default) magnifies every rounding of
the two renders, so the generator passes and LPIPS run in strict f32 (TF32
off, no bf16 blocks) wherever they run.
"""

from __future__ import annotations

import numpy as np
import torch

from brushstroke_engine_torch.metrics.lpips import lpips_batched
from brushstroke_engine_torch.models.generator import generator_apply
from brushstroke_engine_torch.models.mapping import mapping_apply
from brushstroke_engine_torch.ops.precision import precision_mode


def slerp(a, b, t):
    a_n = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    b_n = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    d = torch.clamp((a_n * b_n).sum(-1, keepdim=True), -1, 1)
    omega = torch.arccos(d)
    so = torch.sin(omega)
    return (torch.sin((1 - t) * omega) / so) * a + \
        (torch.sin(t * omega) / so) * b


def ppl_distances(engine, geom_features, num_samples: int = 64,
                  epsilon: float = 1e-4, space: str = "w", batch: int = 8,
                  seed: int = 0) -> np.ndarray:
    """The ``num_samples`` per-sample scaled LPIPS distances, on the
    engine's device; ``geom_features``: the encoder's features of one
    geometry (its first item is broadcast over each batch)."""
    gen_cfg, dev = engine.gen_cfg, engine.device
    g_state = {"w_avg": engine.gen_state.get("w_avg"),
               "noise": engine.gen_state["noise"]}
    mapping = engine.gen_params["mapping"]
    rng = np.random.RandomState(seed)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    dists = []
    with torch.no_grad(), precision_mode("strict"):
        for start in range(0, num_samples, batch):
            n = min(batch, num_samples - start)
            z0 = tensor(rng.randn(n, gen_cfg.z_dim))
            z1 = tensor(rng.randn(n, gen_cfg.z_dim))
            t = tensor(rng.rand(n, 1))
            if space == "w":
                w0 = mapping_apply(gen_cfg.mapping, mapping, z0)
                w1 = mapping_apply(gen_cfg.mapping, mapping, z1)
                wt0 = w0 + (w1 - w0) * t[:, :, None]
                wt1 = w0 + (w1 - w0) * torch.clamp(
                    t + epsilon, 0, 1)[:, :, None]
            else:
                wt0 = mapping_apply(gen_cfg.mapping, mapping,
                                    slerp(z0, z1, t))
                wt1 = mapping_apply(gen_cfg.mapping, mapping,
                                    slerp(z0, z1, t + epsilon))
            feats = [f[:1].to(dev).expand((n,) + tuple(f.shape[1:]))
                     for f in geom_features]

            def render(ws):
                img, _ = generator_apply(
                    gen_cfg, engine.gen_params, g_state, ws=ws,
                    geom_features=feats, noise_mode="const",
                    force_fp32=True)
                return img

            d = lpips_batched(render(wt0), render(wt1)) / (epsilon ** 2)
            dists.append(d.cpu().numpy())
    return np.concatenate(dists)


def compute_ppl(engine, geom_features, num_samples: int = 64,
                epsilon: float = 1e-4, space: str = "w", batch: int = 8,
                seed: int = 0) -> float:
    """PPL: the mean of :func:`ppl_distances` inside their 1 % and 99 %
    quantiles (the reference's outlier filter)."""
    d = ppl_distances(engine, geom_features, num_samples, epsilon, space,
                      batch, seed)
    lo, hi = np.percentile(d, [1, 99])
    return float(d[(d >= lo) & (d <= hi)].mean())
