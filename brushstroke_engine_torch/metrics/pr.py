"""Improved precision and recall for generative models (Kynkaanniemi 2019).

Counterpart of ``brushstroke_engine_tpu/metrics/pr.py`` (reference
thirdparty/stylegan2_ada_pytorch/metrics/precision_recall.py:19-62): for
precision (manifold = real, probes = generated) and recall (the other way
round), the manifold is the union of hyperspheres around its features with
the radius of each one's k-th nearest neighbour (k = ``nhood_size``); the
score is the share of probes inside any of them.

Squared distances throughout (``|a|^2 + |b|^2 - 2ab``, clipped at 0, in
row chunks of one product each), which orders like the euclidean distances
the reference compares; the k-th neighbour is the (k+1)-th smallest,
the self-distance 0 included, as the reference's ``kthvalue(k + 1)``.

Feature detector: a torchvision ``vgg16`` state dict through
:meth:`VGG16Features.from_torch_state`, or the deterministic slim random
stack the JAX package labels ``vgg16_random``; by default
:func:`compute_pr_from_images` uses the FID detector (:mod:`.fid`).  The
VGG stack runs NHWC-flattened, as the JAX package's: ``from_torch_state``
permutes the first FC's input from torch's (C, H, W) order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from brushstroke_engine_torch.metrics import fid as _fid
from brushstroke_engine_torch.metrics.lpips import resize_bilinear
from brushstroke_engine_torch.utils.util import resolve_device

# Torchvision VGG16 conv plan ('M' = 2x2 max pool); the features feed two
# 4096-wide ReLU FC layers (classifier.0 / classifier.3).
_VGG_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
_SLIM_DIV = 8           # width divisor of the random fallback
_SLIM_FC = 512


@dataclass
class VGG16Features:
    """Conv weights HWIO and FC weights ``[in, out]`` (numpy, the JAX
    package's layout)."""
    convs: List[Dict[str, np.ndarray]]
    fcs: List[Dict[str, np.ndarray]]
    width_div: int = 1

    @property
    def kind(self) -> str:
        """'vgg16' for a loaded full-width VGG16, 'vgg16_random' for the
        slim random fallback."""
        return "vgg16" if self.width_div == 1 else "vgg16_random"

    @staticmethod
    def random_init(seed: int = 0) -> "VGG16Features":
        rng = np.random.RandomState(seed)
        convs, cin = [], 3
        for spec in _VGG_PLAN:
            if spec == "M":
                continue
            cout = int(spec) // _SLIM_DIV
            std = float(np.sqrt(2.0 / (9 * cin)))
            convs.append({
                "weight": (std * rng.randn(3, 3, cin, cout)).astype(
                    np.float32),
                "bias": np.zeros((cout,), np.float32)})
            cin = cout
        fcs = []
        fin = cin * 7 * 7
        for fout in (_SLIM_FC, _SLIM_FC):
            std = float(np.sqrt(2.0 / fin))
            fcs.append({
                "weight": (std * rng.randn(fin, fout)).astype(np.float32),
                "bias": np.zeros((fout,), np.float32)})
            fin = fout
        return VGG16Features(convs=convs, fcs=fcs, width_div=_SLIM_DIV)

    @staticmethod
    def from_torch_state(state: Dict) -> "VGG16Features":
        """torchvision ``vgg16().state_dict()`` (features.N / classifier.N;
        tensors or arrays)."""
        def arr(k):
            v = state[k]
            return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)

        convs = []
        idxs = sorted({int(k.split(".")[1]) for k in state
                       if k.startswith("features.")})
        for i in idxs:
            w = arr(f"features.{i}.weight")                      # OIHW
            convs.append({
                "weight": np.transpose(w, (2, 3, 1, 0)).astype(np.float32),
                "bias": arr(f"features.{i}.bias").astype(np.float32)})
        fcs = []
        for i in (0, 3):
            w = arr(f"classifier.{i}.weight")                    # [out, in]
            if i == 0:
                # torch flattens the 7x7 pool as (C, H, W); this stack
                # flattens (H, W, C).
                out_f = w.shape[0]
                c = w.shape[1] // 49
                w = w.reshape(out_f, c, 7, 7).transpose(0, 2, 3, 1) \
                    .reshape(out_f, -1)
            fcs.append({
                "weight": w.T.astype(np.float32),
                "bias": arr(f"classifier.{i}.bias").astype(np.float32)})
        return VGG16Features(convs=convs, fcs=fcs, width_div=1)


def vgg16_extract_features(images, model: VGG16Features, device="cuda"):
    """NHWC uint8 / float images -> ``[B, fc width]`` ReLU features (the
    second FC's activation, the reference detector's ``return_features``),
    on ``device`` (a tensor's own device wins).  Images with a maximum above
    1.5 are divided by 255; then resized to 224 px (bilinear, as
    ``jax.image.resize``)."""
    if isinstance(images, torch.Tensor):
        device = images.device
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(images) if not isinstance(
        images, torch.Tensor) else images, device=dev).float()
    x = torch.where(x.amax() > 1.5, x / 255.0, x)
    x = x.permute(0, 3, 1, 2)
    if x.shape[2] != 224 or x.shape[3] != 224:
        x = resize_bilinear(x, 224, 224)
    ci = 0
    for spec in _VGG_PLAN:
        if spec == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        conv = model.convs[ci]
        ci += 1
        w = torch.as_tensor(conv["weight"], device=dev).permute(3, 2, 0, 1)
        x = F.relu(F.conv2d(x, w, torch.as_tensor(conv["bias"], device=dev),
                            padding=1))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    for fc in model.fcs:
        x = F.relu(x @ torch.as_tensor(fc["weight"], device=dev)
                   + torch.as_tensor(fc["bias"], device=dev))
    return x


def _sq_dists(rows, cols):
    """Squared pairwise distances ``[m, d] x [n, d] -> [m, n]``."""
    rn = (rows * rows).sum(-1)[:, None]
    cn = (cols * cols).sum(-1)[None, :]
    return torch.clamp_min(rn + cn - 2.0 * rows @ cols.T, 0.0)


def _kth_sq(manifold, k: int, row_bs: int):
    """Squared distance of each manifold point to its k-th neighbour."""
    out = []
    for i in range(0, len(manifold), row_bs):
        d = _sq_dists(manifold[i:i + row_bs], manifold)
        out.append(torch.topk(d, k + 1, dim=1, largest=False).values[:, -1])
    return torch.cat(out)


def _coverage(probes, manifold, kth_sq, row_bs: int) -> float:
    hits = []
    for i in range(0, len(probes), row_bs):
        d = _sq_dists(probes[i:i + row_bs], manifold)
        hits.append((d <= kth_sq[None, :]).any(dim=1))
    return float(np.mean(torch.cat(hits).cpu().numpy()))


def compute_pr(real_features, gen_features, nhood_size: int = 3,
               row_batch_size: int = 4096, device="cuda"
               ) -> Tuple[float, float]:
    """(precision, recall) of two feature arrays, computed on ``device``
    (reference precision_recall.py:50-61; nhood_size = 3 is pr50k3)."""
    dev = resolve_device(device)
    real = torch.as_tensor(np.asarray(real_features, np.float32), device=dev)
    gen = torch.as_tensor(np.asarray(gen_features, np.float32), device=dev)
    out = {}
    for name, manifold, probes in (("precision", real, gen),
                                   ("recall", gen, real)):
        kth = _kth_sq(manifold, nhood_size, row_batch_size)
        out[name] = _coverage(probes, manifold, kth, row_batch_size)
    return out["precision"], out["recall"]


def compute_pr_from_images(real_batches: Iterable, gen_batches: Iterable,
                           max_items: Optional[int] = None,
                           nhood_size: int = 3, model=None,
                           vgg: Optional[VGG16Features] = None,
                           device="cuda") -> Tuple[float, float]:
    """(precision, recall) between two streams of NHWC image batches, on
    the FID detector's features (``model``, or the default on ``device``),
    or on ``vgg``'s."""
    def collect(batches):
        feats, total = [], 0
        for b in batches:
            if vgg is not None:
                f = vgg16_extract_features(b, vgg, device)
            else:
                f = _fid.extract_features(b, model, device)
            feats.append(f.detach().cpu().numpy())
            total += len(feats[-1])
            if max_items and total >= max_items:
                break
        f = np.concatenate(feats)
        return f[:max_items] if max_items else f

    return compute_pr(collect(real_batches), collect(gen_batches),
                      nhood_size=nhood_size, device=device)
