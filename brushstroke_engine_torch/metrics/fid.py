"""Frechet Inception Distance, KID and IS.

Counterpart of ``brushstroke_engine_tpu/metrics/fid.py``: real statistics
from the style images, generated statistics from strokes painted in 'full'
mode, the Frechet distance between gaussian fits of the pool features
(``scipy.linalg.sqrtm`` on the host, as in the JAX package).

Detector kinds (every metric output should carry the kind, so that numbers
from random features are never taken for canonical FID):

* ``inception_v3`` -- the real Inception-v3 (:mod:`.inception`), loaded by
  :func:`load_detector` from a file that ``NEUBE_FID_DETECTOR`` (or the
  weights directory, ``utils.weights``) names;
* ``random`` -- :class:`InceptionFeatures`, a light deterministic 5-conv
  stack (the default when no weights are installed).  FID over fixed random
  features is a valid two-sample discrepancy, comparable across runs of
  either package, but not with published FID numbers.

The default detector is cached per device, like the LPIPS model.
"""

from __future__ import annotations

import pickle
import zipfile
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from brushstroke_engine_torch.metrics.inception import (
    InceptionV3, inception_features,
)
from brushstroke_engine_torch.utils.util import resolve_device

# Random-fallback plan: (out_ch, kernel, stride).
_PLAN = [
    (32, 3, 2),
    (64, 3, 2),
    (128, 3, 2),
    (256, 3, 2),
    (512, 3, 2),
]
FEATURE_DIM = 512  # dim of the random-fallback detector (InceptionV3: 2048)


@dataclass
class InceptionFeatures:
    """The ``kind="random"`` fallback detector: a deterministic He-init conv
    stack (OIHW weights on one device)."""

    convs: List[Dict[str, torch.Tensor]]
    kind: str = "random"

    @property
    def device(self) -> torch.device:
        return self.convs[0]["weight"].device

    @staticmethod
    def random_init(seed: int = 0, device="cuda") -> "InceptionFeatures":
        """The JAX package's draws (``np.random.RandomState(seed)``, HWIO
        transposed to OIHW) on ``device``."""
        dev = resolve_device(device)
        rng = np.random.RandomState(seed)
        convs = []
        cin = 3
        for (cout, k, s) in _PLAN:
            std = float(np.sqrt(2.0 / (k * k * cin)))
            w = (std * rng.randn(k, k, cin, cout)).astype(np.float32)
            convs.append({
                "weight": torch.as_tensor(np.ascontiguousarray(
                    np.transpose(w, (3, 2, 0, 1))), device=dev),
                "bias": torch.zeros((cout,), device=dev)})
            cin = cout
        return InceptionFeatures(convs=convs)


Detector = Union[InceptionFeatures, InceptionV3]

_DEFAULTS: Dict[torch.device, Detector] = {}


def load_detector(path: str, device="cuda") -> InceptionV3:
    """Load a real Inception-v3 state dict (a torch .pt/.pth zip, or a pickle
    of numpy arrays) onto ``device``, telling the layout by its keys:
    torchvision (``Mixed_5b.branch1x1.conv.weight``) or the StyleGAN2-ADA
    TorchScript detector (``layers.mixed.tower...``)."""
    if zipfile.is_zipfile(path):
        from brushstroke_engine_torch.utils.weights import load_state_dict
        obj = load_state_dict(path)
    else:
        with open(path, "rb") as f:
            obj = pickle.load(f)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    state = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
             for k, v in obj.items()}
    if any(k.startswith("layers.") for k in state):
        return InceptionV3.from_nvidia_state(state, device=device)
    return InceptionV3.from_torchvision_state(state, device=device)


def _device_key(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def get_default_extractor(device="cuda") -> Detector:
    """The detector on ``device``: the real Inception-v3 when
    ``NEUBE_FID_DETECTOR`` (or the weights directory) names a file, else the
    labelled random fallback."""
    key = _device_key(device)
    if key not in _DEFAULTS:
        from brushstroke_engine_torch.utils.weights import find_weights
        path = find_weights("inception")
        _DEFAULTS[key] = load_detector(path, device=key) if path else \
            InceptionFeatures.random_init(0, device=key)
    return _DEFAULTS[key]


def set_default_extractor(model: Detector):
    """Use ``model`` as the default on its device."""
    _DEFAULTS[_device_key(model.device)] = model


def default_detector_kind(device="cuda") -> str:
    return get_default_extractor(device).kind


def extract_features(images, model: Optional[Detector] = None,
                     device="cuda"):
    """NHWC uint8 / float images -> ``[B, D]`` pool features on the
    detector's device (D = 2048 for Inception-v3, 512 for the random
    fallback).  ``device`` picks the default detector when ``model`` is
    None; a tensor's own device wins."""
    if model is None:
        if isinstance(images, torch.Tensor):
            device = images.device
        model = get_default_extractor(device)
    if isinstance(model, InceptionV3):
        return inception_features(model, images)
    x = torch.as_tensor(images, device=model.device).float()
    # [0, 255] images are rescaled; the test stays on the device.
    x = torch.where(x.amax() > 1.5, x / 127.5 - 1.0, x)
    x = x.permute(0, 3, 1, 2)
    for (cout, k, s), conv in zip(_PLAN, model.convs):
        x = F.relu(F.conv2d(x, conv["weight"], conv["bias"], stride=s,
                            padding=k // 2))
    return x.mean(dim=(2, 3))  # global average pool


class FeatureStats:
    """Streaming mean / covariance accumulator on the host (float64)."""

    def __init__(self, max_items: Optional[int] = None,
                 dim: Optional[int] = None):
        self.max_items = max_items
        self.num_items = 0
        self.dim = dim
        if dim is not None:
            self._alloc(dim)
        else:
            self.raw_mean = self.raw_cov = None

    def _alloc(self, dim: int):
        self.dim = dim
        self.raw_mean = np.zeros(dim, np.float64)
        self.raw_cov = np.zeros((dim, dim), np.float64)

    def append(self, feats):
        if isinstance(feats, torch.Tensor):
            feats = feats.detach().cpu().numpy()
        feats = np.asarray(feats, np.float64)
        if self.raw_mean is None:
            self._alloc(feats.shape[1])
        if self.max_items is not None:
            room = self.max_items - self.num_items
            if room <= 0:
                return
            feats = feats[:room]
        self.num_items += feats.shape[0]
        self.raw_mean += feats.sum(axis=0)
        self.raw_cov += feats.T @ feats

    @property
    def is_full(self) -> bool:
        return self.max_items is not None and \
            self.num_items >= self.max_items

    def get_mean_cov(self):
        if self.raw_mean is None:
            self._alloc(FEATURE_DIM)
        mean = self.raw_mean / max(self.num_items, 1)
        cov = self.raw_cov / max(self.num_items, 1) - np.outer(mean, mean)
        return mean, cov


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """The FID formula, ``scipy.linalg.sqrtm`` on the host (called without
    ``disp``, which SciPy 1.18 removed)."""
    import scipy.linalg
    m = np.square(mu1 - mu2).sum()
    s = scipy.linalg.sqrtm(np.dot(sigma1, sigma2))
    dist = m + np.trace(sigma1 + sigma2 - 2 * np.real(s))
    return float(np.real(dist))


def compute_fid_from_feature_stats(stats_real: FeatureStats,
                                   stats_gen: FeatureStats) -> float:
    mu_r, sig_r = stats_real.get_mean_cov()
    mu_g, sig_g = stats_gen.get_mean_cov()
    return frechet_distance(mu_g, sig_g, mu_r, sig_r)


def kernel_inception_distance(feats_real: np.ndarray, feats_gen: np.ndarray,
                              num_subsets: int = 10,
                              max_subset_size: int = 1000,
                              seed: int = 0) -> float:
    """KID: polynomial-kernel MMD over pool features (numpy, the JAX
    package's subset draws)."""
    rng = np.random.RandomState(seed)
    n = feats_real.shape[1]
    m = min(feats_real.shape[0], feats_gen.shape[0], max_subset_size)
    t = 0.0
    for _ in range(num_subsets):
        x = feats_gen[rng.choice(feats_gen.shape[0], m, replace=False)]
        y = feats_real[rng.choice(feats_real.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


def inception_score(feats: np.ndarray, num_splits: int = 10) -> float:
    """IS over the softmax of pool features (numpy)."""
    probs = np.exp(feats - feats.max(1, keepdims=True))
    probs = probs / probs.sum(1, keepdims=True)
    scores = []
    n = probs.shape[0]
    for i in range(num_splits):
        part = probs[i * n // num_splits:(i + 1) * n // num_splits]
        if len(part) == 0:
            continue
        kl = part * (np.log(part + 1e-12)
                     - np.log(part.mean(0, keepdims=True) + 1e-12))
        scores.append(np.exp(kl.sum(1).mean()))
    return float(np.mean(scores))


def fid_from_image_iterables(real_batches: Iterable, gen_batches: Iterable,
                             max_items: Optional[int] = None,
                             model: Optional[Detector] = None,
                             device="cuda") -> float:
    """FID between two streams of NHWC image batches."""
    sr = FeatureStats(max_items)
    sg = FeatureStats(max_items)
    for batch in real_batches:
        sr.append(extract_features(batch, model, device))
        if sr.is_full:
            break
    for batch in gen_batches:
        sg.append(extract_features(batch, model, device))
        if sg.is_full:
            break
    return compute_fid_from_feature_stats(sr, sg)
