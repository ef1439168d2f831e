"""Learned Perceptual Image Patch Similarity (LPIPS).

Counterpart of ``brushstroke_engine_tpu/metrics/lpips.py``: the AlexNet
feature stack with per-layer unit normalization and linear calibration
weights, over NHWC batches in [-1, 1].  Weights come from an `lpips`-package
state dict (:meth:`LPIPSModel.from_torch_state`) when one is installed
(``utils.weights``), else from :meth:`LPIPSModel.random_init`, which draws
the same ``np.random.RandomState(seed)`` numbers as the JAX package, so both
packages compute the same fallback metric.  The convolutions are stock torch
ops (cuDNN on the card).

The default model is cached per device: a CPU caller and a CUDA caller in
one process each get weights on their own device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from brushstroke_engine_torch.utils.util import resolve_device

# AlexNet conv stack: (out_ch, kernel, stride, pad)
_ALEX_PLAN = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}  # maxpool after these conv indices (stride-2, k3)

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def resize_bilinear(x, h: int, w: int):
    """NCHW bilinear resize to ``[h, w]`` as ``jax.image.resize(...,
    "bilinear")`` computes it: half-pixel centres, and a triangle kernel
    widened by the scale along an axis that shrinks (antialiasing)."""
    shrinks = h < x.shape[2] or w < x.shape[3]
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=shrinks)


@dataclass
class LPIPSModel:
    convs: List[Dict[str, torch.Tensor]]  # weight OIHW, bias [out]
    lins: List[torch.Tensor]              # per-layer calibration [C]
    # 'lpips_alex' for loaded weights, 'lpips_random' for the fallback.
    kind: str = "lpips_alex"

    @property
    def device(self) -> torch.device:
        return self.lins[0].device

    @staticmethod
    def _build(convs, lins, device, kind="lpips_alex") -> "LPIPSModel":
        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=dev)
        return LPIPSModel(
            convs=[{"weight": t(c["weight"]), "bias": t(c["bias"])}
                   for c in convs],
            lins=[t(lin) for lin in lins], kind=kind)

    @staticmethod
    def random_init(seed: int = 0, device="cuda") -> "LPIPSModel":
        """The JAX package's fallback weights (the same numpy draws, HWIO
        transposed to OIHW) on ``device``."""
        rng = np.random.RandomState(seed)
        convs = []
        cin = 3
        for (cout, k, s, p) in _ALEX_PLAN:
            std = float(np.sqrt(2.0 / (k * k * cin)))
            w = (std * rng.randn(k, k, cin, cout)).astype(np.float32)
            convs.append({"weight": np.transpose(w, (3, 2, 0, 1)),
                          "bias": np.zeros((cout,), np.float32)})
            cin = cout
        # Raw-application semantics (see lpips_pair): 1/c per layer.
        lins = [np.ones((c,), np.float32) / c for (c, *_rest) in _ALEX_PLAN]
        return LPIPSModel._build(convs, lins, device, kind="lpips_random")

    @staticmethod
    def from_torch_state(state: Dict[str, np.ndarray],
                         device="cuda") -> "LPIPSModel":
        """Build from an `lpips` package AlexNet state dict (torch layouts:
        ``net.slice{i}.{j}.weight`` OIHW, ``lin{i}.model.1.weight``)."""
        convs = []
        conv_keys = sorted([k for k in state if k.endswith(".weight")
                            and ".slice" in k])
        for k in conv_keys:
            w = np.asarray(state[k])
            if w.ndim != 4:
                continue
            convs.append({"weight": w,
                          "bias": np.asarray(
                              state[k.replace(".weight", ".bias")])})
        lins = []
        for i in range(len(_ALEX_PLAN)):
            for cand in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
                if cand in state:
                    lins.append(np.asarray(state[cand]).reshape(-1))
                    break
        if len(convs) != len(_ALEX_PLAN) or len(lins) != len(_ALEX_PLAN):
            raise ValueError(
                f"not an lpips AlexNet state dict: {len(convs)} convs and "
                f"{len(lins)} calibration layers, want {len(_ALEX_PLAN)}")
        return LPIPSModel._build(convs, lins, device)


_DEFAULT_MODELS: Dict[torch.device, LPIPSModel] = {}


def _device_key(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def get_default_model(device="cuda") -> LPIPSModel:
    """Real LPIPS-Alex when installed (``utils.weights``), else the labelled
    random fallback; one per device, built on first use there."""
    key = _device_key(device)
    if key not in _DEFAULT_MODELS:
        from brushstroke_engine_torch.utils.weights import find_weights
        path = find_weights("lpips")
        if path:
            from brushstroke_engine_torch.utils.weights import \
                load_state_dict
            _DEFAULT_MODELS[key] = LPIPSModel.from_torch_state(
                {k: v.numpy() for k, v in load_state_dict(path).items()},
                device=key)
        else:
            _DEFAULT_MODELS[key] = LPIPSModel.random_init(0, device=key)
    return _DEFAULT_MODELS[key]


def set_default_model(model: LPIPSModel):
    """Use ``model`` as the default on its device."""
    _DEFAULT_MODELS[_device_key(model.device)] = model


def _features(model: LPIPSModel, x):
    """x: NCHW in [-1, 1] -> list of channel-normalized NCHW feature maps."""
    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
    x = (x - shift) / scale
    feats = []
    for i, ((cout, k, s, p), conv) in enumerate(zip(_ALEX_PLAN, model.convs)):
        x = F.relu(F.conv2d(x, conv["weight"], conv["bias"], stride=s,
                            padding=p))
        norm = torch.rsqrt(x.square().sum(dim=1, keepdim=True) + 1e-10)
        feats.append(x * norm)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 3, 2)
    return feats


def lpips_pair(x, y, model: Optional[LPIPSModel] = None):
    """LPIPS distance between NHWC image batches in [-1, 1] -> ``[B]``."""
    model = model or get_default_model(x.device)
    x = x.float().permute(0, 3, 1, 2)
    y = y.float().permute(0, 3, 1, 2)
    # The AlexNet stride/pool chain leaves no pixel below ~32 px: upsample
    # small inputs to the least working size.
    if x.shape[2] < 32 or x.shape[3] < 32:
        h, w = max(32, x.shape[2]), max(32, x.shape[3])
        x = resize_bilinear(x, h, w)
        y = resize_bilinear(y, h, w)
    total = 0.0
    for f1, f2, lin in zip(_features(model, x), _features(model, y),
                           model.lins):
        # The lpips package applies the calibration weights raw (a 1x1
        # conv over the squared difference), not squared.
        d = (f1 - f2).square() * lin[None, :, None, None]
        total = total + d.sum(dim=1).mean(dim=(1, 2))
    return total


def lpips_batched(x, y, model: Optional[LPIPSModel] = None):
    """Per-item LPIPS distances ``[B]`` of NHWC batches in [-1, 1]."""
    return lpips_pair(x, y, model)
