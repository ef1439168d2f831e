"""Full Inception-v3 feature extractor (2048-d pool3).

Counterpart of ``brushstroke_engine_tpu/metrics/inception.py``: the stem,
the InceptionA/B/C/D/E towers and the global average pool as a functional
program over an explicit parameter dict, in stock torch ops (cuDNN on the
card).  Two weight layouts convert into it:

* :meth:`InceptionV3.from_torchvision_state`: torchvision's
  ``inception_v3`` state dict (``Mixed_5b.branch1x1.conv.weight`` and
  BatchNorm tensors), the layout pytorch-fid uses;
* :meth:`InceptionV3.from_nvidia_state`: the TorchScript detector of the
  StyleGAN2-ADA metrics (``layers.mixed_4.tower.conv_1.conv.weight`` and
  folded-BN ``beta`` biases), mapped by :func:`_nvidia_name_map`.

Without real weights, :meth:`InceptionV3.random_init` draws the same
He-init numbers as the JAX package (labelled ``inception_v3_random``).
Images are NHWC; the convolutions run NCHW.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from brushstroke_engine_torch.metrics.lpips import resize_bilinear
from brushstroke_engine_torch.utils.util import resolve_device

POOL_DIM = 2048
_BN_EPS = 1e-3

# ---------------------------------------------------------------------------
# Architecture table: every BasicConv2d in torchvision naming/order.
# Entry: (name, cin, cout, (kh, kw), (sh, sw), (ph, pw)).


def _convs_spec() -> List[Tuple[str, int, int, Tuple[int, int],
                                Tuple[int, int], Tuple[int, int]]]:
    spec = []

    def c(name, cin, cout, k, s=1, p=0):
        k = (k, k) if isinstance(k, int) else k
        p = (p, p) if isinstance(p, int) else p
        spec.append((name, cin, cout, k, (s, s), p))

    # Stem
    c("Conv2d_1a_3x3", 3, 32, 3, s=2)
    c("Conv2d_2a_3x3", 32, 32, 3)
    c("Conv2d_2b_3x3", 32, 64, 3, p=1)
    c("Conv2d_3b_1x1", 64, 80, 1)
    c("Conv2d_4a_3x3", 80, 192, 3)

    def inception_a(name, cin, pool_features):
        c(f"{name}.branch1x1", cin, 64, 1)
        c(f"{name}.branch5x5_1", cin, 48, 1)
        c(f"{name}.branch5x5_2", 48, 64, 5, p=2)
        c(f"{name}.branch3x3dbl_1", cin, 64, 1)
        c(f"{name}.branch3x3dbl_2", 64, 96, 3, p=1)
        c(f"{name}.branch3x3dbl_3", 96, 96, 3, p=1)
        c(f"{name}.branch_pool", cin, pool_features, 1)

    def inception_b(name, cin):
        c(f"{name}.branch3x3", cin, 384, 3, s=2)
        c(f"{name}.branch3x3dbl_1", cin, 64, 1)
        c(f"{name}.branch3x3dbl_2", 64, 96, 3, p=1)
        c(f"{name}.branch3x3dbl_3", 96, 96, 3, s=2)

    def inception_c(name, cin, c7):
        c(f"{name}.branch1x1", cin, 192, 1)
        c(f"{name}.branch7x7_1", cin, c7, 1)
        c(f"{name}.branch7x7_2", c7, c7, (1, 7), p=(0, 3))
        c(f"{name}.branch7x7_3", c7, 192, (7, 1), p=(3, 0))
        c(f"{name}.branch7x7dbl_1", cin, c7, 1)
        c(f"{name}.branch7x7dbl_2", c7, c7, (7, 1), p=(3, 0))
        c(f"{name}.branch7x7dbl_3", c7, c7, (1, 7), p=(0, 3))
        c(f"{name}.branch7x7dbl_4", c7, c7, (7, 1), p=(3, 0))
        c(f"{name}.branch7x7dbl_5", c7, 192, (1, 7), p=(0, 3))
        c(f"{name}.branch_pool", cin, 192, 1)

    def inception_d(name, cin):
        c(f"{name}.branch3x3_1", cin, 192, 1)
        c(f"{name}.branch3x3_2", 192, 320, 3, s=2)
        c(f"{name}.branch7x7x3_1", cin, 192, 1)
        c(f"{name}.branch7x7x3_2", 192, 192, (1, 7), p=(0, 3))
        c(f"{name}.branch7x7x3_3", 192, 192, (7, 1), p=(3, 0))
        c(f"{name}.branch7x7x3_4", 192, 192, 3, s=2)

    def inception_e(name, cin):
        c(f"{name}.branch1x1", cin, 320, 1)
        c(f"{name}.branch3x3_1", cin, 384, 1)
        c(f"{name}.branch3x3_2a", 384, 384, (1, 3), p=(0, 1))
        c(f"{name}.branch3x3_2b", 384, 384, (3, 1), p=(1, 0))
        c(f"{name}.branch3x3dbl_1", cin, 448, 1)
        c(f"{name}.branch3x3dbl_2", 448, 384, 3, p=1)
        c(f"{name}.branch3x3dbl_3a", 384, 384, (1, 3), p=(0, 1))
        c(f"{name}.branch3x3dbl_3b", 384, 384, (3, 1), p=(1, 0))
        c(f"{name}.branch_pool", cin, 192, 1)

    inception_a("Mixed_5b", 192, 32)
    inception_a("Mixed_5c", 256, 64)
    inception_a("Mixed_5d", 288, 64)
    inception_b("Mixed_6a", 288)
    inception_c("Mixed_6b", 768, 128)
    inception_c("Mixed_6c", 768, 160)
    inception_c("Mixed_6d", 768, 160)
    inception_c("Mixed_6e", 768, 192)
    inception_d("Mixed_7a", 768)
    inception_e("Mixed_7b", 1280)
    inception_e("Mixed_7c", 2048)
    return spec


CONVS = _convs_spec()
_CONV_INDEX = {name: i for i, (name, *_rest) in enumerate(CONVS)}

#: Total parameter count of the feature extractor (conv weights + BN
#: scale/bias), the architecture-spec invariant tests assert against.
PARAM_COUNT = sum(kh * kw * cin * cout + 2 * cout
                  for (_n, cin, cout, (kh, kw), _s, _p) in CONVS)


@dataclass
class InceptionV3:
    """Parameters and semantics toggles of the extractor.

    ``params[name]`` holds ``w`` (OIHW conv weight) and the batch-norm
    tensors ``scale`` / ``bias`` / ``mean`` / ``var`` (identity BN for
    folded layouts).  ``count_include_pad`` selects torch's AvgPool2d
    default (True) or the TF-weights semantics pytorch-fid restores (False);
    ``mixed_7c_pool_max``: the TF-2015 detector max-pools in Mixed_7c's pool
    branch.
    """

    params: Dict[str, Dict[str, torch.Tensor]]
    kind: str = "inception_v3"
    bn_eps: float = _BN_EPS
    count_include_pad: bool = True
    mixed_7c_pool_max: bool = False
    input_range: str = "tf"  # "tf": 2x-1 ; "torchvision": imagenet mean/std

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values()))["w"].device

    @staticmethod
    def _build(params, device, **kw) -> "InceptionV3":
        dev = resolve_device(device)
        return InceptionV3(params={
            name: {k: torch.as_tensor(np.ascontiguousarray(v, np.float32),
                                      device=dev) for k, v in p.items()}
            for name, p in params.items()}, **kw)

    @staticmethod
    def random_init(seed: int = 0, device="cuda") -> "InceptionV3":
        """He-init weights from ``np.random.RandomState(seed)`` (the JAX
        package's draws, HWIO transposed to OIHW), identity BN."""
        rng = np.random.RandomState(seed)
        params = {}
        for (name, cin, cout, (kh, kw), _s, _p) in CONVS:
            std = float(np.sqrt(2.0 / (kh * kw * cin)))
            w = (std * rng.randn(kh, kw, cin, cout)).astype(np.float32)
            params[name] = {
                "w": np.transpose(w, (3, 2, 0, 1)),
                "scale": np.ones((cout,), np.float32),
                "bias": np.zeros((cout,), np.float32),
                "mean": np.zeros((cout,), np.float32),
                "var": np.ones((cout,), np.float32),
            }
        return InceptionV3._build(params, device, kind="inception_v3_random")

    @staticmethod
    def from_torchvision_state(state: Dict[str, np.ndarray],
                               device="cuda") -> "InceptionV3":
        """Convert a torchvision ``inception_v3`` state dict (OIHW convs and
        BatchNorm2d tensors; ``fc`` / ``AuxLogits`` entries ignored)."""
        params = {}
        for (name, cin, cout, (kh, kw), _s, _p) in CONVS:
            w = np.asarray(state[f"{name}.conv.weight"], np.float32)
            if w.shape != (cout, cin, kh, kw):
                raise ValueError(
                    f"{name}: weight shape {w.shape} != "
                    f"{(cout, cin, kh, kw)}")
            params[name] = {
                "w": w,
                "scale": np.asarray(state[f"{name}.bn.weight"]),
                "bias": np.asarray(state[f"{name}.bn.bias"]),
                "mean": np.asarray(state[f"{name}.bn.running_mean"]),
                "var": np.asarray(state[f"{name}.bn.running_var"]),
            }
        return InceptionV3._build(params, device, kind="inception_v3",
                                  count_include_pad=False,
                                  mixed_7c_pool_max=True)

    @staticmethod
    def from_nvidia_state(state: Dict[str, np.ndarray],
                          device="cuda") -> "InceptionV3":
        """Convert the StyleGAN2-ADA TorchScript detector's state dict (the
        TF-2015 network: ``layers.<node>.conv.weight`` OIHW and folded-BN
        ``layers.<node>.beta`` biases)."""
        params = {}
        for tv_name, nv_name in _nvidia_name_map().items():
            (_n, cin, cout, (kh, kw), _s, _p) = CONVS[_CONV_INDEX[tv_name]]
            w = np.asarray(state[f"layers.{nv_name}.conv.weight"], np.float32)
            if w.shape != (cout, cin, kh, kw):
                raise ValueError(
                    f"{tv_name} <- layers.{nv_name}: weight shape {w.shape}"
                    f" != {(cout, cin, kh, kw)}")
            params[tv_name] = {
                "w": w,
                "scale": np.ones((cout,), np.float32),
                "bias": np.asarray(state[f"layers.{nv_name}.beta"]),
                "mean": np.zeros((cout,), np.float32),
                "var": np.ones((cout,), np.float32),
            }
        return InceptionV3._build(params, device, kind="inception_v3",
                                  bn_eps=0.0, count_include_pad=False,
                                  mixed_7c_pool_max=True)

    def param_count(self) -> int:
        return sum(int(p["w"].numel()) + 2 * p["w"].shape[0]
                   for p in self.params.values())


def _nvidia_name_map() -> Dict[str, str]:
    """torchvision conv name -> NVIDIA TorchScript node name.

    TF graph naming: stem convs are conv..conv_4; 35x35 blocks mixed..mixed_2;
    17x17 reduction mixed_3; 17x17 blocks mixed_4..mixed_7; 8x8 reduction
    mixed_8; 8x8 blocks mixed_9, mixed_10.  Branches are conv / tower /
    tower_1 / tower_2 with conv_N members; InceptionE's split 1x3/3x1 pairs
    live under ``tower.mixed`` / ``tower_1.mixed``.
    """
    m = {
        "Conv2d_1a_3x3": "conv", "Conv2d_2a_3x3": "conv_1",
        "Conv2d_2b_3x3": "conv_2", "Conv2d_3b_1x1": "conv_3",
        "Conv2d_4a_3x3": "conv_4",
    }
    for tv, nv in (("Mixed_5b", "mixed"), ("Mixed_5c", "mixed_1"),
                   ("Mixed_5d", "mixed_2")):
        m.update({
            f"{tv}.branch1x1": f"{nv}.conv",
            f"{tv}.branch5x5_1": f"{nv}.tower.conv",
            f"{tv}.branch5x5_2": f"{nv}.tower.conv_1",
            f"{tv}.branch3x3dbl_1": f"{nv}.tower_1.conv",
            f"{tv}.branch3x3dbl_2": f"{nv}.tower_1.conv_1",
            f"{tv}.branch3x3dbl_3": f"{nv}.tower_1.conv_2",
            f"{tv}.branch_pool": f"{nv}.tower_2.conv",
        })
    m.update({
        "Mixed_6a.branch3x3": "mixed_3.conv",
        "Mixed_6a.branch3x3dbl_1": "mixed_3.tower.conv",
        "Mixed_6a.branch3x3dbl_2": "mixed_3.tower.conv_1",
        "Mixed_6a.branch3x3dbl_3": "mixed_3.tower.conv_2",
    })
    for tv, nv in (("Mixed_6b", "mixed_4"), ("Mixed_6c", "mixed_5"),
                   ("Mixed_6d", "mixed_6"), ("Mixed_6e", "mixed_7")):
        m.update({
            f"{tv}.branch1x1": f"{nv}.conv",
            f"{tv}.branch7x7_1": f"{nv}.tower.conv",
            f"{tv}.branch7x7_2": f"{nv}.tower.conv_1",
            f"{tv}.branch7x7_3": f"{nv}.tower.conv_2",
            f"{tv}.branch7x7dbl_1": f"{nv}.tower_1.conv",
            f"{tv}.branch7x7dbl_2": f"{nv}.tower_1.conv_1",
            f"{tv}.branch7x7dbl_3": f"{nv}.tower_1.conv_2",
            f"{tv}.branch7x7dbl_4": f"{nv}.tower_1.conv_3",
            f"{tv}.branch7x7dbl_5": f"{nv}.tower_1.conv_4",
            f"{tv}.branch_pool": f"{nv}.tower_2.conv",
        })
    m.update({
        "Mixed_7a.branch3x3_1": "mixed_8.tower.conv",
        "Mixed_7a.branch3x3_2": "mixed_8.tower.conv_1",
        "Mixed_7a.branch7x7x3_1": "mixed_8.tower_1.conv",
        "Mixed_7a.branch7x7x3_2": "mixed_8.tower_1.conv_1",
        "Mixed_7a.branch7x7x3_3": "mixed_8.tower_1.conv_2",
        "Mixed_7a.branch7x7x3_4": "mixed_8.tower_1.conv_3",
    })
    for tv, nv in (("Mixed_7b", "mixed_9"), ("Mixed_7c", "mixed_10")):
        m.update({
            f"{tv}.branch1x1": f"{nv}.conv",
            f"{tv}.branch3x3_1": f"{nv}.tower.conv",
            f"{tv}.branch3x3_2a": f"{nv}.tower.mixed.conv",
            f"{tv}.branch3x3_2b": f"{nv}.tower.mixed.conv_1",
            f"{tv}.branch3x3dbl_1": f"{nv}.tower_1.conv",
            f"{tv}.branch3x3dbl_2": f"{nv}.tower_1.conv_1",
            f"{tv}.branch3x3dbl_3a": f"{nv}.tower_1.mixed.conv",
            f"{tv}.branch3x3dbl_3b": f"{nv}.tower_1.mixed.conv_1",
            f"{tv}.branch_pool": f"{nv}.tower_2.conv",
        })
    return m


# ---------------------------------------------------------------------------
# Forward pass (NCHW inside).


def _conv_bn_relu(model: InceptionV3, name: str, x):
    (_n, _cin, _cout, _k, stride, pad) = CONVS[_CONV_INDEX[name]]
    p = model.params[name]
    x = F.conv2d(x, p["w"], stride=stride, padding=pad)
    inv = p["scale"] * torch.rsqrt(p["var"] + model.bn_eps)
    x = (x - p["mean"][:, None, None]) * inv[:, None, None] \
        + p["bias"][:, None, None]
    return F.relu(x)


def _max_pool(x, k=3, s=2, p=0):
    return F.max_pool2d(x, k, s, p)


def _avg_pool_3x3(x, count_include_pad: bool):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=count_include_pad)


def _block_a(model, name, x):
    b1 = _conv_bn_relu(model, f"{name}.branch1x1", x)
    b5 = _conv_bn_relu(model, f"{name}.branch5x5_1", x)
    b5 = _conv_bn_relu(model, f"{name}.branch5x5_2", b5)
    b3 = _conv_bn_relu(model, f"{name}.branch3x3dbl_1", x)
    b3 = _conv_bn_relu(model, f"{name}.branch3x3dbl_2", b3)
    b3 = _conv_bn_relu(model, f"{name}.branch3x3dbl_3", b3)
    bp = _avg_pool_3x3(x, model.count_include_pad)
    bp = _conv_bn_relu(model, f"{name}.branch_pool", bp)
    return torch.cat([b1, b5, b3, bp], dim=1)


def _block_b(model, name, x):
    b3 = _conv_bn_relu(model, f"{name}.branch3x3", x)
    bd = _conv_bn_relu(model, f"{name}.branch3x3dbl_1", x)
    bd = _conv_bn_relu(model, f"{name}.branch3x3dbl_2", bd)
    bd = _conv_bn_relu(model, f"{name}.branch3x3dbl_3", bd)
    bp = _max_pool(x)
    return torch.cat([b3, bd, bp], dim=1)


def _block_c(model, name, x):
    b1 = _conv_bn_relu(model, f"{name}.branch1x1", x)
    b7 = _conv_bn_relu(model, f"{name}.branch7x7_1", x)
    b7 = _conv_bn_relu(model, f"{name}.branch7x7_2", b7)
    b7 = _conv_bn_relu(model, f"{name}.branch7x7_3", b7)
    bd = _conv_bn_relu(model, f"{name}.branch7x7dbl_1", x)
    for i in (2, 3, 4, 5):
        bd = _conv_bn_relu(model, f"{name}.branch7x7dbl_{i}", bd)
    bp = _avg_pool_3x3(x, model.count_include_pad)
    bp = _conv_bn_relu(model, f"{name}.branch_pool", bp)
    return torch.cat([b1, b7, bd, bp], dim=1)


def _block_d(model, name, x):
    b3 = _conv_bn_relu(model, f"{name}.branch3x3_1", x)
    b3 = _conv_bn_relu(model, f"{name}.branch3x3_2", b3)
    b7 = _conv_bn_relu(model, f"{name}.branch7x7x3_1", x)
    for i in (2, 3, 4):
        b7 = _conv_bn_relu(model, f"{name}.branch7x7x3_{i}", b7)
    bp = _max_pool(x)
    return torch.cat([b3, b7, bp], dim=1)


def _block_e(model, name, x, pool_max: bool):
    b1 = _conv_bn_relu(model, f"{name}.branch1x1", x)
    b3 = _conv_bn_relu(model, f"{name}.branch3x3_1", x)
    b3 = torch.cat([
        _conv_bn_relu(model, f"{name}.branch3x3_2a", b3),
        _conv_bn_relu(model, f"{name}.branch3x3_2b", b3)], dim=1)
    bd = _conv_bn_relu(model, f"{name}.branch3x3dbl_1", x)
    bd = _conv_bn_relu(model, f"{name}.branch3x3dbl_2", bd)
    bd = torch.cat([
        _conv_bn_relu(model, f"{name}.branch3x3dbl_3a", bd),
        _conv_bn_relu(model, f"{name}.branch3x3dbl_3b", bd)], dim=1)
    if pool_max:
        bp = _max_pool(x, k=3, s=1, p=1)
    else:
        bp = _avg_pool_3x3(x, model.count_include_pad)
    bp = _conv_bn_relu(model, f"{name}.branch_pool", bp)
    return torch.cat([b1, b3, bd, bp], dim=1)


def preprocess(images, input_range: str = "tf", device=None):
    """NHWC uint8 / [0, 255] / [0, 1] images (any H, W; 1 or 3 channels)
    -> NCHW ``[B, 3, 299, 299]`` normalized float32 on ``device`` (default:
    the images' own, for a tensor).  The [0, 255] test reads the batch's
    largest value on the device: no host read."""
    x = torch.as_tensor(images, device=device).float()
    x = torch.where(x.abs().amax() > 1.5, x / 255.0, x)
    if x.shape[-1] == 1:
        x = x.expand(-1, -1, -1, 3)
    x = x.permute(0, 3, 1, 2)
    if tuple(x.shape[2:]) != (299, 299):
        x = resize_bilinear(x, 299, 299)
    if input_range == "torchvision":
        mean = torch.tensor([0.485, 0.456, 0.406], device=x.device)
        std = torch.tensor([0.229, 0.224, 0.225], device=x.device)
        return (x - mean[:, None, None]) / std[:, None, None]
    return 2.0 * x - 1.0


def inception_features(model: InceptionV3, images,
                       preprocessed: bool = False):
    """Images -> ``[B, 2048]`` pool3 features on the model's device
    (``preprocessed``: already NCHW from :func:`preprocess`)."""
    x = images if preprocessed else preprocess(images, model.input_range,
                                               device=model.device)
    x = _conv_bn_relu(model, "Conv2d_1a_3x3", x)
    x = _conv_bn_relu(model, "Conv2d_2a_3x3", x)
    x = _conv_bn_relu(model, "Conv2d_2b_3x3", x)
    x = _max_pool(x)
    x = _conv_bn_relu(model, "Conv2d_3b_1x1", x)
    x = _conv_bn_relu(model, "Conv2d_4a_3x3", x)
    x = _max_pool(x)
    x = _block_a(model, "Mixed_5b", x)
    x = _block_a(model, "Mixed_5c", x)
    x = _block_a(model, "Mixed_5d", x)
    x = _block_b(model, "Mixed_6a", x)
    x = _block_c(model, "Mixed_6b", x)
    x = _block_c(model, "Mixed_6c", x)
    x = _block_c(model, "Mixed_6d", x)
    x = _block_c(model, "Mixed_6e", x)
    x = _block_d(model, "Mixed_7a", x)
    x = _block_e(model, "Mixed_7b", x, pool_max=False)
    x = _block_e(model, "Mixed_7c", x, pool_max=model.mixed_7c_pool_max)
    return x.mean(dim=(2, 3))
