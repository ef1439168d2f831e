"""Configurable geometry/style loss DSL.

Counterpart of ``brushstroke_engine_tpu/train/losses.py`` with the SAME
string grammar and semantics:

    "<w>*<name>(<component>[,arg=val...])+<w>*<name>(<component>)"
    e.g. "0.5*iou_inv(uvs)+0.5*iou(u)+50*l1(fake_orig)"

Registered losses: rgb, hsv, plpips, iou, iou_inv, dice, dice_inv, l1, gan,
lpips, bce, bgstd, bgl2, fgl4gt.  Components: canvas, uvs, u, alpha,
fake_img, color_0..2, fake_orig, fake_composite, patch, fake.

All compute functions are torch ops over a ``debug_data`` dict (NHWC).  The
two LPIPS-based losses (``lpips``, ``plpips``) use the default LPIPS model
of their input's device (``metrics/lpips.py``).

Random crops take explicit draws: ``rng`` is an object with numpy's
``Generator.integers(low, high)`` (the training loop passes its host
generator), so crop offsets are host ints and nothing is read back from the
device.

Triband partial-loss masking: with ``partial_loss_with_triband_input`` the
geometry truth is triband (1 = BG, 0 = FG, gray = neither) and pixels in the
gray band are excluded, by weight masks as in the JAX package.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from brushstroke_engine_torch.parallel.distributed import (
    all_reduce_sum, batch_mean,
)

_FUNCTION_PATTERN = re.compile(r"(\w*)\((\w*)(,[a-zA-Z0-9_,=\.]*)?\)")
VALID_COMPONENTS = {"canvas", "uvs", "u", "alpha", "fake_img", "color_0",
                    "color_1", "color_2", "fake_orig", "fake_composite",
                    "patch", "fake"}


def _robust_split(s: str, delim: str) -> List[str]:
    return [x for x in s.strip().strip("'").replace(" ", "").split(delim)
            if len(x) > 0]


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def triband_mask(truth):
    """1.0 where truth is confidently FG or BG (reference losses.py:24-34)."""
    return ((truth < 0.1) | (truth > 0.9)).float()


def masked_mean(value, mask):
    """A ratio of batch sums: under a data-parallel group both sums are the
    global batch's (``all_reduce_sum``: the value is the global one on every
    rank, and the backward sums the ranks' cotangents, so the mean of the
    ranks' gradients is the single process's)."""
    return all_reduce_sum((value * mask).sum()) / torch.clamp_min(
        all_reduce_sum(mask.sum()), 1e-8)


def get_foreground(debug_data, component):
    if component == "uvs":
        return debug_data["uvs"][..., :2].sum(dim=-1)         # [B, H, W]
    if component == "u":
        return debug_data["uvs"][..., 0]
    if component == "alpha":
        return debug_data["alpha"][..., 0]
    raise ValueError(f"unsupported foreground component {component}")


def get_background(debug_data, component):
    if component == "uvs":
        return debug_data["uvs"][..., 2]
    if component == "alpha":
        return debug_data["alpha"][..., 1]
    raise ValueError(f"unsupported background component {component}")


def get_rgb_component(debug_data, component):
    if component == "canvas":
        return debug_data["canvas"]                            # [B,H,W,3]
    if component.startswith("color_"):
        return debug_data["colors"][..., int(component[-1])]   # [B,3]
    raise ValueError(f"unsupported rgb component {component}")


def compute_iou(source, target, mask=None):
    """1 - mean IoU; per-image over [B, H, W] (reference losses.py:649)."""
    if mask is not None:
        source = source * mask
        target = target * mask
    inter = (source * target).sum(dim=(1, 2))
    union = (source + target).sum(dim=(1, 2)) - inter + 1e-8
    return 1.0 - (inter / union).mean()


def compute_dice(source, target, mask=None):
    """1 - mean Dice (reference losses.py:634; Deng et al. ECCV 2018)."""
    if mask is not None:
        source = source * mask
        target = target * mask
    inter = (source * target).sum(dim=(1, 2))
    total = (source.square() + target.square()).sum(dim=(1, 2)) + 1e-8
    return 1.0 - 2.0 * (inter / total).mean()


def random_patches(rng, images, patch_width=None):
    """Random same-location crop across the batch ([B,H,W,C]); the offsets
    are ``rng.integers`` draws (y first, then x)."""
    h = images.shape[1]
    if patch_width is None:
        patch_width = h // 4
    y = int(rng.integers(0, h - patch_width + 1))
    x = int(rng.integers(0, images.shape[2] - patch_width + 1))
    return images[:, y:y + patch_width, x:x + patch_width]


def _l1(a, b):
    return (a - b).abs().mean()


def _l2(a, b):
    return (a - b).square().mean()


def _loss_by_name(name):
    return {"L1": _l1, "L2": _l2}[name]


# ---------------------------------------------------------------------------
# Loss items
# ---------------------------------------------------------------------------

@dataclass
class LossItem:
    name: str
    component: str
    weight: float
    args: Dict[str, str] = field(default_factory=dict)
    partial_triband: bool = False
    string_config: str = ""

    @property
    def full_name(self):
        return f"{self.name}_{self.component}"

    def compute(self, debug_data, geom_truth, rng=None):
        fn = _REGISTRY[self.name]
        return fn(self, debug_data, geom_truth, rng)

    def _geom_mask(self, geom_truth):
        if self.partial_triband and geom_truth is not None:
            return triband_mask(geom_truth[..., 0])
        return None


_REGISTRY: Dict[str, Callable] = {}


def register_loss(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


@register_loss("rgb")
def _rgb_loss(item, dd, geom_truth, rng):
    """Pull a color/canvas component towards a target RGB (losses.py:341)."""
    r = float(item.args.get("r", 0.5))
    g = float(item.args.get("g", 0.5))
    b = float(item.args.get("b", 0.5))
    loss = _loss_by_name(item.args.get("loss", "L1"))
    mean_rgb = bool(item.args.get("mean_rgb", False))
    if item.component == "uvs":
        inpt = dd["uvs"] * 2 - 1                    # [B,H,W,3]
    else:
        inpt = get_rgb_component(dd, item.component)
    inpt = inpt * 0.5 + 0.5
    target = torch.tensor([r, g, b], dtype=torch.float32, device=inpt.device)
    if mean_rgb:
        # A mean over every row: the global batch's under a group.
        inpt = batch_mean(inpt, dim=tuple(range(inpt.ndim - 1)))
    return loss(inpt, target.expand(inpt.shape))


@register_loss("hsv")
def _hsv_loss(item, dd, geom_truth, rng):
    """Target saturation/value of a color component (losses.py:379)."""
    loss = _loss_by_name(item.args.get("loss", "L2"))
    v = item.args.get("v")
    s = item.args.get("s")
    rgb = get_rgb_component(dd, item.component)     # [..., 3] in [-1, 1]
    maxes = rgb.amax(dim=-1) * 0.5 + 0.5
    mins = rgb.amin(dim=-1) * 0.5 + 0.5
    val = maxes
    maxes = torch.clamp(maxes, 0, 1)
    mins = torch.clamp(mins, 0, 1)
    sat = (maxes - mins) / torch.clamp_min(maxes, 1.0 / 255)
    res = 0.0
    if v is not None:
        res = res + loss(val, torch.full_like(val, float(v)))
    if s is not None:
        res = res + loss(sat, torch.full_like(sat, float(s)))
    return res


@register_loss("plpips")
def _plpips_loss(item, dd, geom_truth, rng):
    """Patch-LPIPS uniformity of the background/canvas (losses.py:435)."""
    from brushstroke_engine_torch.metrics.lpips import lpips_batched
    if item.component == "canvas":
        images = dd["canvas"]
    else:
        bg = get_background(dd, item.component)
        images = bg[..., None].expand(*bg.shape, 3) * 2 - 1
    assert rng is not None, "plpips needs crop draws"
    p0 = random_patches(rng, images)
    p1 = random_patches(rng, images)
    return lpips_batched(p0, p1).mean()


@register_loss("iou")
def _iou_loss(item, dd, geom_truth, rng):
    target = 1.0 - geom_truth[..., 0]
    source = get_foreground(dd, item.component)
    return compute_iou(source, target, item._geom_mask(geom_truth))


@register_loss("iou_inv")
def _iou_inv_loss(item, dd, geom_truth, rng):
    target = geom_truth[..., 0]
    source = get_background(dd, item.component)
    return compute_iou(source, target, item._geom_mask(geom_truth))


@register_loss("dice")
def _dice_loss(item, dd, geom_truth, rng):
    target = 1.0 - geom_truth[..., 0]
    source = get_foreground(dd, item.component)
    return compute_dice(source, target, item._geom_mask(geom_truth))


@register_loss("dice_inv")
def _dice_inv_loss(item, dd, geom_truth, rng):
    target = geom_truth[..., 0]
    source = get_background(dd, item.component)
    return compute_dice(source, target, item._geom_mask(geom_truth))


@register_loss("l1")
def _l1_loss(item, dd, geom_truth, rng):
    c = item.component
    if c == "canvas":
        assert rng is not None, "l1(canvas) needs crop draws"
        target = random_patches(rng, dd["canvas"])
        source = random_patches(rng, dd["canvas"])
    elif c == "fake_img":
        target = dd["fake_img"].detach()
        source = dd["fake_img"]
    elif c == "fake_orig":
        target = dd["fake_orig"].detach()
        source = dd["fake_img"]
    elif c == "fake_composite":
        target = dd["fake"]
        source = dd["fake_composite"]
    elif c == "patch":
        target = dd["patch1"]
        source = dd["patch2"]
    else:
        target = 1.0 - geom_truth[..., 0]
        source = get_foreground(dd, c)
        mask = item._geom_mask(geom_truth)
        if mask is not None:
            return masked_mean((source - target).abs(), mask)
    return _l1(source, target)


@register_loss("gan")
def _gan_loss(item, dd, geom_truth, rng):
    logits = dd[f"{item.component}_logits"]
    return F.softplus(-logits).mean()


@register_loss("lpips")
def _lpips_loss(item, dd, geom_truth, rng):
    from brushstroke_engine_torch.metrics.lpips import lpips_batched
    c = item.component
    if c == "fake_composite":
        target, source = dd["fake"], dd["fake_composite"]
    elif c == "fake_orig":
        target, source = dd["fake_orig"].detach(), dd["fake_img"]
    elif c == "patch":
        target, source = dd["patch1"], dd["patch2"]
    else:
        raise ValueError(f"lpips: unsupported component {c}")
    return lpips_batched(target, source).mean()


@register_loss("bce")
def _bce_loss(item, dd, geom_truth, rng):
    target = 1.0 - geom_truth[..., 0]
    source = torch.clamp(get_foreground(dd, item.component), 1e-7, 1 - 1e-7)
    bce = -(target * torch.log(source)
            + (1 - target) * torch.log(1 - source))
    mask = item._geom_mask(geom_truth)
    if mask is not None:
        return masked_mean(bce, mask)
    return bce.mean()


@register_loss("bgstd")
def _bgstd_loss(item, dd, geom_truth, rng):
    """Std of the background channel over confident-BG pixels (losses.py:582),
    unbiased per image, by masked moments."""
    target_bin = (geom_truth[..., 0] > 0.99).float()
    source = get_background(dd, item.component)
    n = torch.clamp_min(target_bin.sum(dim=(1, 2)), 2)
    mean = (source * target_bin).sum(dim=(1, 2)) / n
    var = ((source - mean[:, None, None]).square() * target_bin).sum(
        dim=(1, 2)) / (n - 1)
    return torch.sqrt(var + 1e-12).mean()


@register_loss("bgl2")
def _bgl2_loss(item, dd, geom_truth, rng):
    target_bin = (geom_truth[..., 0] > 0.99).float()
    source = get_background(dd, item.component)
    total = target_bin.sum(dim=(1, 2)) + 1e-8
    num = (source.square() * target_bin).sum(dim=(1, 2))
    return 1.0 - (num / total).mean()


@register_loss("fgl4gt")
def _fgl4gt_loss(item, dd, geom_truth, rng):
    """Gated 4th-power foreground coverage (losses.py:615)."""
    target_bin = (geom_truth[..., 0] <= 0.9).float()
    if item.component != "uvs":
        raise ValueError("fgl4gt supports only the uvs component")
    source = dd["uvs"][..., 0]
    total = target_bin.sum(dim=(1, 2)) + 1e-8
    num = (source ** 4 * target_bin).sum(dim=(1, 2))
    return F.relu(0.6 - num / total).mean()


# ---------------------------------------------------------------------------
# Parser + container
# ---------------------------------------------------------------------------

def split_loss_string(in_string: str) -> Tuple[float, str, str, Dict]:
    parts = _robust_split(in_string, "*")
    weight = 1.0
    if len(parts) == 2:
        weight = float(parts[0])
    elif len(parts) != 1:
        raise ValueError(f"Mis-configured loss string {in_string}")
    m = _FUNCTION_PATTERN.match(parts[-1])
    if m is None:
        raise ValueError(f"Mis-configured loss string {in_string}; expected "
                         f"<float>*<loss_name>(<component>)")
    name, component = m.group(1), m.group(2)
    args = {}
    if m.group(3):
        for part in _robust_split(m.group(3), ","):
            kv = _robust_split(part, "=")
            if len(kv) != 2:
                raise ValueError(f"Invalid argument string {m.group(3)}")
            if kv[0] in args:
                raise ValueError(f"Argument {kv[0]} repeated")
            args[kv[0]] = kv[1]
    return weight, name, component, args


class ForgerLosses:
    """Weighted loss list configured from a string (reference losses.py:37)."""

    @staticmethod
    def create_from_string(config_string: Optional[str]) -> "ForgerLosses":
        if config_string is None or len(config_string.strip()) == 0:
            return ForgerLosses([])
        items = []
        for part in _robust_split(config_string, "+"):
            weight, name, component, args = split_loss_string(part)
            if name not in _REGISTRY:
                raise ValueError(f"Loss {name} not registered; valid: "
                                 f"{sorted(_REGISTRY)}")
            if component not in VALID_COMPONENTS:
                raise ValueError(f'Component "{component}" not in '
                                 f"{sorted(VALID_COMPONENTS)}")
            items.append(LossItem(name=name, component=component,
                                  weight=weight, args=args,
                                  string_config=part))
        return ForgerLosses(items)

    def __init__(self, items: List[LossItem]):
        self.items = items
        names = [i.full_name for i in items]
        if len(names) != len(set(names)):
            raise ValueError("Loss with the same identifier defined twice")

    def set_partial_loss_with_triband_input(self, val: bool):
        for item in self.items:
            item.partial_triband = val

    def require_original_fake_image(self) -> bool:
        return any(i.component == "fake_orig" for i in self.items)

    def is_empty(self) -> bool:
        return len(self.items) == 0

    def compute(self, debug_data, geom_truth, rng=None):
        """Returns (total, {name: value})."""
        total = 0.0
        results = {}
        for item in self.items:
            results[item.full_name] = item.compute(debug_data, geom_truth,
                                                   rng=rng)
            total = total + item.weight * results[item.full_name]
        return total, results

    def summary(self) -> str:
        return " + ".join(f"{i.weight:g}*{i.name}({i.component})"
                          for i in self.items)
