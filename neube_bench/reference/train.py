"""Plain PyTorch reference of NeuBE's GAN training: the four phases of a
batch (Dmain, Dr1, Gmain, Gpl), Adam with lazy regularisation, the w-average
and path-length means and the ADA adjustment, from the published
definitions (StyleGAN2 and StyleGAN2-ADA, Karras et al. 2020; NeuBE's
geometry-conditioned generator and color-triad head) as the JAX package
writes them, read and not imported.  It imports nothing of the program.

Layout: parameter trees as ``neube_bench/weights.py`` and
``neube_bench/train_weights.py`` make them; images NHWC at the edges,
NCHW inside.  Departures from StyleGAN2-ADA that the JAX package makes and
this reference follows: the ADA warp (``reference/augment.py``); the
convolution clamp at 256 in every block, not only in reduced precision; the
generator's color-triad head (three colors from the last style, a softmax
over three logits); the frozen geometry encoder's features concatenated
after the 16- and 32-px blocks.

Every random number is an input (``draws``, the phases' ``draws``
convention): the noise planes, the style-mixing draws, the augment draws
and the path-length noise.

Precision: a policy (:func:`precision`) names a mode for the mapping and
for each block of the generator and the discriminator: 'f32' (float32; the reference runs
so, with TF32 off, which the caller sets), 'bf16', or 'fp8' (inputs and
weights of each convolution rounded to float8 e4m3, computed in bf16).
The controls run the reference below the configuration's precision.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from neube_bench import train_weights as TW
from neube_bench import weights as W
from neube_bench.reference import augment as A
from neube_bench.reference.model import (
    _fc, _fir_filter, _lrelu, encode, mapping, triad_head, upsample_conv,
)

PHASES = ("Dmain", "Dr1", "Gmain", "Gpl")


def bf16_resolutions(cfg: Dict) -> List[int]:
    """The block resolutions the configuration runs in bf16 (its
    ``num_bf16_res`` highest, never 4)."""
    top = int(math.log2(cfg["img_resolution"]))
    low = max(2 ** (top + 1 - cfg["num_bf16_res"]), 8)
    return [r for r in W.block_resolutions(cfg) if r >= low] \
        if cfg["num_bf16_res"] else []


def precision(cfg: Dict, kind: str = "reference") -> Dict:
    """The precision policy ``kind``: 'reference' float32 everywhere;
    'bf16_all' bf16 in the mapping and in every block of G and D, the
    discriminator's epilogue too; 'below' one step below the configuration
    everywhere: TF32 where it states float32 (``tf32``), float8 where it
    states bf16."""
    res = W.block_resolutions(cfg)
    low = set(bf16_resolutions(cfg))
    if kind == "reference":
        return {"mapping": "f32", "g": {r: "f32" for r in res},
                "d": {r: "f32" for r in res}, "tf32": False}
    if kind == "bf16_all":
        return {"mapping": "bf16", "g": {r: "bf16" for r in res},
                "d": {r: "bf16" for r in res}, "tf32": False}
    if kind == "below":
        m = {r: "fp8" if r in low else "f32" for r in res}
        return {"mapping": "f32", "g": dict(m), "d": dict(m), "tf32": True}
    raise ValueError(kind)


def _cd(mode: str):
    return torch.float32 if mode == "f32" else torch.bfloat16


def _q(x, mode: str):
    """``x`` at the precision of ``mode``, in its compute dtype."""
    if mode == "fp8":
        x = x.float().clamp(-448.0, 448.0).to(torch.float8_e4m3fn)
    return x.to(_cd(mode))


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

def num_ws(cfg: Dict) -> int:
    return 2 * len(W.block_resolutions(cfg))


def _g_layer(cfg, p, x, w, noise, up: bool, mode: str):
    """A modulated 3x3 conv (up=2 for ``up``), demodulated, plus the noise
    plane ``[B, r, r, 1]`` times its strength, bias, leaky ReLU with gain
    sqrt(2) and the clamp."""
    cd = _cd(mode)
    styles = _fc(p["affine"], w.float())
    weight = p["weight"]
    dco = torch.rsqrt(styles.square()
                      @ weight.float().square().sum(dim=(2, 3)).t() + 1e-8)
    xm = x.to(cd) * styles.to(cd)[:, :, None, None]
    if up:
        y = upsample_conv(_q(xm, mode), _q(weight, mode),
                          _fir_filter(cfg, x.device, cd))
    else:
        y = F.conv2d(_q(xm, mode), _q(weight, mode), padding=1)
    y = y.to(cd) * dco.to(cd)[:, :, None, None]
    y = y + (noise.permute(0, 3, 1, 2) * p["noise_strength"]).to(cd)
    y = _lrelu(y + p["bias"].to(cd)[None, :, None, None])
    c = cfg["conv_clamp"]
    return y.clamp(-c, c)


def mapped_ws(cfg, gp, z, mixing: Optional[Dict], mixing_prob: float,
              prec: Dict):
    """``[B, num_ws, w_dim]`` styles of ``z``; with ``mixing_prob`` > 0 the
    layers from a cutoff on take the styles of ``mixing['z2']``: the cutoff
    is ``1 + floor(cutoff_u * (num_ws - 1))`` where ``apply_u`` lies under
    the probability, else there is none."""
    md = _cd(prec["mapping"])
    n = num_ws(cfg)
    ws = mapping(cfg, gp, z, md).float()[:, None].expand(-1, n, -1)
    if mixing_prob > 0:
        ws2 = mapping(cfg, gp, mixing["z2"], md).float()[:, None].expand(
            -1, n, -1)
        cutoff = 1 + torch.floor(mixing["cutoff_u"] * (n - 1))
        cutoff = torch.where(mixing["apply_u"] < mixing_prob, cutoff,
                             torch.full_like(cutoff, float(n)))
        idx = torch.arange(n, device=ws.device)[None, :, None]
        ws = torch.where(idx < cutoff, ws, ws2)
    return ws


def synthesis(cfg, gp, ws, feats: Dict, noise: Dict, prec: Dict):
    """The trunk and the triad head: ``[B, H, W, 3]`` float32 images (the
    stroke colored by the three colors, in [-1, 1])."""
    b = ws.shape[0]
    x, wi = None, 0
    for res in W.block_resolutions(cfg):
        mode = prec["g"][res]
        bp = gp["synthesis"][f"b{res}"]
        if res == 4:
            x = bp["const"].to(_cd(mode))[None].expand(b, -1, -1, -1)
        else:
            x = _g_layer(cfg, bp["conv0"], x, ws[:, wi],
                         noise[f"b{res}.conv0"], True, mode)
            wi += 1
        x = _g_layer(cfg, bp["conv1"], x, ws[:, wi], noise[f"b{res}.conv1"],
                     False, mode)
        wi += 1
        if res == cfg["img_resolution"]:
            uvs, colors = triad_head(cfg, bp["torgb"], x, ws[:, wi],
                                     _cd(mode))
            img = torch.einsum("bkhw,bck->bhwc", uvs, colors)
        if res in feats:
            x = torch.cat([x, feats[res].to(x.dtype)], dim=1)
    return img


def features(cfg, trees, geom):
    """The frozen encoder's features of ``geom [B, H, W, 1]`` (1 =
    background), float32: {trunk resolution: ``[B, C, r, r]``}."""
    with torch.no_grad():
        return encode(cfg, trees["enc_params"], trees["enc_state"],
                      geom.permute(0, 3, 1, 2), torch.float32)


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------

def _d_conv(cfg, p, x, mode: str, down: bool = False, act: bool = True):
    """An equalised-lr conv (down=2 through the 4x4 FIR over a border of
    2, then stride 2), bias, leaky ReLU with gain sqrt(2), the clamp."""
    cd = _cd(mode)
    cin, k = p["weight"].shape[1], p["weight"].shape[2]
    w = p["weight"] * (1.0 / math.sqrt(cin * k * k))
    x = x.to(cd)
    if down:
        c = x.shape[1]
        f = _fir_filter(cfg, x.device, cd)[None, None].expand(c, 1, 4, 4)
        x = F.conv2d(F.pad(x, [2, 2, 2, 2]), f, groups=c)
        y = F.conv2d(_q(x, mode), _q(w, mode), stride=2)
    else:
        y = F.conv2d(_q(x, mode), _q(w, mode), padding=k // 2)
    y = y.to(cd) + p["bias"].to(cd)[None, :, None, None]
    if act:
        y = _lrelu(y)
    c = cfg["conv_clamp"]
    return y.clamp(-c, c)


def _mbstd(x, group: int = 4):
    """Minibatch standard deviation: row i is grouped with rows i + n/g,
    i + 2n/g, ...; one channel appended."""
    n, c, h, w = x.shape
    g = min(group, n)
    y = x.float().reshape(g, n // g, 1, c, h, w)
    y = torch.sqrt((y - y.mean(dim=0)).square().mean(dim=0) + 1e-8)
    y = y.mean(dim=(2, 3, 4)).reshape(n // g, 1, 1, 1).repeat(g, 1, h, w)
    return torch.cat([x, y.to(x.dtype)], dim=1)


def disc(cfg, dp, img, prec: Dict):
    """The 'orig' discriminator: logits ``[B, 1]`` of ``img [B, H, W, 3]``."""
    x = None
    for res in TW.d_block_resolutions(cfg):
        mode = prec["d"][res]
        bp = dp[f"b{res}"]
        if res == cfg["img_resolution"]:
            x = _d_conv(cfg, bp["fromrgb"], img.permute(0, 3, 1, 2), mode)
        x = _d_conv(cfg, bp["conv0"], x, mode)
        x = _d_conv(cfg, bp["conv1"], x, mode, down=True)
    mode = prec["d"][4]
    ep = dp["b4"]
    x = _mbstd(x.to(_cd(mode)))
    x = _d_conv(cfg, ep["conv"], x, mode)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = _fc(ep["fc"], _q(x, mode), act=True)
    return _fc(ep["out"], x).float()


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _unflatten(like, flat, prefix=""):
    return {k: _unflatten(v, flat, f"{prefix}{k}.") if isinstance(v, dict)
            else flat[prefix + k] for k, v in like.items()}


def _grad(loss, flat: Dict):
    gs = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    return {k: (torch.zeros_like(p) if g is None else g.detach())
            for (k, p), g in zip(flat.items(), gs)}


def _trainable(tree):
    flat = {k: v.detach().requires_grad_(True)
            for k, v in _leaves(tree).items()}
    return flat, _unflatten(tree, flat)


def lazy_adam(cfg, interval: int):
    """(lr, beta1, beta2) of Adam under lazy regularisation every
    ``interval`` batches."""
    r = interval / (interval + 1)
    b1, b2 = cfg["adam_betas"]
    return cfg["lr"] * r, b1 ** r, b2 ** r


def adam(cfg, params: Dict, grads: Dict, opt: Dict, interval: int):
    """One Adam step (moments bias-corrected, eps outside the root) on the
    flat trees; returns (new params, new optimizer state)."""
    lr, b1, b2 = lazy_adam(cfg, interval)
    t = opt["count"] + 1
    mu, nu, new = {}, {}, {}
    for k, p in params.items():
        g = torch.nan_to_num(grads[k], nan=0.0, posinf=1e5, neginf=-1e5)
        mu[k] = b1 * opt["mu"][k] + (1 - b1) * g
        nu[k] = b2 * opt["nu"][k] + (1 - b2) * g * g
        step = (mu[k] / (1 - b1 ** t)) / (
            torch.sqrt(nu[k] / (1 - b2 ** t)) + cfg["adam_eps"])
        new[k] = p - lr * step
    return new, {"count": t, "mu": mu, "nu": nu}


def init_state(cfg, trees, ada_p: float) -> Dict:
    """The state the window starts from: the seeded weights, Adam's
    moments at zero, the w-average and path-length mean at zero."""
    g = {k: v.clone() for k, v in _leaves(trees["gen_params"]).items()}
    d = {k: v.clone() for k, v in _leaves(trees["disc_params"]).items()}
    zero = torch.zeros((), device=next(iter(g.values())).device)

    def opt(p):
        return {"count": 0, "mu": {k: torch.zeros_like(v)
                                   for k, v in p.items()},
                "nu": {k: torch.zeros_like(v) for k, v in p.items()}}
    return {"like": {"g": trees["gen_params"], "d": trees["disc_params"]},
            "g": g, "d": d, "g_opt": opt(g), "d_opt": opt(d),
            "w_avg": torch.zeros(cfg["w_dim"], device=zero.device),
            "pl_mean": zero.clone(), "ada_p": zero + ada_p,
            "ada_signs": zero.clone(), "ada_count": 0}


def generate(cfg, gp, z, feats, gd: Dict, prec: Dict):
    """(images ``[B, H, W, 3]``, ws) of a training phase's generator pass:
    style mixing at the configuration's probability and random noise."""
    ws = mapped_ws(cfg, gp, z, gd["mixing"], cfg["style_mixing_prob"], prec)
    return synthesis(cfg, gp, ws, feats, gd["noise"], prec), ws


class Knobs:
    """The reference as it runs (all defaults), or a control of it:
    ``prec`` a precision policy, ``r1_second_order`` False drops R1's
    second-order term, ``pl_rows`` runs Gpl on that many rows, and
    ``skip_warp`` leaves ADA's warp out."""

    def __init__(self, prec: Dict, r1_second_order: bool = True,
                 pl_rows: Optional[int] = None, skip_warp: bool = False):
        self.prec = prec
        self.r1_second_order = r1_second_order
        self.pl_rows = pl_rows
        self.skip_warp = skip_warp


def _d_on(cfg, dp, img, draws, p, knobs, keep=None):
    """D's logits of ``img`` through the pipe; ``keep(aug)`` sees the
    augmented images."""
    aug = A.augment(draws, img, p, knobs.skip_warp)
    if keep is not None:
        keep(aug.detach())
    return disc(cfg, dp, aug, knobs.prec)


def d_main(cfg, st, real, feats, z, dr, knobs, keep=None):
    with torch.no_grad():
        fake, _ = generate(cfg, _unflatten(st["like"]["g"], st["g"]), z,
                           feats, dr["g"], knobs.prec)
    flat, dp = _trainable(_unflatten(st["like"]["d"], st["d"]))
    fl = _d_on(cfg, dp, fake, dr["aug_fake"], st["ada_p"], knobs)
    rl = _d_on(cfg, dp, real, dr["aug_real"], st["ada_p"], knobs, keep)
    loss = F.softplus(fl).mean() + F.softplus(-rl).mean()
    grads = _grad(loss, flat)
    new, opt = adam(cfg, st["d"], grads, st["d_opt"], cfg["d_reg_interval"])
    st = dict(st, d=new, d_opt=opt,
              ada_signs=st["ada_signs"] + torch.sign(rl.detach()).sum(),
              ada_count=st["ada_count"] + rl.shape[0])
    return st, loss.detach(), grads


def d_r1(cfg, st, real, dr, knobs, keep=None):
    flat, dp = _trainable(_unflatten(st["like"]["d"], st["d"]))
    x = real.detach().requires_grad_(True)
    logits = _d_on(cfg, dp, x, dr["aug"], st["ada_p"], knobs, keep)
    (g,) = torch.autograd.grad(logits.sum(), x,
                               create_graph=knobs.r1_second_order)
    penalty = g.square().sum(dim=(1, 2, 3))
    loss = penalty.mean() * (cfg["r1_gamma"] / 2) * cfg["d_reg_interval"]
    grads = _grad(loss, flat) if loss.requires_grad else \
        {k: torch.zeros_like(v) for k, v in flat.items()}
    new, opt = adam(cfg, st["d"], grads, st["d_opt"], cfg["d_reg_interval"])
    return dict(st, d=new, d_opt=opt), loss.detach(), grads


def g_main(cfg, st, feats, z, dr, knobs, keep=None):
    flat, gp = _trainable(_unflatten(st["like"]["g"], st["g"]))
    img, ws = generate(cfg, gp, z, feats, dr["g"], knobs.prec)
    if keep is not None:
        keep(img.detach())
    w = ws[:, 0].detach()
    mean = w.mean(dim=0)
    w_avg = mean + (st["w_avg"] - mean) * 0.995
    dp = _unflatten(st["like"]["d"], st["d"])
    logits = _d_on(cfg, dp, img, dr["aug"], st["ada_p"], knobs)
    loss = F.softplus(-logits).mean()
    grads = _grad(loss, flat)
    new, opt = adam(cfg, st["g"], grads, st["g_opt"], cfg["g_reg_interval"])
    return dict(st, g=new, g_opt=opt, w_avg=w_avg), loss.detach(), grads


def g_pl(cfg, st, feats, z, dr, knobs):
    rows = knobs.pl_rows or z.shape[0] // cfg["pl_batch_shrink"]
    flat, gp = _trainable(_unflatten(st["like"]["g"], st["g"]))
    gd = dr["g"]
    mixing = {k: v[:rows] if v.dim() else v
              for k, v in gd["mixing"].items()}
    ws = mapped_ws(cfg, gp, z[:rows], mixing, cfg["style_mixing_prob"],
                   knobs.prec)
    ws = ws + 0.0     # a tensor of its own, the gradient's target
    img = synthesis(cfg, gp, ws, {r: f[:rows] for r, f in feats.items()},
                    {k: v[:rows] for k, v in gd["noise"].items()},
                    knobs.prec)
    noise = dr["pl_noise"][:rows] / math.sqrt(img.shape[1] * img.shape[2])
    (g,) = torch.autograd.grad((img * noise).sum(), ws, create_graph=True)
    lengths = torch.sqrt(g.square().sum(dim=2).mean(dim=1))
    pl_mean = st["pl_mean"] + cfg["pl_decay"] * (lengths.mean()
                                                 - st["pl_mean"])
    loss = (lengths - pl_mean).square().mean() * cfg["pl_weight"] \
        * cfg["g_reg_interval"]
    grads = _grad(loss, flat)
    new, opt = adam(cfg, st["g"], grads, st["g_opt"], cfg["g_reg_interval"])
    return dict(st, g=new, g_opt=opt, pl_mean=pl_mean.detach()), \
        loss.detach(), grads


def ada_adjust(cfg, st, batch: int):
    """ADA's p: one step of ``batch * ada_interval / (ada_kimg * 1000)``
    towards the real logits' mean sign reaching ``ada_target``."""
    sign = st["ada_signs"] / max(st["ada_count"], 1)
    step = torch.sign(sign - cfg["ada_target"]) * (
        batch * cfg["ada_interval"] / (cfg["ada_kimg"] * 1000.0))
    return dict(st, ada_p=torch.clamp_min(st["ada_p"] + step, 0.0),
                ada_signs=torch.zeros_like(st["ada_signs"]), ada_count=0)


def follow(cfg, trees, batches: List[Dict], first_batch: int, ada_p: float,
           knobs: Knobs) -> Dict:
    """Run the batches the program ran, from the seeded weights, and
    return what the check compares: every phase's loss (``loss``, by
    ``"<phase>.<batch>"``), each phase's gradient at its first call
    (``grad``), the parameters' change over the batches (``change``, 'G'
    and 'D'), the w-average after them, the real images as the pipe
    augmented them for D (``aug``: ``"Dmain.<batch>"``, ``"Dr1.<batch>"``)
    and Gmain's images (``img``, by ``"Gmain.<batch>"``).

    ``batches[k]``: ``real [B, H, W, 3]``, ``geom [B, H, W, 1]``, the
    latents ``z`` by phase and the ``draws`` by phase (``Dmain``: 'g',
    'aug_fake', 'aug_real'; ``Dr1``: 'aug'; ``Gmain``: 'g', 'aug';
    ``Gpl``: 'g', 'pl_noise')."""
    st = init_state(cfg, trees, ada_p)
    start_g, start_d = st["g"], st["d"]
    out = {"loss": {}, "grad": {}, "aug": {}, "img": {}}

    def keep(group, key):
        return lambda t: group.__setitem__(key, t)
    for k, b in enumerate(batches):
        idx = first_batch + k
        feats = features(cfg, trees, b["geom"])
        st, loss, grads = d_main(cfg, st, b["real"], feats, b["z"]["Dmain"],
                                 b["draws"]["Dmain"], knobs,
                                 keep(out["aug"], f"Dmain.{k}"))
        out["loss"][f"Dmain.{k}"] = float(loss)
        out["grad"].setdefault("Dmain", grads)
        if idx % cfg["d_reg_interval"] == 0:
            st, loss, grads = d_r1(cfg, st, b["real"], b["draws"]["Dr1"],
                                   knobs, keep(out["aug"], f"Dr1.{k}"))
            out["loss"][f"Dr1.{k}"] = float(loss)
            out["grad"].setdefault("Dr1", grads)
        st, loss, grads = g_main(cfg, st, feats, b["z"]["Gmain"],
                                 b["draws"]["Gmain"], knobs,
                                 keep(out["img"], f"Gmain.{k}"))
        out["loss"][f"Gmain.{k}"] = float(loss)
        out["grad"].setdefault("Gmain", grads)
        if idx % cfg["g_reg_interval"] == 0:
            st, loss, grads = g_pl(cfg, st, feats, b["z"]["Gpl"],
                                   b["draws"]["Gpl"], knobs)
            out["loss"][f"Gpl.{k}"] = float(loss)
            out["grad"].setdefault("Gpl", grads)
        if idx % cfg["ada_interval"] == 0 and idx > 0:
            st = ada_adjust(cfg, st, b["real"].shape[0])
    out["change"] = {"G": {k: st["g"][k] - start_g[k] for k in start_g},
                     "D": {k: st["d"][k] - start_d[k] for k in start_d}}
    out["w_avg"] = st["w_avg"]
    return out


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------

def _norms(tree: Dict) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def worst_leaf_gap(got: Dict, want: Dict, keep=None) -> float:
    """The largest gap between a leaf's norm in ``got`` and in ``want``,
    over the larger of the reference leaf's norm and the median leaf's."""
    g, w = _norms(got), _norms(want)
    med = statistics.median(w.values())
    keys = [k for k in w if keep is None or k in keep]
    if set(g) != set(w):
        return float("inf")
    return max((abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in keys),
               default=0.0)


def tree_distance(got: Dict, want: Dict) -> float:
    """The norm of the difference of two trees over the reference tree's
    norm, all leaves as one vector: the gradient's direction and size,
    where the worst leaf's norm sees neither."""
    if set(got) != set(want):
        return float("inf")
    diff = sum(float(torch.linalg.vector_norm((got[k] - want[k]).double()))
               ** 2 for k in want)
    ref = sum(float(torch.linalg.vector_norm(want[k].double())) ** 2
              for k in want)
    return (diff / max(ref, 1e-300)) ** 0.5


def image_gaps(got: Dict, want: Dict) -> Dict[str, float]:
    """``|got - want| / |want|`` (norms over all values) of each image
    batch of ``want``; infinite where ``got`` lacks it or holds it at
    another shape."""
    out = {}
    for k, w in want.items():
        g = got.get(k)
        if g is None or g.shape != w.shape:
            out[k] = float("inf")
            continue
        w = w.double()
        out[k] = float(torch.linalg.vector_norm(g.double() - w)
                       / torch.linalg.vector_norm(w))
    return out


def leaf_table(got: Dict, want: Dict) -> Dict[str, list]:
    """Per leaf: [gap of the norms over the larger of the reference leaf's
    norm and the median leaf's, the norm of the difference over the
    reference leaf's norm, the reference leaf's norm over the median's]."""
    g, w = _norms(got), _norms(want)
    med = statistics.median(w.values())
    return {k: [abs(g[k] - w[k]) / max(w[k], med, 1e-30),
                float(torch.linalg.vector_norm((got[k] - want[k]).double()))
                / max(w[k], 1e-30), w[k] / max(med, 1e-30)]
            for k in w if k in g}


def moved_leaves(grads: List[Dict], share: float = 1e-3):
    """The leaves whose reference gradient, in some phase, reaches
    ``share`` of that phase's median leaf's; the others move under Adam
    by round-off alone."""
    keep = set()
    for tree in grads:
        n = _norms(tree)
        med = statistics.median(n.values())
        keep |= {k for k, v in n.items() if v >= share * med}
    return keep


def compare(got: Dict, want: Dict) -> Dict[str, float]:
    """The compared numbers: per phase the worst relative gap of its loss
    over the batches (``loss_gap.<phase>``), the worst leaf's gap of its
    first gradient's norm (``grad_gap.<phase>``) and that gradient's
    distance over the whole tree (``grad_diff.<phase>``); the worst moved
    leaf's gap of the change's norm over the batches (``change_gap.G``,
    ``change_gap.D``); the w-average's relative distance (``w_avg_gap``);
    and the worst relative distance of the augmented reals, which ADA's
    warp makes (``aug_gap``).  Gmain's images (``image_gaps``) are not
    compared: the program's bf16 blocks read up to half what the control
    in float8 does across seeds (``PERF.md``)."""
    out = {}
    for ph in PHASES:
        keys = [k for k in want["loss"] if k.split(".")[0] == ph]
        if any(k not in got["loss"] for k in keys):
            out[f"loss_gap.{ph}"] = float("inf")
            continue
        out[f"loss_gap.{ph}"] = max(
            abs(got["loss"][k] - want["loss"][k]) / max(abs(want["loss"][k]),
                                                        1e-12)
            for k in keys)
    for ph in PHASES:
        out[f"grad_gap.{ph}"] = worst_leaf_gap(got["grad"][ph],
                                               want["grad"][ph]) \
            if ph in got["grad"] else float("inf")
        out[f"grad_diff.{ph}"] = tree_distance(got["grad"][ph],
                                               want["grad"][ph]) \
            if ph in got["grad"] else float("inf")
    keep = {"G": moved_leaves([want["grad"]["Gmain"], want["grad"]["Gpl"]]),
            "D": moved_leaves([want["grad"]["Dmain"], want["grad"]["Dr1"]])}
    for net in ("G", "D"):
        out[f"change_gap.{net}"] = worst_leaf_gap(
            got["change"][net], want["change"][net], keep[net])
    wa = want["w_avg"].double()
    out["w_avg_gap"] = float(torch.linalg.vector_norm(
        got["w_avg"].double() - wa) / torch.linalg.vector_norm(wa))
    out["aug_gap"] = max(image_gaps(got["aug"], want["aug"]).values())
    return out

