"""Plain PyTorch reference of StyleGAN2 config-f's training (Karras et al.
2020; the StyleGAN2-ADA code's ``training/networks.py`` and
``training/loss.py``, read and not imported): the 'skip' generator with
a toRGB layer at every block and the running image FIR-upsampled, the
'resnet' discriminator with minibatch-stddev, and the four phases of a
batch (Dmain, Dr1, Gmain, Gpl) with Adam under lazy regularisation, the
w-average, the path-length mean and ADA's adjustment.  It imports nothing
of the program.

It shares with ``reference/train.py`` (NeuBE's training) the mapping and
style mixing, D's convolutions at stride 1, minibatch-stddev, Adam, the
precision policies and the comparison, and writes the layers that resample
with its own FIR (:func:`fir`); the layout of the
parameter trees is ``neube_bench/configf_weights.py``'s.  Images are NHWC
at the edges, NCHW inside.  Every random number is an input (``draws``),
as there.

Departures from ``networks.py`` / ``loss.py`` that the program makes and
this reference follows: ADA's warp is the two-pass warp of
``reference/augment.py``; the reduced-precision blocks run in bfloat16, not
float16 (so no fp16 pre-normalisation of styles and weights, which leaves
the result unchanged in exact arithmetic); the modulated convolutions are
the unfused form that ``networks.py`` trains with (``fused_modconv``
False); the 'resnet' block's ``conv1`` at gain sqrt(0.5) is written as
the gain-1 layer scaled by sqrt(0.5), which the leaky ReLU's and the
clamp's homogeneity make the same; the generator's noise strengths are
not zero (random weights, ``configs/*.json``'s ``assumed``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from neube_bench import train_weights as TW
from neube_bench import weights as W
from neube_bench.reference import augment as A
from neube_bench.reference import train as RT
from neube_bench.reference.model import _fc, _fir_filter, _lrelu

SQRT_HALF = math.sqrt(0.5)


# ---------------------------------------------------------------------------
# The FIR
# ---------------------------------------------------------------------------

def fir(cfg, x, pad, gain: float = 1.0):
    """The 4x4 FIR (``resample_taps``' outer product, symmetric, so
    convolution and correlation agree) over a zero border ``pad`` (left,
    right, top, bottom), VALID: sixteen weighted shifted slices summed in
    float32, in ``x``'s dtype.  Written so rather than as a depthwise
    convolution, whose second derivative autograd takes by a convolution
    with the image as its filter: the R1 and path-length steps' seconds
    at 1024 px."""
    f = _fir_filter(cfg, "cpu", torch.float64) * gain
    xp = F.pad(x, list(pad))
    h, w = xp.shape[-2] - 3, xp.shape[-1] - 3
    y = sum(xp[:, :, i:i + h, j:j + w].float() * float(f[i, j])
            for i in range(4) for j in range(4))
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Generator ('skip')
# ---------------------------------------------------------------------------

def _upsample_conv(cfg, x, w):
    """StyleGAN2's up=2 conv of a 3x3 kernel (``reference/model.py:
    upsample_conv`` with the FIR above): zeros between the pixels, a true
    convolution with ``w`` over a border of 3, the FIR with gain 4."""
    b, c, h, wd = x.shape
    z = x.new_zeros(b, c, 2 * h - 1, 2 * wd - 1)
    z[:, :, ::2, ::2] = x
    y = F.conv2d(F.pad(z, [3, 3, 3, 3]), w.flip([2, 3]))
    return fir(cfg, y, (0, 0, 0, 0), 4.0)


def _g_layer(cfg, p, x, w, noise, up: bool, mode: str):
    """``reference/train.py:_g_layer`` (a modulated 3x3 conv, up=2 for
    ``up``, demodulated, noise, bias, leaky ReLU, clamp) with this file's
    up-sampling convolution."""
    cd = RT._cd(mode)
    styles = _fc(p["affine"], w.float())
    weight = p["weight"]
    dco = torch.rsqrt(styles.square()
                      @ weight.float().square().sum(dim=(2, 3)).t() + 1e-8)
    xm = RT._q(x.to(cd) * styles.to(cd)[:, :, None, None], mode)
    if up:
        y = _upsample_conv(cfg, xm, RT._q(weight, mode))
    else:
        y = F.conv2d(xm, RT._q(weight, mode), padding=1)
    y = y.to(cd) * dco.to(cd)[:, :, None, None]
    y = y + (noise.permute(0, 3, 1, 2) * p["noise_strength"]).to(cd)
    y = _lrelu(y + p["bias"].to(cd)[None, :, None, None])
    c = cfg["conv_clamp"]
    return y.clamp(-c, c)


def _torgb(cfg, p, x, w, mode: str):
    """StyleGAN2's ToRGBLayer: a modulated 1x1 conv without demodulation
    (styles scaled by 1 / sqrt(in)), bias, the clamp; float32."""
    cd = RT._cd(mode)
    styles = _fc(p["affine"], w.float()) / math.sqrt(p["weight"].shape[1])
    xm = x.to(cd) * styles.to(cd)[:, :, None, None]
    y = F.conv2d(RT._q(xm, mode), RT._q(p["weight"], mode)).to(cd)
    y = y + p["bias"].to(cd)[None, :, None, None]
    c = cfg["conv_clamp"]
    return y.clamp(-c, c).float()


def upsample_image(cfg, img):
    """``upfirdn2d.upsample2d``: zeros after every pixel, a border of 2
    before and 1 after, the 4x4 FIR with gain 4: ``[B, 3, H, W]`` ->
    ``[B, 3, 2H, 2W]``, float32."""
    b, c, h, w = img.shape
    z = img.new_zeros(b, c, 2 * h, 2 * w)
    z[:, :, ::2, ::2] = img
    return fir(cfg, z, (2, 1, 2, 1), 4.0)


def synthesis(cfg, gp, ws, noise: Dict, prec: Dict):
    """The 'skip' trunk: every block's toRGB added to the running image,
    which is up-sampled before each block's is added; ``[B, H, W, 3]``
    float32.  Block ``r``'s toRGB takes the style of the next block's
    first layer (``networks.py``'s ``block_ws``)."""
    b = ws.shape[0]
    x = img = None
    wi = 0
    for res in W.block_resolutions(cfg):
        mode = prec["g"][res]
        bp = gp["synthesis"][f"b{res}"]
        if res == 4:
            x = bp["const"].to(RT._cd(mode))[None].expand(b, -1, -1, -1)
        else:
            x = _g_layer(cfg, bp["conv0"], x, ws[:, wi],
                         noise[f"b{res}.conv0"], True, mode)
            wi += 1
        x = _g_layer(cfg, bp["conv1"], x, ws[:, wi], noise[f"b{res}.conv1"],
                     False, mode)
        wi += 1
        if img is not None:
            img = upsample_image(cfg, img)
        y = _torgb(cfg, bp["torgb"], x, ws[:, wi], mode)
        img = y if img is None else img + y
    return img.permute(0, 2, 3, 1)


def generate(cfg, gp, z, gd: Dict, prec: Dict):
    """(images ``[B, H, W, 3]``, ws) of a training phase's generator pass,
    style mixing at the configuration's probability."""
    ws = RT.mapped_ws(cfg, gp, z, gd["mixing"], cfg["style_mixing_prob"],
                      prec)
    return synthesis(cfg, gp, ws, gd["noise"], prec), ws


# ---------------------------------------------------------------------------
# Discriminator ('resnet')
# ---------------------------------------------------------------------------

def _d_down(cfg, p, x, mode: str):
    """``reference/train.py:_d_conv`` down=2 (the FIR over a border of 2,
    then a 3x3 conv at stride 2, bias, leaky ReLU, the clamp) with this
    file's FIR."""
    cd = RT._cd(mode)
    w = p["weight"] * (1.0 / math.sqrt(p["weight"][0].numel()))
    x = fir(cfg, x.to(cd), (2, 2, 2, 2))
    y = F.conv2d(RT._q(x, mode), RT._q(w, mode), stride=2).to(cd)
    y = _lrelu(y + p["bias"].to(cd)[None, :, None, None])
    c = cfg["conv_clamp"]
    return y.clamp(-c, c)


def _skip(cfg, p, x, mode: str):
    """The 1x1 skip down=2, without bias or activation, at gain sqrt(0.5):
    the 4x4 FIR over a border of 1, every second pixel, then the conv."""
    cd = RT._cd(mode)
    w = p["weight"] * (SQRT_HALF / math.sqrt(p["weight"].shape[1]))
    x = fir(cfg, x.to(cd), (1, 1, 1, 1))[:, :, ::2, ::2]
    return F.conv2d(RT._q(x, mode), RT._q(w, mode)).to(cd)


def disc(cfg, dp, img, prec: Dict):
    """The 'resnet' discriminator: logits ``[B, 1]`` of ``img [B, H, W,
    3]``."""
    x = None
    for res in TW.d_block_resolutions(cfg):
        mode = prec["d"][res]
        bp = dp[f"b{res}"]
        if res == cfg["img_resolution"]:
            x = RT._d_conv(cfg, bp["fromrgb"], img.permute(0, 3, 1, 2), mode)
        y = _skip(cfg, bp["skip"], x, mode)
        t = RT._d_conv(cfg, bp["conv0"], x, mode)
        t = _d_down(cfg, bp["conv1"], t, mode) * SQRT_HALF
        x = y + t
    mode = prec["d"][4]
    ep = dp["b4"]
    x = RT._mbstd(x.to(RT._cd(mode)), cfg["mbstd_group"])
    x = RT._d_conv(cfg, ep["conv"], x, mode)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = _fc(ep["fc"], RT._q(x, mode), act=True)
    return _fc(ep["out"], x).float()


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def augment(draws, img, p, skip_warp: bool):
    """``reference/augment.py``'s pipe one row at a time (every draw and
    every transform is the row's own): its dense two-pass warp holds
    ``[B, N, N, N]`` weights, 16 GB per pass at four 1024-px rows."""
    return torch.cat([A.augment({k: v[i:i + 1] for k, v in draws.items()},
                                img[i:i + 1], p, skip_warp)
                      for i in range(img.shape[0])])


def _d_on(cfg, dp, img, draws, p, knobs, keep=None):
    aug = augment(draws, img, p, knobs.skip_warp)
    if keep is not None:
        keep(aug.detach())
    return disc(cfg, dp, aug, knobs.prec)


def _g(st):
    return RT._unflatten(st["like"]["g"], st["g"])


def _d(st):
    return RT._unflatten(st["like"]["d"], st["d"])


def d_main(cfg, st, real, z, dr, knobs, keep=None):
    with torch.no_grad():
        fake, _ = generate(cfg, _g(st), z, dr["g"], knobs.prec)
    flat, dp = RT._trainable(_d(st))
    fl = _d_on(cfg, dp, fake, dr["aug_fake"], st["ada_p"], knobs)
    rl = _d_on(cfg, dp, real, dr["aug_real"], st["ada_p"], knobs, keep)
    loss = F.softplus(fl).mean() + F.softplus(-rl).mean()
    grads = RT._grad(loss, flat)
    new, opt = RT.adam(cfg, st["d"], grads, st["d_opt"],
                       cfg["d_reg_interval"])
    st = dict(st, d=new, d_opt=opt,
              ada_signs=st["ada_signs"] + torch.sign(rl.detach()).sum(),
              ada_count=st["ada_count"] + rl.shape[0])
    return st, loss.detach(), grads


def d_r1(cfg, st, real, dr, knobs, keep=None):
    flat, dp = RT._trainable(_d(st))
    x = real.detach().requires_grad_(True)
    logits = _d_on(cfg, dp, x, dr["aug"], st["ada_p"], knobs, keep)
    (g,) = torch.autograd.grad(logits.sum(), x,
                               create_graph=knobs.r1_second_order)
    loss = g.square().sum(dim=(1, 2, 3)).mean() * (cfg["r1_gamma"] / 2) \
        * cfg["d_reg_interval"]
    grads = RT._grad(loss, flat) if loss.requires_grad else \
        {k: torch.zeros_like(v) for k, v in flat.items()}
    new, opt = RT.adam(cfg, st["d"], grads, st["d_opt"],
                       cfg["d_reg_interval"])
    return dict(st, d=new, d_opt=opt), loss.detach(), grads


def g_main(cfg, st, z, dr, knobs, keep=None):
    flat, gp = RT._trainable(_g(st))
    img, ws = generate(cfg, gp, z, dr["g"], knobs.prec)
    if keep is not None:
        keep(img.detach())
    mean = ws[:, 0].detach().mean(dim=0)
    w_avg = mean + (st["w_avg"] - mean) * 0.995
    logits = _d_on(cfg, _d(st), img, dr["aug"], st["ada_p"], knobs)
    loss = F.softplus(-logits).mean()
    grads = RT._grad(loss, flat)
    new, opt = RT.adam(cfg, st["g"], grads, st["g_opt"],
                       cfg["g_reg_interval"])
    return dict(st, g=new, g_opt=opt, w_avg=w_avg), loss.detach(), grads


def g_pl(cfg, st, z, dr, knobs):
    rows = knobs.pl_rows or z.shape[0] // cfg["pl_batch_shrink"]
    flat, gp = RT._trainable(_g(st))
    gd = dr["g"]
    mixing = {k: v[:rows] if v.dim() else v
              for k, v in gd["mixing"].items()}
    ws = RT.mapped_ws(cfg, gp, z[:rows], mixing, cfg["style_mixing_prob"],
                      knobs.prec)
    ws = ws + 0.0     # a tensor of its own, the gradient's target
    img = synthesis(cfg, gp, ws, {k: v[:rows] for k, v in gd["noise"].items()},
                    knobs.prec)
    noise = dr["pl_noise"][:rows] / math.sqrt(img.shape[1] * img.shape[2])
    (g,) = torch.autograd.grad((img * noise).sum(), ws, create_graph=True)
    lengths = torch.sqrt(g.square().sum(dim=2).mean(dim=1))
    pl_mean = st["pl_mean"] + cfg["pl_decay"] * (lengths.mean()
                                                 - st["pl_mean"])
    loss = (lengths - pl_mean).square().mean() * cfg["pl_weight"] \
        * cfg["g_reg_interval"]
    grads = RT._grad(loss, flat)
    new, opt = RT.adam(cfg, st["g"], grads, st["g_opt"],
                       cfg["g_reg_interval"])
    return dict(st, g=new, g_opt=opt, pl_mean=pl_mean.detach()), \
        loss.detach(), grads


def follow(cfg, trees, batches: List[Dict], first_batch: int, ada_p: float,
           knobs: RT.Knobs) -> Dict:
    """Run the batches the program ran, from the seeded weights, and return
    what ``reference/train.py:compare`` compares (``reference/train.py:
    follow``'s keys), and under ``steps`` each step as ``step_numbers``
    takes it: (batch, phase, state before, state after, loss).
    ``batches[k]``: ``real [B, H, W, 3]``, the latents
    ``z`` by phase and the ``draws`` by phase.  Each phase's graph is freed
    before the next is built, so the peak is one phase's."""
    st = RT.init_state(cfg, trees, ada_p)
    start_g, start_d = st["g"], st["d"]
    out = {"loss": {}, "grad": {}, "aug": {}, "img": {}, "steps": []}

    def keep(group, key):
        return lambda t: group.__setitem__(key, t)

    def run(ph, k, *args):
        nonlocal st
        before = st
        st, loss, grads = PHASES[ph](cfg, st, *args)
        out["loss"][f"{ph}.{k}"] = float(loss)
        out["grad"].setdefault(ph, grads)
        out["steps"].append((k, ph, before, st, float(loss)))

    for k, b in enumerate(batches):
        idx = first_batch + k
        dr, z = b["draws"], b["z"]
        run("Dmain", k, b["real"], z["Dmain"], dr["Dmain"], knobs,
            keep(out["aug"], f"Dmain.{k}"))
        if idx % cfg["d_reg_interval"] == 0:
            run("Dr1", k, b["real"], dr["Dr1"], knobs,
                keep(out["aug"], f"Dr1.{k}"))
        run("Gmain", k, z["Gmain"], dr["Gmain"], knobs,
            keep(out["img"], f"Gmain.{k}"))
        if idx % cfg["g_reg_interval"] == 0:
            run("Gpl", k, z["Gpl"], dr["Gpl"], knobs)
        if idx % cfg["ada_interval"] == 0 and idx > 0:
            st = RT.ada_adjust(cfg, st, b["real"].shape[0])
    out["change"] = {"G": {k: st["g"][k] - start_g[k] for k in start_g},
                     "D": {k: st["d"][k] - start_d[k] for k in start_d}}
    out["w_avg"] = st["w_avg"]
    return out


PHASES = {"Dmain": d_main, "Dr1": d_r1, "Gmain": g_main, "Gpl": g_pl}


def _phase_args(ph, b, knobs):
    dr = b["draws"][ph]
    if ph == "Dr1":
        return b["real"], dr, knobs
    if ph == "Dmain":
        return b["real"], b["z"][ph], dr, knobs
    return b["z"][ph], dr, knobs


def step_numbers(cfg, batches: List[Dict], steps: List, knobs: RT.Knobs
                 ) -> Dict[str, float]:
    """Each step of a run taken again by the reference from the state that
    run took it from (``steps``: (batch, phase, state before, state
    after, loss), ``follow``'s form): per phase the worst relative gap of
    the loss (``step_loss_gap.<phase>``), and per network the worst gap of
    a moved leaf's update norm (``step_change_gap.G``, ``.D``, as
    ``reference/train.py:compare``'s ``change_gap``).  Each step starts
    from the same weights and Adam moments on both sides, so a gap does not
    grow with the distance between the two trajectories: Adam's sign-like
    first steps from zero moments move every weight by about the learning
    rate and carry D's logits to tens within two batches, and the
    trajectories' losses and changes part on some seeds as far as those of
    a state left unchanged do."""
    out = {}
    for k, ph, before, after, loss in steps:
        net = "d" if ph.startswith("D") else "g"
        st, want, grads = PHASES[ph](cfg, before,
                                     *_phase_args(ph, batches[k], knobs))
        want = float(want)
        key = f"step_loss_gap.{ph}"
        out[key] = max(out.get(key, 0.0),
                       abs(loss - want) / max(abs(want), 1e-12))
        key = f"step_change_gap.{net.upper()}"
        out[key] = max(out.get(key, 0.0), RT.worst_leaf_gap(
            {n: after[net][n] - v for n, v in before[net].items()},
            {n: st[net][n] - v for n, v in before[net].items()},
            RT.moved_leaves([grads])))
        del st, grads
    return out
