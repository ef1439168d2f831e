"""Plain PyTorch reference of the NeuBE painting engine's forward pass.

Written from the published description (StyleGAN2's synthesis with
modulated convolutions, the NeuBE geometry encoder and color-triad head) in
plain ``torch`` operations, NCHW, with no kernel, cache or batching trick
of the program under test; it imports nothing of the program.  It reads the
parameter tree that ``neube_bench/weights.py`` lays out.

``dtype`` is the precision the whole pass runs in: float32 (with TF32 off,
which the caller sets) for the reference, bfloat16 for the control.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from neube_bench import weights as W

SQRT2 = math.sqrt(2.0)


def _lrelu(x, slope=0.2, gain=SQRT2):
    return torch.where(x >= 0, x, x * slope) * gain


def _fc(p, x, lr_mult=1.0, act=False):
    w = p["weight"].to(x.dtype) * (lr_mult / math.sqrt(p["weight"].shape[1]))
    y = x @ w.t() + (p["bias"] * lr_mult).to(x.dtype)
    return _lrelu(y) if act else y


def mapping(cfg, params, z, dtype):
    """z ``[B, z_dim]`` -> w ``[B, w_dim]``: 2nd-moment normalisation and
    ``mapping_layers`` equalised-lr FC layers at lr multiplier 0.01."""
    x = z.to(dtype)
    x = x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + 1e-8)
    for i in range(cfg["mapping_layers"]):
        x = _fc(params["mapping"][f"fc{i}"], x, 0.01, act=True)
    return x


def wrapped_noise(tex, positions, img_res):
    """Bilinear read of the ``[R, R]`` texture circularly shifted by the
    patch position (period ``R - 1``, the '+1' tap reading texel ``R - 1``
    itself): ``[B, 1, R, R]``.  ``positions`` ``[B, 2]`` (y, x)."""
    r = tex.shape[0]
    p = r - 1
    pos = positions.to(tex.device, torch.float32)
    norm = torch.remainder(pos, img_res) / torch.full_like(pos, img_res - 1.0)
    shift = torch.remainder(norm, 1.0) * p
    k = torch.floor(shift)
    frac = shift - k
    k = k.long()
    t = torch.arange(r, device=tex.device)
    ia = torch.remainder(k[:, :1] + t, p)          # rows of the transposed
    ja = torch.remainder(k[:, 1:] + t, p)
    m = tex.float().t()
    fy = frac[:, 0, None, None]
    fx = frac[:, 1, None, None]

    def at(di, dj):
        return m[(ia + di)[:, :, None], (ja + dj)[:, None, :]]

    out = ((1 - fy) * (1 - fx) * at(0, 0) + (1 - fy) * fx * at(0, 1)
           + fy * (1 - fx) * at(1, 0) + fy * fx * at(1, 1))
    return out[:, None]


def _fir_filter(cfg, device, dtype):
    taps = torch.tensor(cfg["resample_taps"], dtype=torch.float64)
    f = torch.outer(taps, taps)
    return (f / f.sum()).to(device, dtype)


def upsample_conv(x, w, f):
    """StyleGAN2's up=2 conv of a 3x3 kernel: zeros between the pixels,
    a true convolution with ``w`` over a border of 3, then the 4x4 FIR with
    gain 4 (VALID): ``[B, I, H, W]`` -> ``[B, O, 2H, 2W]``."""
    b, c, h, wd = x.shape
    z = x.new_zeros(b, c, 2 * h - 1, 2 * wd - 1)
    z[:, :, ::2, ::2] = x
    z = F.pad(z, [3, 3, 3, 3])
    y = F.conv2d(z, w.flip([2, 3]))
    fw = (f * 4).to(y.dtype)[None, None].repeat(y.shape[1], 1, 1, 1)
    return F.conv2d(y, fw.flip([2, 3]), groups=y.shape[1])


def modulated_layer(cfg, p, x, w, noise, up, dtype):
    """Modulate, convolve (3x3, or up=2), demodulate, add noise and bias,
    leaky ReLU with gain sqrt(2), clamp."""
    styles = _fc(p["affine"], w.to(dtype))                    # [B, I]
    weight = p["weight"].to(dtype)
    wsq = weight.float().square().sum(dim=(2, 3))              # [O, I]
    dco = torch.rsqrt(styles.float().square() @ wsq.t() + 1e-8).to(dtype)
    x = x * styles[:, :, None, None]
    if up:
        x = upsample_conv(x, weight, _fir_filter(cfg, x.device, dtype))
    else:
        x = F.conv2d(x, weight, padding=1)
    x = x * dco[:, :, None, None]
    if noise is not None:
        x = x + (noise * p["noise_strength"]).to(dtype)
    x = _lrelu(x + p["bias"].to(dtype)[None, :, None, None])
    c = cfg["conv_clamp"]
    return x.clamp(-c, c)


def triad_head(cfg, p, x, w, dtype):
    """Color-triad head: 9 colors from the style affine, a modulated 1x1
    conv without demodulation to 3 logits, softmax to (U, V, S).  Returns
    (uvs ``[B, 3, H, W]``, colors ``[B, 3(rgb), 3(slot)]`` in [-1, 1])."""
    scaled = _fc(p["affine"], w.to(dtype))
    colors = torch.tanh(scaled[:, :9] + p["color_bias"].to(dtype))
    styles = scaled[:, 9:] / math.sqrt(p["weight"].shape[1])
    y = F.conv2d(x * styles[:, :, None, None], p["weight"].to(dtype))
    y = (y + p["bias"].to(dtype)[None, :, None, None])
    c = cfg["conv_clamp"]
    y = y.clamp(-c, c).float()
    return torch.softmax(y, dim=1), colors.float().reshape(-1, 3, 3)


def _bn_lrelu(p, s, x):
    inv = torch.rsqrt(s["var"] + 1e-5)
    scale = (p["scale"] * inv).to(x.dtype)[None, :, None, None]
    shift = (p["bias"] - s["mean"] * p["scale"] * inv).to(x.dtype)
    x = x * scale + shift[None, :, None, None]
    return torch.where(x >= 0, x, x * 0.01)


def encode(cfg, params, state, geom, dtype):
    """The 'sauto' geometry encoder in eval mode.  ``geom`` ``[B, 1, H, W]``
    (1 = background) -> {trunk resolution: features ``[B, C, h, w]``}."""
    enc = cfg["encoder"]
    assert enc["preproc"] == "-11inverse"
    x = ((1.0 - geom) * 2.0 - 1.0).to(dtype)
    enc_layers, dec_layers = W.encoder_plan(cfg)
    n_down = len(enc["down_filters"])
    for i, (name, _ci, _co, k) in enumerate(enc_layers):
        p, s = params["encoder"][name], state["encoder"][name]
        pad = k // 2
        stride = 2 if 1 <= i <= n_down else 1
        x = F.pad(x, [pad] * 4, mode="reflect")
        x = F.conv2d(x, p["conv"]["weight"].to(dtype), stride=stride)
        x = _bn_lrelu(p["bn"], s["bn"],
                      x + p["conv"]["bias"].to(dtype)[None, :, None, None])
    outs = [x]
    for r in range(1, max(cfg["geom_inject_resolutions"]) + 1):
        name = dec_layers[r - 1][0]
        p, s = params["decoder"][name], state["decoder"][name]
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        x = F.conv2d(F.pad(x, [1] * 4, mode="reflect"),
                     p["conv"]["weight"].to(dtype))
        x = _bn_lrelu(p["bn"], s["bn"],
                      x + p["conv"]["bias"].to(dtype)[None, :, None, None])
        outs.append(x)
    res = sorted(W.geom_features(cfg))
    return {r: outs[i] for i, r in zip(cfg["geom_inject_resolutions"], res)}


def render(cfg: Dict, trees: Dict, geom, z, positions, dtype,
           blend: Optional[Dict] = None, feature_res: Optional[int] = None):
    """One batch of patches through encoder, mapping, synthesis and the
    triad head, in the 'clear' render mode.

    geom ``[B, 1, R, R]``; z ``[B, z_dim]``; positions ``[B, 2]`` (y, x);
    ``blend`` {res: (features ``[B, C, r, r]``, alpha ``[B, 1, r, r]``)}
    mixes stored features into the trunk after that block.  Returns
    (rgba ``[B, 4, R, R]`` float32 in the program's [0, 1] before its
    clamp, the trunk features at ``feature_res`` float32 or None)."""
    gp, gs = trees["gen_params"], trees["gen_state"]
    feats = encode(cfg, trees["enc_params"], trees["enc_state"], geom, dtype)
    w = mapping(cfg, gp, z, dtype)
    img_res = cfg["img_resolution"]
    x, out_feat = None, None
    blend = blend or {}
    for res in W.block_resolutions(cfg):
        bp = gp["synthesis"][f"b{res}"]
        if res == 4:
            x = bp["const"].to(dtype)[None].expand(z.shape[0], -1, -1, -1)
        else:
            noise = wrapped_noise(gs["noise"][f"b{res}.conv0.noise_const"],
                                  positions, img_res)
            x = modulated_layer(cfg, bp["conv0"], x, w, noise, True, dtype)
        noise = wrapped_noise(gs["noise"][f"b{res}.conv1.noise_const"],
                              positions, img_res)
        x = modulated_layer(cfg, bp["conv1"], x, w, noise, False, dtype)
        if res in blend:
            f, a = blend[res]
            x = (a * f.float() + (1.0 - a) * x.float()).to(dtype)
        if res == feature_res:
            out_feat = x.float()
        if res == img_res:
            uvs, colors = triad_head(cfg, bp["torgb"], x, w, dtype)
        if res in feats:
            x = torch.cat([x, feats[res].to(dtype)], dim=1)
    colors = (colors + 1.0) / 2.0
    stroke = torch.einsum("bkhw,bck->bchw", uvs, colors)
    alpha = uvs[:, 0:1] + uvs[:, 1:2]
    return torch.cat([stroke, alpha], dim=1), out_feat
