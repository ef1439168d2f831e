"""Geometry-conditioned StyleGAN2 synthesis network (NeuBE trunk).

Counterpart of ``brushstroke_engine_tpu/models/synthesis.py``: the same
channel plan (:class:`SynthesisConfig`), the same param keys
(``b128.conv0.affine.weight`` ...) and the same flat noise-texture dict
(``"b128.conv0.noise_const"``).  Activations are NHWC.

Every up=2 layer (``conv0`` of each block at res >= 8) runs its FIR,
demodulation, noise, bias, leaky ReLU and clamp as one call of the fused
FIR-epilogue kernel (through :func:`modulated_conv2d`).

Carried over: geometry feature injection, positional-encoding injection
('cat' and 'add'), position-wrapped constant noise, random per-layer noise
(training), per-style noise-buffer overrides (one plane for every row, or
one per row), ``return_features`` and
``blended_features``, ``force_fp32``, the color-triad and 'canvas' heads
with ``color_w_channels``, and the StyleGAN2 'orig' head on the 'orig' or
'skip' trunk (a torgb at every block, the running image FIR-upsampled and
summed); and the two heads the reference declares but no config reaches
(:func:`color_mapping_apply`, :func:`to_canvas_stroke_apply`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from brushstroke_engine_torch.ops import (
    bias_act, activation_gain, modulated_conv2d, setup_filter, upsample2d,
    wrapped_const_noise,
)
from brushstroke_engine_torch.models.layers import fc_apply
from brushstroke_engine_torch.parallel.distributed import draw_rows


@dataclass(frozen=True)
class SynthesisConfig:
    w_dim: int
    img_resolution: int
    img_channels: int = 3
    geom_feature_resolutions: Tuple[int, ...] = ()
    geom_feature_channels: Tuple[int, ...] = ()
    color_format: str = "triad"          # 'orig' | 'triad' | 'canvas'
    color_w_channels: int = 0
    architecture: str = "orig"           # 'orig' | 'skip'
    channel_base: int = 16384
    channel_max: int = 128
    num_bf16_res: int = 0                # N highest resolutions run in bf16.
    conv_clamp: Optional[float] = 256.0
    resample_taps: Tuple[int, ...] = (1, 3, 3, 1)
    activation: str = "lrelu"
    pos_encoding_channels: int = 0
    pos_encoding_resolutions: Tuple[int, ...] = ()
    pos_encoding_injection_mode: str = "cat"

    def __post_init__(self):
        assert self.img_resolution >= 4 and \
            self.img_resolution & (self.img_resolution - 1) == 0
        assert self.color_format in ("orig", "triad", "canvas")
        if self.color_format != "orig":
            assert self.architecture == "orig", \
                "triad/canvas heads require the 'orig' trunk"

    @property
    def block_resolutions(self) -> Tuple[int, ...]:
        n = int(math.log2(self.img_resolution))
        return tuple(2 ** i for i in range(2, n + 1))

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    def extra_in_channels(self, prev_res: int) -> int:
        """Channels appended to the trunk after the block at prev_res."""
        extra = 0
        if prev_res in self.geom_feature_resolutions:
            idx = self.geom_feature_resolutions.index(prev_res)
            extra += self.geom_feature_channels[idx]
        if (prev_res in self.pos_encoding_resolutions
                and self.pos_encoding_injection_mode == "cat"):
            extra += self.pos_encoding_channels
        return extra

    def block_in_channels(self, res: int) -> int:
        if res == 4:
            return 0
        return self.channels(res // 2) + self.extra_in_channels(res // 2)

    def block_is_last(self, res: int) -> bool:
        return res == self.img_resolution

    def block_has_torgb(self, res: int) -> bool:
        return self.block_is_last(res) or self.architecture == "skip"

    def block_num_conv(self, res: int) -> int:
        return 1 if res == 4 else 2

    def block_dtype(self, res: int):
        bf16_res = max(2 ** (int(math.log2(self.img_resolution)) + 1
                             - self.num_bf16_res), 8)
        return torch.bfloat16 if res >= bf16_res else torch.float32

    @property
    def num_ws(self) -> int:
        n = sum(self.block_num_conv(r) for r in self.block_resolutions)
        return n + 1  # +1 for the (last) torgb w.

    @property
    def torgb_extra_channels(self) -> int:
        return 5 if self.color_format == "canvas" else 0

    @property
    def resample_filter(self):
        return setup_filter(list(self.resample_taps))


def _synthesis_layer_apply(cfg: SynthesisConfig, params, x, w, *,
                           resolution: int, up: int = 1,
                           noise_mode: str = "const",
                           noise_const=None, input_noise=None,
                           positions=None, random_noise=None, rng=None):
    """One SynthesisLayer (reference networks.py:303-391), NHWC.

    With ``noise_mode='random'`` the unit-normal plane ``[B, res, res, 1]``
    is ``random_noise`` when given, else drawn from the generator ``rng``.
    """
    styles = fc_apply(params["affine"], w.float())

    noise = None
    if noise_mode == "random":
        if random_noise is None:
            random_noise = draw_rows(
                torch.randn, (x.shape[0], resolution, resolution, 1),
                generator=rng,
                device=x.device if rng is None else rng.device).to(x.device)
        noise = random_noise.float() * params["noise_strength"]
    elif noise_mode == "const":
        tex = input_noise if input_noise is not None else noise_const
        if tex is not None:
            if tex.dim() == 3:
                # One plane per row ([B, res, res]: N styles run as one
                # pass over their N*B rows).
                if positions is not None:
                    raise ValueError("per-row noise buffers take no "
                                     "canvas positions")
                noise = tex.float()[..., None]
            elif positions is not None:
                noise = wrapped_const_noise(tex, positions,
                                            cfg.img_resolution)
            else:
                noise = tex.float()[None, :, :, None]
            noise = noise * params["noise_strength"]

    return modulated_conv2d(
        x, params["weight"], styles, noise=noise, up=up,
        padding=params["weight"].shape[-1] // 2,
        resample_filter=cfg.resample_filter, flip_weight=(up == 1),
        bias=params["bias"], activation=cfg.activation,
        act_gain=activation_gain(cfg.activation), clamp=cfg.conv_clamp)


# ---------------------------------------------------------------------------
# Output heads no model config wires in (reference networks.py:178-212,
# 489-536); their initialisers are in utils/checkpoint.py.
# ---------------------------------------------------------------------------

def color_mapping_apply(params, w, activation: str = "lrelu",
                        normalize: bool = True):
    """ColorMappingNetwork: w ``[B, w_dim]`` through ``fc0 .. fc{n-1}``
    (each with ``activation``) to colors ``[B, 3, 3]``, tanh-normalized
    when ``normalize``."""
    x = w.float()
    for i in range(len(params)):
        x = fc_apply(params[f"fc{i}"], x, activation=activation)
    colors = x.reshape(-1, 3, 3)
    return torch.tanh(colors) if normalize else colors


def to_canvas_stroke_apply(params, x, w, conv_clamp=None):
    """ToCanvasStrokeLayer: a tanh canvas, a softmax over the 3 UVS channels
    and a tanh alpha, composited as ``(1 - alpha) * canvas + alpha *
    stroke``.  ``x`` NHWC, ``w [B, w_dim]``.  Returns ``(img, debug)`` with
    ``colors``, ``uvs``, ``canvas`` and ``alpha_fg``."""
    in_ch = params["weight"].shape[1]
    weight_gain = 1.0 / math.sqrt(in_ch)  # 1x1 kernel
    scaled = fc_apply(params["affine"], w.float())
    colors = bias_act(scaled[:, :9], params["color_bias"], dim=-1,
                      act="tanh").reshape(-1, 3, 3)
    styles = scaled[:, 9:] * weight_gain
    x = modulated_conv2d(x, params["weight"], styles, demodulate=False,
                         bias=params["bias"], clamp=conv_clamp).float()
    canvas = torch.tanh(x[..., :3])
    uvs = torch.softmax(x[..., 3:6], dim=-1)
    alpha_fg = (torch.tanh(x[..., 6:]) + 1.0) / 2.0
    stroke = torch.einsum("bhwk,bck->bhwc", uvs, colors)
    out = (1.0 - alpha_fg) * canvas + alpha_fg * stroke
    return out, {"colors": colors, "uvs": uvs, "canvas": canvas,
                 "alpha_fg": alpha_fg}


def _torgb_apply(cfg: SynthesisConfig, params, x, w):
    """The output head; returns (img, debug_data).

    'orig' is StyleGAN2's ToRGBLayer: a modulated 1x1 conv without
    demodulation, bias and clamp.  'triad' is ToRGBColorTriadLayer: colors
    come from the style affine (9 extra outputs) or, with
    ``color_w_channels > 0``, from a separate ``color_affine`` of the first
    ``color_w_channels`` entries of w.  The 'canvas' head has 5 more output
    channels: a canvas color (3-5) and a two-way alpha softmax (6-7) that
    mixes stroke and canvas."""
    in_ch = params["weight"].shape[1]
    weight_gain = 1.0 / math.sqrt(in_ch)  # 1x1 kernel
    w32 = w.float()
    if cfg.color_format == "orig":
        styles = fc_apply(params["affine"], w32) * weight_gain
        return modulated_conv2d(x, params["weight"], styles,
                                demodulate=False, bias=params["bias"],
                                clamp=cfg.conv_clamp), {}
    if cfg.color_w_channels > 0:
        styles = fc_apply(params["affine"], w32) * weight_gain
        colors = fc_apply(params["color_affine"],
                          w32[..., :cfg.color_w_channels])
    else:
        scaled = fc_apply(params["affine"], w32)
        colors = scaled[:, 0:9]
        styles = scaled[:, 9:] * weight_gain

    colors = bias_act(colors, params["color_bias"], dim=-1, act="tanh")
    colors = colors.reshape(-1, 3, 3)  # [B, rgb, (u,v,s)]

    x = modulated_conv2d(x, params["weight"], styles, demodulate=False,
                         bias=params["bias"], clamp=cfg.conv_clamp)
    x = x.float()

    uvs = torch.softmax(x[..., :3], dim=-1)          # [B, H, W, 3]
    debug = {"colors": colors, "uvs": uvs}
    # stroke[b,h,w,c] = sum_k uvs[b,h,w,k] * colors[b,c,k]
    stroke = torch.einsum("bhwk,bck->bhwc", uvs, colors)
    if cfg.color_format == "triad":
        return stroke, debug
    canvas = x[..., 3:6]
    alpha = torch.softmax(x[..., 6:8], dim=-1)
    debug.update(canvas=canvas, alpha_fg=alpha[..., :1], alpha=alpha)
    return alpha[..., :1] * stroke + alpha[..., 1:] * canvas, debug


def _inject_position(cfg: SynthesisConfig, x, block_geom, enc):
    """Positional encoding ``enc`` into the trunk after a block: 'cat'
    appends it; 'add' adds it to the trunk, to the geometry features, or to
    both concatenated, whichever its channel count matches.  Returns
    (x, block_geom) with the geometry still to be appended, or None."""
    mode = cfg.pos_encoding_injection_mode
    if mode == "cat":
        return torch.cat([x, enc], dim=-1), block_geom
    if mode != "add":
        raise ValueError(f"unknown injection mode {mode}")
    if enc.shape[-1] == x.shape[-1]:
        return x + enc, block_geom
    if block_geom is not None and enc.shape[-1] == block_geom.shape[-1]:
        return x, block_geom + enc
    if block_geom is not None and \
            enc.shape[-1] == block_geom.shape[-1] + x.shape[-1]:
        return torch.cat([x, block_geom], dim=-1) + enc, None
    raise ValueError("pos-encoding channel mismatch for add")


def synthesis_apply(cfg: SynthesisConfig, params, ws, geom_features=(), *,
                    noise: Optional[Dict] = None,
                    noise_buffers: Optional[Dict] = None,
                    positions=None,
                    pos_encoding: Optional[Sequence] = None,
                    noise_mode: str = "const",
                    rng: Optional[torch.Generator] = None,
                    random_noise: Optional[Dict] = None,
                    return_debug_data: bool = False,
                    return_features: Tuple[int, ...] = (),
                    blended_features: Optional[Dict] = None,
                    force_fp32: bool = False):
    """Run the synthesis trunk.

    Args:
      ws: ``[B, num_ws, w_dim]`` styles.
      geom_features: list of ``[B, h_i, w_i, c_i]`` geometry feature maps, one
        per entry of ``cfg.geom_feature_resolutions`` (NHWC).
      noise: default per-layer noise textures ``{"b{res}.conv{i}.noise_const":
        [res, res]}``.
      noise_buffers: optional per-style overrides, same key format:
        ``[res, res]`` for every row, or ``[B, res, res]``, one plane per
        row (without ``positions``).
      positions: ``[B, 2]`` int (y, x) canvas positions for noise wrapping.
      pos_encoding: ``[B, h, w, c]`` positional encodings, one per entry of
        ``cfg.pos_encoding_resolutions``.
      noise_mode: 'const' | 'random' | 'none'.
      rng: ``torch.Generator`` the 'random' noise planes are drawn from.
      random_noise: explicit unit-normal planes for 'random' mode,
        ``{"b{res}.conv{i}": [B, res, res, 1]}``; layers it lacks draw from
        ``rng``.
      force_fp32: run every block in f32 whatever ``num_bf16_res`` says.
      return_features: trunk resolutions whose features to export.
      blended_features: {res: (features ``[B,h,w,c]``, alpha ``[B,h,w,1]``)};
        trunk features become ``alpha*features + (1-alpha)*x``.

    Returns:
      img or (img, debug_data) when debug/feature outputs were requested.
    """
    noise = noise or {}
    noise_buffers = noise_buffers or {}
    blended_features = blended_features or {}
    random_noise = random_noise or {}
    if noise_mode not in ("const", "random", "none"):
        raise ValueError(f"unknown noise_mode {noise_mode!r}")

    ws = ws.float()
    block_ws = {}
    w_idx = 0
    for res in cfg.block_resolutions:
        n = cfg.block_num_conv(res) + (1 if cfg.block_has_torgb(res) else 0)
        block_ws[res] = ws[:, w_idx:w_idx + n]
        w_idx += cfg.block_num_conv(res)

    debug = {}
    x = None
    img = None
    geo_idx = 0
    pos_idx = 0
    b = ws.shape[0]
    last_res = cfg.block_resolutions[-1]

    for res in cfg.block_resolutions:
        bp = params[f"b{res}"]
        cur_ws = block_ws[res]
        dtype = torch.float32 if force_fp32 else cfg.block_dtype(res)
        w_i = 0

        def layer_noise(name):
            key = f"b{res}.{name}.noise_const"
            if key in noise_buffers:
                return None, noise_buffers[key]
            return noise.get(key), None

        if res == 4:
            const = bp["const"].to(dtype).permute(1, 2, 0)   # [4, 4, C]
            x = const[None].expand(b, -1, -1, -1).contiguous()
        else:
            x = x.to(dtype)
            nc, ni = layer_noise("conv0")
            x = _synthesis_layer_apply(
                cfg, bp["conv0"], x, cur_ws[:, w_i], resolution=res, up=2,
                noise_mode=noise_mode, noise_const=nc, input_noise=ni,
                positions=positions, rng=rng,
                random_noise=random_noise.get(f"b{res}.conv0"))
            w_i += 1

        nc, ni = layer_noise("conv1")
        x = _synthesis_layer_apply(
            cfg, bp["conv1"], x, cur_ws[:, w_i], resolution=res, up=1,
            noise_mode=noise_mode, noise_const=nc, input_noise=ni,
            positions=positions, rng=rng,
            random_noise=random_noise.get(f"b{res}.conv1"))
        w_i += 1

        # The 'skip' trunk carries the image up and adds every block's torgb;
        # on the 'orig' trunk only the last block has one.
        if img is not None:
            img = upsample2d(img, cfg.resample_filter)
        if cfg.block_has_torgb(res):
            y, tdebug = _torgb_apply(cfg, bp["torgb"], x, cur_ws[:, -1])
            y = y.float()
            img = y if img is None else img + y
            if res == last_res:
                debug.update(tdebug)

        if res in return_features:
            debug[f"features{res}_preblend"] = x

        if res in blended_features:
            feats, alpha = blended_features[res]
            x = (alpha * feats.float()
                 + (1.0 - alpha) * x.float()).to(x.dtype)
            if res == last_res:
                img, tdebug = _torgb_apply(cfg, bp["torgb"], x, cur_ws[:, -1])
                debug.update(tdebug)

        if res in return_features:
            debug[f"features{res}"] = x

        # Geometry / positional-encoding injection for the next block.
        block_geom = None
        if res in cfg.geom_feature_resolutions:
            block_geom = geom_features[geo_idx].to(x.dtype)
            geo_idx += 1
        if res in cfg.pos_encoding_resolutions:
            enc = pos_encoding[pos_idx].to(x.dtype)
            pos_idx += 1
            x, block_geom = _inject_position(cfg, x, block_geom, enc)
        if block_geom is not None:
            x = torch.cat([x, block_geom], dim=-1)

    if return_debug_data or return_features:
        return img, debug
    return img
