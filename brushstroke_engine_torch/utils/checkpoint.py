"""Checkpoint I/O: native bundles, the JAX-layout -> torch-layout parameter
conversion, and reference checkpoints converted without running their code.

The native bundle (``brushstroke_engine_tpu.bundle.v1``) is one pickle of
plain dicts: dataclass configs as dicts and numpy parameter trees in the JAX
package's layouts.  :func:`params_from_jax` turns such a tree into the
port's tensors (and :func:`params_to_jax` back, for :func:`save_native`):

  * FC weights   ``[in, out]``        -> ``[out, in]``
  * conv weights HWIO                 -> OIHW (transposed convs too; the geo
    encoder views them as torch's IOHW)
  * const input  ``[4, 4, C]``        -> ``[C, 4, 4]``
  * everything else (biases, BN stats, noise textures, w_avg) as it is.

The discriminator's ``b4.fc`` weight needs only the FC transpose: both
packages flatten the 4x4 map as NHWC.  :func:`train_state_from_jax` applies
the same rules to a whole JAX train state, optimizer moments included, and
:func:`train_state_to_jax` back.

:func:`init_native_params` builds random trees in the JAX layout from a
numpy seed for every model variant, so a run needs no checkpoint and no JAX.

Reference conversion (the port's copy of the JAX package's): a reference
training snapshot ``{G, D, G_ema, args, encoder, ...}`` (reference:
thirdparty/.../training_loop_modified.py:560-578), an encoder ``.pt`` or a
TF-legacy StyleGAN2 pickle is read by :mod:`utils.torch_extract` (no code of
the file runs) and every tensor is mapped into the JAX package's layouts
(numpy trees, bit-equal to that package's conversion), then through
:func:`params_from_jax` into the port's tensors:

  * FC weights   [out, in]        -> [in, out]
  * conv weights OIHW             -> HWIO (transposed convs IOHW -> HWIO)
  * const input  [C, 4, 4]        -> [4, 4, C]
  * D epilogue fc: torch flattens NCHW, both packages NHWC -> column permute
  * noise_const buffers           -> state['noise']['b{res}.conv{i}.noise_const']
  * TF variables: HWIO (up-convs stored flipped), ``mod_bias`` minus one.

:func:`load_engine_bundle` reads a native bundle, or else converts a
reference snapshot; only a file that is no native bundle is converted.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import pickle
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from brushstroke_engine_torch.models.discriminator import DiscriminatorConfig
from brushstroke_engine_torch.models.generator import (
    GeneratorConfig, make_generator_config,
)
from brushstroke_engine_torch.models.geo_encoder import GeoEncoderConfig
from brushstroke_engine_torch.models.synthesis import SynthesisConfig
from brushstroke_engine_torch.utils import torch_extract as tx
from brushstroke_engine_torch.utils.util import resolve_device, tree_to

logger = logging.getLogger(__name__)

NATIVE_MAGIC = "brushstroke_engine_tpu.bundle.v1"
TF_GENERATOR_MAGIC = "brushstroke_engine_tpu.tf_generator.v1"


@dataclass
class EngineBundle:
    gen_cfg: GeneratorConfig
    gen_params: Dict
    gen_state: Dict
    enc_cfg: GeoEncoderConfig
    enc_params: Dict
    enc_state: Dict
    color_format: str = "triad"
    geom_inject_resolutions: Tuple[int, ...] = (0,)
    extra: Dict = dataclasses.field(default_factory=dict)


def _leaf_from_jax(key: str, a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    if key == "weight" and a.ndim == 4:
        a = np.transpose(a, (3, 2, 0, 1))          # HWIO -> OIHW
    elif key == "weight" and a.ndim == 2:
        a = a.T                                    # [in, out] -> [out, in]
    elif key == "const" and a.ndim == 3:
        a = np.transpose(a, (2, 0, 1))             # [4, 4, C] -> [C, 4, 4]
    # ascontiguousarray lifts a 0-d leaf to [1]; keep its shape.
    return torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))


def params_from_jax(tree) -> Dict:
    """JAX-layout numpy tree -> the port's CPU tensors (see module doc)."""
    return {k: params_from_jax(v) if isinstance(v, dict)
            else _leaf_from_jax(k, v) for k, v in tree.items()}


def _leaf_to_jax(key: str, t) -> np.ndarray:
    """Exact inverse of :func:`_leaf_from_jax` for the port's f32 leaves."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)
    if key == "weight" and a.ndim == 4:
        a = np.transpose(a, (2, 3, 1, 0))          # OIHW -> HWIO
    elif key == "weight" and a.ndim == 2:
        a = a.T                                    # [out, in] -> [in, out]
    elif key == "const" and a.ndim == 3:
        a = np.transpose(a, (1, 2, 0))             # [C, 4, 4] -> [4, 4, C]
    return np.ascontiguousarray(a).reshape(a.shape)


def params_to_jax(tree) -> Dict:
    """The port's tensors -> a JAX-layout numpy tree (inverse of
    :func:`params_from_jax`)."""
    return {k: params_to_jax(v) if isinstance(v, dict)
            else _leaf_to_jax(k, v) for k, v in tree.items()}


def _tupled(d: Dict, keys) -> Dict:
    d = dict(d)
    for k in keys:
        if d.get(k) is not None:
            d[k] = tuple(d[k])
    return d


def configs_from_dicts(gen_cfg: Dict, enc_cfg: Dict):
    """Config dicts of a native bundle -> (GeneratorConfig, GeoEncoderConfig);
    the encoder's is None in the bundle of a generator trained without
    geometry."""
    gen_d = _tupled(gen_cfg, ("posenc_inject_resolutions",))
    syn = _tupled(gen_d.pop("synthesis"), (
        "geom_feature_resolutions", "geom_feature_channels",
        "resample_taps", "pos_encoding_resolutions"))
    gen = GeneratorConfig(synthesis=SynthesisConfig(**syn), **gen_d)
    enc = None if enc_cfg is None else GeoEncoderConfig(**_tupled(
        enc_cfg, ("down_filters", "post_filters", "up_filters")))
    return gen, enc


def _is_native(payload) -> bool:
    return isinstance(payload, dict) and payload.get("magic") == NATIVE_MAGIC


def load_native(path: str, device="cuda") -> EngineBundle:
    """Read a native bundle; its trees become the port's tensors on
    ``device`` (raises without CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if not _is_native(payload):
        raise ValueError(f"not a native bundle: {path}")
    return _bundle_from_payload(payload, dev)


def _bundle_from_payload(payload: Dict, dev) -> EngineBundle:
    gen_cfg, enc_cfg = configs_from_dicts(payload["gen_cfg"],
                                          payload["enc_cfg"])
    trees = [tree_to(params_from_jax(payload[k]), dev) for k in
             ("gen_params", "gen_state", "enc_params", "enc_state")]
    return EngineBundle(
        gen_cfg, *trees[:2], enc_cfg, *trees[2:],
        color_format=payload["color_format"],
        geom_inject_resolutions=tuple(payload["geom_inject_resolutions"]),
        extra=payload.get("extra", {}))


def save_native(path: str, bundle: EngineBundle) -> None:
    """Write ``bundle`` (the port's configs and tensors) as a native bundle
    in the JAX package's layout, which its ``load_native`` and this module's
    :func:`load_native` both read."""
    payload = {
        "magic": NATIVE_MAGIC,
        "gen_cfg": dataclasses.asdict(bundle.gen_cfg),
        "enc_cfg": None if bundle.enc_cfg is None
        else dataclasses.asdict(bundle.enc_cfg),
        **{k: params_to_jax(getattr(bundle, k) or {}) for k in
           ("gen_params", "gen_state", "enc_params", "enc_state")},
        "color_format": bundle.color_format,
        "geom_inject_resolutions": tuple(bundle.geom_inject_resolutions),
        "extra": bundle.extra,
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=4)


# ---------------------------------------------------------------------------
# Random init in the JAX layout (shapes and distributions of generator_init /
# geo_encoder_init, drawn from numpy instead of jax.random).
# ---------------------------------------------------------------------------

def _fc(rng, n_in, n_out, lr_multiplier=1.0, bias_init=0.0):
    return {"weight": (rng.randn(n_in, n_out) / lr_multiplier)
            .astype(np.float32),
            "bias": np.full((n_out,), bias_init, np.float32)}


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _init_torgb(scfg: SynthesisConfig, rng, in_ch: int):
    """The 'orig', triad or canvas head; triad and canvas colors come from
    the style affine or, with ``color_w_channels``, from a ``color_affine``
    of their own."""
    out_ch = scfg.img_channels + scfg.torgb_extra_channels
    if scfg.color_format == "orig":
        return {"affine": _fc(rng, scfg.w_dim, in_ch, bias_init=1.0),
                "weight": _randn(rng, 1, 1, in_ch, out_ch),
                "bias": np.zeros((out_ch,), np.float32)}
    cw = scfg.color_w_channels
    p = {"affine": _fc(rng, scfg.w_dim, in_ch + (0 if cw else 9),
                       bias_init=1.0)}
    if cw:
        p["color_affine"] = _fc(rng, cw, 9)
    p.update(weight=_randn(rng, 1, 1, in_ch, out_ch),
             bias=np.zeros((out_ch,), np.float32),
             color_bias=np.zeros((9,), np.float32))
    return p


def color_mapping_init(rng, w_dim: int, layer_features=(128, 32)):
    """ColorMappingNetwork params (``models/synthesis.py:
    color_mapping_apply``) in the JAX layout, drawn from the numpy
    ``RandomState`` ``rng``: ``fc0 .. fc{n-1}``, w -> layer_features -> 9."""
    sizes = [w_dim] + list(layer_features) + [9]
    return {f"fc{i}": _fc(rng, sizes[i], sizes[i + 1])
            for i in range(len(sizes) - 1)}


def to_canvas_stroke_init(rng, in_ch: int, out_ch: int, w_dim: int):
    """ToCanvasStrokeLayer params (``models/synthesis.py:
    to_canvas_stroke_apply``) in the JAX layout from ``rng``: an affine to
    ``in_ch`` styles and 9 colors, and a 1x1 conv to the canvas (``out_ch``),
    3 UVS and 1 alpha channel."""
    out_total = out_ch + 3 + 1
    return {"affine": _fc(rng, w_dim, in_ch + 9, bias_init=1.0),
            "weight": _randn(rng, 1, 1, in_ch, out_total),
            "bias": np.zeros((out_total,), np.float32),
            "color_bias": np.zeros((9,), np.float32)}


def _init_generator(cfg: GeneratorConfig, rng):
    mcfg = cfg.mapping
    feats = mcfg.features_list
    mapping = {f"fc{i}": _fc(rng, feats[i], feats[i + 1], mcfg.lr_multiplier)
               for i in range(mcfg.num_layers)}
    if mcfg.c_dim > 0:
        mapping["embed"] = _fc(rng, mcfg.c_dim, mcfg.embed_dim)
    scfg = cfg.synthesis
    synthesis, noise = {}, {}

    def layer(in_ch, out_ch):
        return {"affine": _fc(rng, scfg.w_dim, in_ch, bias_init=1.0),
                "weight": _randn(rng, 3, 3, in_ch, out_ch),
                "bias": np.zeros((out_ch,), np.float32),
                "noise_strength": np.zeros((), np.float32)}

    for res in scfg.block_resolutions:
        out_ch = scfg.channels(res)
        block = {}
        if res == 4:
            block["const"] = _randn(rng, 4, 4, out_ch)
        else:
            block["conv0"] = layer(scfg.block_in_channels(res), out_ch)
            noise[f"b{res}.conv0.noise_const"] = _randn(rng, res, res)
        block["conv1"] = layer(out_ch, out_ch)
        noise[f"b{res}.conv1.noise_const"] = _randn(rng, res, res)
        if scfg.block_has_torgb(res):
            block["torgb"] = _init_torgb(scfg, rng, out_ch)
        synthesis[f"b{res}"] = block
    state = {"noise": noise, "w_avg": np.zeros((cfg.w_dim,), np.float32)}
    return {"mapping": mapping, "synthesis": synthesis}, state


def _init_encoder(cfg: GeoEncoderConfig, rng):
    params = {"encoder": {}, "decoder": {}}
    state = {"encoder": {}, "decoder": {}}

    def conv(k, cin, cout):
        std = np.sqrt(2.0 / (cin * k * k + cout * k * k))
        return {"weight": (std * rng.randn(k, k, cin, cout)).astype(np.float32),
                "bias": np.zeros((cout,), np.float32)}

    def single(part, name, cin, cout, k):
        params[part][name] = {
            "conv": conv(k, cin, cout),
            "bn": {"scale": np.ones((cout,), np.float32),
                   "bias": np.zeros((cout,), np.float32)}}
        state[part][name] = {"bn": {"mean": np.zeros((cout,), np.float32),
                                    "var": np.ones((cout,), np.float32)}}

    if cfg.kind == "conv":
        for part, names in _conv_encoder_plan(cfg).items():
            for name, cin, cout in names:
                single(part, name, cin, cout, 3)
        return params, state

    plan = []
    prev = cfg.in_channels
    if cfg.pre_filters > 0:
        plan.append((prev, cfg.pre_filters, 7))
        prev = cfg.pre_filters
    for f in list(cfg.down_filters) + list(cfg.post_filters):
        plan.append((prev, f, 3))
        prev = f
    for i, (cin, cout, k) in enumerate(plan):
        single("encoder", f"layer{i}", cin, cout, k)
    if cfg.decoder_pre_filters > 0:
        single("decoder", "first", prev, cfg.decoder_pre_filters, 3)
        prev = cfg.decoder_pre_filters
    for i, f in enumerate(cfg.up_filters):
        single("decoder", f"up{i}", prev, f, 3)
        prev = f
    if cfg.out_channels != prev:
        params["decoder"]["final"] = conv(1, prev, cfg.out_channels)
    return params, state


def _conv_encoder_plan(cfg: GeoEncoderConfig) -> Dict:
    """(name, in, out) of every layer of the 'conv' autoencoder (ae_conv.py;
    JAX ``geo_encoder_init``): strided encoder layers from ``img_width``
    down, 'final' to ``emb_channel``, then 'first' and the transposed
    decoder layers back up to ``out_channels``."""
    res_log2 = int(math.log2(cfg.img_width))
    enc_res = [2 ** i for i in range(res_log2,
                                     max(res_log2 - cfg.num_layers, 2), -1)]
    ch = {r: cfg.channel_factor * 2 ** i for i, r in enumerate(enc_res)}
    enc, prev = [], cfg.in_channels
    for r in enc_res:
        enc.append((f"layer{r}", prev, ch[r]))
        prev = ch[r]
    enc.append(("final", prev, cfg.emb_channel))
    dec_res = enc_res[::-1]
    dch = {r: cfg.channel_factor * 2 ** (cfg.num_layers - i - 1)
           for i, r in enumerate(dec_res)}
    dec = [("first", cfg.emb_channel, dch[dec_res[0]])]
    for r in dec_res:
        dec.append((f"layer{r}", dch[r],
                    dch[r * 2] if r < dec_res[-1] else cfg.out_channels))
    return {"encoder": enc, "decoder": dec}


def _init_discriminator(cfg, rng):
    """Shapes and distributions of the JAX ``discriminator_init``."""
    def conv(cin, cout, k, bias=True):
        p = {"weight": _randn(rng, k, k, cin, cout)}
        if bias:
            p["bias"] = np.zeros((cout,), np.float32)
        return p

    params = {}
    for res in cfg.block_resolutions:
        tmp, out = cfg.channels(res), cfg.channels(res // 2)
        block = {}
        if res == cfg.img_resolution:
            block["fromrgb"] = conv(cfg.img_channels, tmp, 1)
        block["conv0"] = conv(tmp, tmp, 3)
        block["conv1"] = conv(tmp, out, 3)
        if cfg.architecture == "resnet":
            block["skip"] = conv(tmp, out, 1, bias=False)
        params[f"b{res}"] = block
    ch4 = cfg.channels(4)
    params["b4"] = {"conv": conv(ch4 + cfg.mbstd_num_channels, ch4, 3),
                    "fc": _fc(rng, ch4 * 16, ch4),
                    "out": _fc(rng, ch4, 1 if cfg.cmap == 0 else cfg.cmap)}
    if cfg.c_dim > 0:
        mcfg = cfg.cmap_mapping
        feats = mcfg.features_list
        params["mapping"] = {
            f"fc{i}": _fc(rng, feats[i], feats[i + 1], mcfg.lr_multiplier)
            for i in range(mcfg.num_layers)}
        params["mapping"]["embed"] = _fc(rng, mcfg.c_dim, mcfg.embed_dim)
    return params


def init_native_params(gen_cfg: GeneratorConfig, enc_cfg: GeoEncoderConfig,
                       seed: int = 0, disc_cfg=None) -> Dict:
    """Random numpy trees in the JAX layout from ``RandomState(seed)``:
    ``{"gen_params", "gen_state", "enc_params", "enc_state"}``, plus
    ``"disc_params"`` for a ``DiscriminatorConfig`` (drawn last, so the other
    trees do not depend on it).  With no ``enc_cfg`` the encoder's trees
    are empty."""
    rng = np.random.RandomState(seed)
    enc_params, enc_state = ({}, {}) if enc_cfg is None else \
        _init_encoder(enc_cfg, rng)
    gen_params, gen_state = _init_generator(gen_cfg, rng)
    trees = {"gen_params": gen_params, "gen_state": gen_state,
             "enc_params": enc_params, "enc_state": enc_state}
    if disc_cfg is not None:
        trees["disc_params"] = _init_discriminator(disc_cfg, rng)
    return trees


def init_encoder_trees(enc_cfg: GeoEncoderConfig, seed: int = 0):
    """The encoder's random (params, state) in the JAX layout, drawn as
    :func:`init_native_params` draws them from ``RandomState(seed)``."""
    return _init_encoder(enc_cfg, np.random.RandomState(seed))


def _adam_from_jax(opt_state) -> Dict:
    """An ``optax.adam`` state -> the port's ``{"count", "mu", "nu"}``.
    Takes optax's tuple ``(ScaleByAdamState, ...)`` or a dict of the three."""
    if not isinstance(opt_state, dict):
        adam = next(s for s in opt_state if hasattr(s, "mu"))
        opt_state = {"count": adam.count, "mu": adam.mu, "nu": adam.nu}
    return {"count": int(np.asarray(opt_state["count"])),
            "mu": params_from_jax(opt_state["mu"]),
            "nu": params_from_jax(opt_state["nu"])}


def train_state_from_jax(state, device="cuda") -> Dict:
    """The JAX package's train state (numpy or JAX array trees, see its
    ``init_train_state``) -> the port's, on ``device``: parameter trees, EMA
    and Adam moments by the layout rules of :func:`params_from_jax`."""
    dev = resolve_device(device)
    out = {k: params_from_jax(state[k])
           for k in ("g_params", "d_params", "g_ema", "noise")}
    for k in ("w_avg", "pl_mean", "ada_p", "ada_signs", "ada_count"):
        out[k] = torch.from_numpy(np.array(state[k], np.float32))
    for k in ("g_opt", "d_opt", "geom_opt"):
        out[k] = _adam_from_jax(state[k])
    return tree_to(out, dev)


def train_state_to_jax(state) -> Dict:
    """The port's train state -> numpy trees in the JAX package's layouts
    (inverse of :func:`train_state_from_jax`); each Adam state becomes
    ``{"count": int32, "mu": tree, "nu": tree}``, the fields of optax's
    ``ScaleByAdamState``."""
    out = {k: params_to_jax(state[k])
           for k in ("g_params", "d_params", "g_ema", "noise")}
    for k in ("w_avg", "pl_mean", "ada_p", "ada_signs", "ada_count"):
        out[k] = np.array(state[k].detach().cpu(), np.float32)
    for k in ("g_opt", "d_opt", "geom_opt"):
        out[k] = {"count": np.int32(state[k]["count"]),
                  "mu": params_to_jax(state[k]["mu"]),
                  "nu": params_to_jax(state[k]["nu"])}
    return out


# ---------------------------------------------------------------------------
# Reference conversion: layout primitives (numpy, torch layout -> JAX layout)
# ---------------------------------------------------------------------------

def fc_from_torch(flat: Dict[str, np.ndarray], prefix: str) -> Dict:
    p = {"weight": np.ascontiguousarray(flat[prefix + ".weight"].T)}
    if prefix + ".bias" in flat:
        p["bias"] = flat[prefix + ".bias"]
    return p


def conv_from_torch(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def convtranspose_from_torch(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d weight IOHW -> HWIO (in, out swapped vs conv)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


def epilogue_fc_from_torch(w: np.ndarray, channels: int, res: int = 4
                           ) -> np.ndarray:
    """The D epilogue fc reordered for NHWC flattening, as ``[in, out]``:
    torch's rows index flatten(C, H, W), the packages' flatten(H, W, C)."""
    out_f = w.shape[0]
    w = w.reshape(out_f, channels, res, res)
    w = np.transpose(w, (0, 2, 3, 1)).reshape(out_f, channels * res * res)
    return np.ascontiguousarray(w.T)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

def convert_generator_state(flat: Dict[str, np.ndarray],
                            cfg: GeneratorConfig) -> Tuple[Dict, Dict]:
    """Flat torch-name tensor map -> (params, state) numpy trees in the JAX
    layout."""
    params = {"mapping": {}, "synthesis": {}}
    noise = {}
    state: Dict[str, Any] = {}

    for i in range(cfg.mapping_layers):
        params["mapping"][f"fc{i}"] = fc_from_torch(flat, f"mapping.fc{i}")
    if "mapping.embed.weight" in flat:
        params["mapping"]["embed"] = fc_from_torch(flat, "mapping.embed")
    if "mapping.w_avg" in flat:
        state["w_avg"] = flat["mapping.w_avg"]

    for res in cfg.synthesis.block_resolutions:
        b = f"synthesis.b{res}"
        block: Dict[str, Any] = {}
        if res == 4:
            block["const"] = np.ascontiguousarray(
                np.transpose(flat[f"{b}.const"], (1, 2, 0)))
        for conv in (["conv1"] if res == 4 else ["conv0", "conv1"]):
            block[conv] = {
                "affine": fc_from_torch(flat, f"{b}.{conv}.affine"),
                "weight": conv_from_torch(flat[f"{b}.{conv}.weight"]),
                "bias": flat[f"{b}.{conv}.bias"],
                "noise_strength": np.asarray(
                    flat[f"{b}.{conv}.noise_strength"]),
            }
            nk = f"{b}.{conv}.noise_const"
            if nk in flat:
                noise[f"b{res}.{conv}.noise_const"] = flat[nk]
        if f"{b}.torgb.weight" in flat:
            torgb = {
                "affine": fc_from_torch(flat, f"{b}.torgb.affine"),
                "weight": conv_from_torch(flat[f"{b}.torgb.weight"]),
                "bias": flat[f"{b}.torgb.bias"],
            }
            if f"{b}.torgb.color_bias" in flat:
                torgb["color_bias"] = flat[f"{b}.torgb.color_bias"]
            if f"{b}.torgb.color_affine.weight" in flat:
                torgb["color_affine"] = fc_from_torch(
                    flat, f"{b}.torgb.color_affine")
            block["torgb"] = torgb
        params["synthesis"][f"b{res}"] = block

    state["noise"] = noise
    return params, state


def infer_generator_config(flat: Dict[str, np.ndarray],
                           args: Dict[str, Any]) -> GeneratorConfig:
    """A GeneratorConfig from snapshot args + tensor shapes.

    As in the JAX package, every input channel of a ``conv0`` beyond the
    trunk's counts as a geometry channel, and ``args``' positional encoding
    is not read (``ROADMAP.md`` §3)."""
    resolutions = sorted({int(k.split(".")[1][1:]) for k in flat
                          if k.startswith("synthesis.b")})
    img_resolution = resolutions[-1]
    z_dim = int(flat["mapping.fc0.weight"].shape[1])
    mapping_layers = len({k for k in flat if k.startswith("mapping.fc")
                          and k.endswith(".weight")})
    w_dim = int(flat[f"mapping.fc{mapping_layers - 1}.weight"].shape[0])

    color_format = args.get("color_format", "triad")
    # A separate color_affine FC exists iff color_w_channels > 0 (reference
    # networks.py:424-431) and its input width IS color_w_channels.
    color_key = f"synthesis.b{img_resolution}.torgb.color_affine.weight"
    if color_key in flat:
        color_w_channels = int(flat[color_key].shape[1])
    else:
        color_w_channels = int(args.get("color_w_channels", 0) or 0)

    chan = {res: int(flat[f"synthesis.b{res}.conv1.weight"].shape[0])
            for res in resolutions}
    channel_max = max(chan.values())
    channel_base = max(c * r for r, c in chan.items())

    geom_res, geom_ch = [], []
    for res in resolutions[1:]:
        in_ch = int(flat[f"synthesis.b{res}.conv0.weight"].shape[1])
        extra = in_ch - chan[res // 2]
        if extra > 0:
            geom_res.append(res // 2)
            geom_ch.append(extra)

    return make_generator_config(
        z_dim=z_dim, c_dim=int(args.get("c_dim", 0) or 0), w_dim=w_dim,
        img_resolution=img_resolution,
        geom_feature_resolutions=tuple(geom_res),
        geom_feature_channels=tuple(geom_ch),
        color_format=color_format, color_w_channels=color_w_channels,
        channel_base=channel_base, channel_max=channel_max,
        mapping_layers=mapping_layers)


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------

def infer_discriminator_config(flat: Dict[str, np.ndarray],
                               args: Dict[str, Any]) -> DiscriminatorConfig:
    """A DiscriminatorConfig from a reference D state dict (networks.py:
    957-1007 layout: b{res}.{fromrgb,conv0,conv1,skip}, b4.{conv,fc,out},
    optional mapping.*)."""
    resolutions = sorted({int(k.split(".")[0][1:]) for k in flat
                          if k.startswith("b")
                          and k.split(".")[0][1:].isdigit()})
    img_resolution = resolutions[-1]
    img_channels = int(flat[f"b{img_resolution}.fromrgb.weight"].shape[1])
    chan = {res: int(flat[f"b{res}.conv0.weight"].shape[0])
            for res in resolutions if res > 4}
    chan[4] = int(flat["b4.conv.weight"].shape[0])
    return DiscriminatorConfig(
        c_dim=int(args.get("c_dim", 0) or 0), img_resolution=img_resolution,
        img_channels=img_channels,
        architecture="resnet" if any(".skip." in k for k in flat)
        else "orig",
        channel_base=max(c * r for r, c in chan.items()),
        channel_max=max(chan.values()),
        mbstd_num_channels=int(flat["b4.conv.weight"].shape[1]) - chan[4],
        conv_clamp=args.get("conv_clamp", 256.0))


def convert_discriminator_state(flat: Dict[str, np.ndarray],
                                cfg: DiscriminatorConfig) -> Dict:
    """Reference D state dict -> the discriminator's numpy params tree in
    the JAX layout."""
    def conv(prefix):
        p = {"weight": conv_from_torch(flat[prefix + ".weight"])}
        if prefix + ".bias" in flat:
            p["bias"] = flat[prefix + ".bias"]
        return p

    params = {}
    for res in cfg.block_resolutions:
        block = {}
        if res == cfg.img_resolution or f"b{res}.fromrgb.weight" in flat:
            block["fromrgb"] = conv(f"b{res}.fromrgb")
        block["conv0"] = conv(f"b{res}.conv0")
        block["conv1"] = conv(f"b{res}.conv1")
        if f"b{res}.skip.weight" in flat:
            block["skip"] = conv(f"b{res}.skip")
        params[f"b{res}"] = block
    params["b4"] = {
        "conv": conv("b4.conv"),
        "fc": {"weight": epilogue_fc_from_torch(flat["b4.fc.weight"],
                                                cfg.channels(4), res=4),
               "bias": flat["b4.fc.bias"]},
        "out": fc_from_torch(flat, "b4.out"),
    }
    if any(k.startswith("mapping.") for k in flat):
        # Conditional D: the same MappingNetwork layout (embed + fc stack).
        m = {}
        if "mapping.embed.weight" in flat:
            m["embed"] = fc_from_torch(flat, "mapping.embed")
        i = 0
        while f"mapping.fc{i}.weight" in flat:
            m[f"fc{i}"] = fc_from_torch(flat, f"mapping.fc{i}")
            i += 1
        params["mapping"] = m
    return params


# ---------------------------------------------------------------------------
# Geometry encoder
# ---------------------------------------------------------------------------

def encoder_config_from_args(args: Dict[str, Any]) -> GeoEncoderConfig:
    def intlist(v, default):
        if v is None:
            return tuple(default)
        if isinstance(v, str):
            return tuple(int(x) for x in v.split(",") if x)
        return tuple(int(x) for x in v)

    kind = args.get("model_name", "sauto")
    if kind == "sauto":
        return GeoEncoderConfig(
            kind="sauto",
            in_channels=int(args.get("encoder_in_channels", 1)),
            out_channels=int(args.get("decoder_out_channels", 1)),
            preproc=args.get("preproc_type", "none"),
            pre_filters=int(args.get("encoder_pre_filters", 64)),
            down_filters=intlist(args.get("encoder_down_filters"),
                                 (128, 256, 256)),
            post_filters=intlist(args.get("encoder_post_filters"), (32, 16)),
            up_filters=intlist(args.get("decoder_up_filters"),
                               (256, 128, 64)),
            decoder_pre_filters=int(args.get("decoder_pre_filters", -1)
                                    or -1),
            neg_slope=args.get("neg_slope"),
        )
    return GeoEncoderConfig(
        kind="conv",
        in_channels=int(args.get("encoder_in_channels", 1)),
        out_channels=int(args.get("decoder_out_channels", 1)),
        preproc=args.get("preproc_type", "none"),
        img_width=int(args.get("width", args.get("img_width", 128))),
        emb_channel=int(args.get("emb_channel", 4)),
        channel_factor=int(args.get("channel_factor", 4)),
        num_layers=int(args.get("enc_layer", 4)),
    )


def convert_encoder_state(flat: Dict[str, np.ndarray],
                          cfg: GeoEncoderConfig) -> Tuple[Dict, Dict]:
    """torch state_dict names -> the geo encoder's (params, state) numpy
    trees in the JAX layout.

    sauto: encoder.model.{i} = SingleConvolution whose .conv is a Sequential
    [Conv2d, BN, act] (legacy order) or [Conv2d, act, BN]; decoder: optional
    .first Sequential [Conv2d, act, BN], then .model.{i} = ScaleUp
    (.conv.conv Sequential) / ScaleUpV2 (.conv Sequential, a transposed
    conv) and an optional trailing 1x1 Conv2d.  conv: encoder.{layer<res>,
    final} and decoder.{first, layer<res>} Sequentials [Conv, act, BN], the
    decoder's layers transposed convs.
    """
    params = {"encoder": {}, "decoder": {}}
    state = {"encoder": {}, "decoder": {}}
    bn_idx = 2 if cfg.batchnorm_after_activation else 1

    def single_conv(prefix, bn_index=bn_idx, transpose=False):
        conv_w = flat[prefix + ".0.weight"]
        conv = {"weight": convtranspose_from_torch(conv_w) if transpose
                else conv_from_torch(conv_w),
                "bias": flat[prefix + ".0.bias"]}
        bn_p = {"scale": flat[f"{prefix}.{bn_index}.weight"],
                "bias": flat[f"{prefix}.{bn_index}.bias"]}
        bn_s = {"mean": flat[f"{prefix}.{bn_index}.running_mean"],
                "var": flat[f"{prefix}.{bn_index}.running_var"]}
        return {"conv": conv, "bn": bn_p}, {"bn": bn_s}

    def put(part, name, ps):
        params[part][name], state[part][name] = ps

    if cfg.kind == "sauto":
        n_enc = (1 if cfg.pre_filters > 0 else 0) + len(cfg.down_filters) \
            + len(cfg.post_filters)
        for i in range(n_enc):
            put("encoder", f"layer{i}", single_conv(f"encoder.model.{i}.conv"))
        if any(k.startswith("decoder.first") for k in flat):
            put("decoder", "first", single_conv("decoder.first", bn_index=2))
        for i in range(len(cfg.up_filters)):
            if cfg.scale_up_v2:
                ps = single_conv(f"decoder.model.{i}.conv", bn_index=2,
                                 transpose=True)
            else:
                ps = single_conv(f"decoder.model.{i}.conv.conv", bn_index=1)
            put("decoder", f"up{i}", ps)
        final_key = f"decoder.model.{len(cfg.up_filters)}.weight"
        if final_key in flat:
            params["decoder"]["final"] = {
                "weight": conv_from_torch(flat[final_key]),
                "bias": flat[f"decoder.model.{len(cfg.up_filters)}.bias"],
            }
        return params, state

    for part in ("encoder", "decoder"):
        names = sorted({k.split(".")[1] for k in flat
                        if k.startswith(part + ".")})
        for name in names:
            put(part, name, single_conv(
                f"{part}.{name}", bn_index=2,
                transpose=part == "decoder" and name.startswith("layer")))
    return params, state


def _args_dict(raw_args) -> Dict[str, Any]:
    """A checkpoint's ``args`` as a dict: a dict (EasyDict stand-ins are
    dict subclasses whose data lives in the dict itself, so ``vars()`` on
    them is empty), a stub's attributes, or an ``argparse.Namespace``."""
    if isinstance(raw_args, dict):
        return dict(raw_args)
    if isinstance(raw_args, tx.PersistentStub):
        return dict(tx.module_attrs(raw_args))
    return dict(vars(raw_args)) if hasattr(raw_args, "__dict__") else {}


def encoder_trees_from_checkpoint(enc_ckpt) -> Tuple[GeoEncoderConfig, Dict,
                                                     Dict]:
    """A reference encoder checkpoint ``{"args", "model_state"}`` (loaded)
    -> (config, params, state), numpy trees in the JAX layout."""
    cfg = encoder_config_from_args(_args_dict(enc_ckpt.get("args", {})))
    flat = {k: tx.to_numpy(v) for k, v in enc_ckpt["model_state"].items()}
    return (cfg, *convert_encoder_state(flat, cfg))


# ---------------------------------------------------------------------------
# TF-legacy (StyleGAN2 TensorFlow pickle) ingestion
# ---------------------------------------------------------------------------

def tf_collect_params(net) -> Dict[str, np.ndarray]:
    """Flatten a (stub-unpickled) dnnlib.tflib Network into name -> array
    (reference legacy.py:75-84: recurse .variables + .components)."""
    out: Dict[str, np.ndarray] = {}

    def recurse(prefix, s):
        for name, value in (s.get("variables") or []):
            out[prefix + name] = np.asarray(value)
        for name, comp in (s.get("components") or {}).items():
            recurse(prefix + name + "/", tx.module_attrs(comp))

    recurse("", tx.module_attrs(net))
    return out


def tf_generator_to_torch_layout(tf_params: Dict[str, np.ndarray],
                                 img_resolution: int
                                 ) -> Dict[str, np.ndarray]:
    """TF variable names/layouts -> the torch-name flat map that
    :func:`convert_generator_state` takes (reference legacy.py:109-205: TF
    conv weights are HWIO -- and stored flipped for up-convs -- ``mod_bias``
    is stored minus one, noise buffers are [1,1,H,W])."""
    # ToRGB_lod{n} aliases (progressive-growing export, legacy.py:159-164).
    for name in list(tf_params):
        m = re.fullmatch(r"ToRGB_lod(\d+)/(.*)", name)
        if m:
            r = img_resolution // (2 ** int(m.group(1)))
            tf_params[f"synthesis/{r}x{r}/ToRGB/{m.group(2)}"] = \
                tf_params[name]
    if any("/Skip/" in k for k in tf_params):
        raise ValueError("resnet-architecture TF pickles are not supported")

    flat: Dict[str, np.ndarray] = {}
    if "dlatent_avg" in tf_params:
        flat["mapping.w_avg"] = tf_params["dlatent_avg"]
    i = 0
    while f"mapping/Dense{i}/weight" in tf_params:
        flat[f"mapping.fc{i}.weight"] = \
            tf_params[f"mapping/Dense{i}/weight"].T
        flat[f"mapping.fc{i}.bias"] = tf_params[f"mapping/Dense{i}/bias"]
        i += 1

    def conv(dst, src, flip=False):
        w = tf_params[f"{src}/weight"]           # [kh, kw, in, out] (TF)
        if flip:
            w = w[::-1, ::-1]
        flat[f"{dst}.weight"] = np.ascontiguousarray(
            np.transpose(w, (3, 2, 0, 1)))        # -> torch OIHW
        flat[f"{dst}.bias"] = tf_params[f"{src}/bias"]

    def modulated(dst, src, noise_idx, flip=False):
        conv(dst, src, flip=flip)
        flat[f"{dst}.noise_strength"] = np.asarray(
            tf_params[f"{src}/noise_strength"])
        flat[f"{dst}.noise_const"] = \
            tf_params[f"synthesis/noise{noise_idx}"][0, 0]
        flat[f"{dst}.affine.weight"] = tf_params[f"{src}/mod_weight"].T
        flat[f"{dst}.affine.bias"] = tf_params[f"{src}/mod_bias"] + 1

    flat["synthesis.b4.const"] = tf_params["synthesis/4x4/Const/const"][0]
    modulated("synthesis.b4.conv1", "synthesis/4x4/Conv", 0)
    res = 8
    while f"synthesis/{res}x{res}/Conv1/weight" in tf_params:
        n = int(math.log2(res))
        modulated(f"synthesis.b{res}.conv0",
                  f"synthesis/{res}x{res}/Conv0_up", 2 * n - 5, flip=True)
        modulated(f"synthesis.b{res}.conv1",
                  f"synthesis/{res}x{res}/Conv1", 2 * n - 4)
        res *= 2
    for r in [4] + [2 ** k for k in range(3, int(math.log2(res)) + 1)]:
        src = f"synthesis/{r}x{r}/ToRGB"
        if f"{src}/weight" in tf_params:
            conv(f"synthesis.b{r}.torgb", src)
            flat[f"synthesis.b{r}.torgb.affine.weight"] = \
                tf_params[f"{src}/mod_weight"].T
            flat[f"synthesis.b{r}.torgb.affine.bias"] = \
                tf_params[f"{src}/mod_bias"] + 1
    return flat


def tf_generator_trees(path: str, which: str = "Gs"):
    """A TF-legacy StyleGAN2 pickle (a (G, D, Gs) tuple of tflib Networks,
    reference legacy.py:29-36) -> (gen_cfg, params, state) with numpy trees
    in the JAX layout; the 'orig' head (TF pickles predate NeuBE's heads
    and carry no geometry encoder)."""
    pkl = tx.load_reference_pickle(path)
    if isinstance(pkl, tuple):
        nets = dict(zip(["G", "D", "Gs"], pkl))
    elif isinstance(pkl, dict):
        nets = pkl
    else:
        raise ValueError(f"unexpected TF pickle structure in {path}")
    net = nets.get(which, nets.get("Gs", nets.get("G")))
    attrs = tx.module_attrs(net)
    if int(attrs.get("version", 0)) < 4:
        raise ValueError("TensorFlow pickle version too low (legacy.py:111)")
    kw = dict(attrs.get("static_kwargs") or {})

    img_resolution = int(kw.get("resolution", 1024))
    flat = tf_generator_to_torch_layout(tf_collect_params(net),
                                        img_resolution)
    gen_cfg = make_generator_config(
        z_dim=int(kw.get("latent_size", 512)),
        c_dim=int(kw.get("label_size", 0)),
        w_dim=int(kw.get("dlatent_size", 512)),
        img_resolution=img_resolution,
        img_channels=int(kw.get("num_channels", 3)),
        color_format="orig", architecture=kw.get("architecture", "skip"),
        channel_base=int(kw.get("fmap_base", 16384)) * 2,
        channel_max=int(kw.get("fmap_max", 512)),
        conv_clamp=kw.get("conv_clamp"),
        mapping_layers=int(kw.get("mapping_layers", 8)))
    return (gen_cfg, *convert_generator_state(flat, gen_cfg))


def convert_tf_generator_pkl(path: str, which: str = "Gs", device="cuda"):
    """:func:`tf_generator_trees` as the port's tensors on ``device``:
    (gen_cfg, params, state) for ``generator_apply``."""
    dev = resolve_device(device)
    gen_cfg, params, state = tf_generator_trees(path, which)
    return (gen_cfg, tree_to(params_from_jax(params), dev),
            tree_to(params_from_jax(state), dev))


def save_tf_generator(path: str, gen_cfg: GeneratorConfig, params,
                      state) -> None:
    """A converted TF generator as the JAX package's
    ``scripts/convert_checkpoint.py --kind tf`` writes it: the config as a
    dict and :func:`tf_generator_trees`' numpy trees in the JAX layout."""
    with open(path, "wb") as f:
        pickle.dump({"magic": TF_GENERATOR_MAGIC,
                     "gen_cfg": dataclasses.asdict(gen_cfg),
                     "gen_params": params, "gen_state": state}, f,
                    protocol=4)


def load_tf_generator(path: str, device="cuda"):
    """Read :func:`save_tf_generator`'s file: (gen_cfg, params, state) as
    the port's tensors on ``device``."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("magic") != TF_GENERATOR_MAGIC:
        raise ValueError(f"not a converted TF generator: {path}")
    gen_cfg, _ = configs_from_dicts(payload["gen_cfg"], {})
    return (gen_cfg, tree_to(params_from_jax(payload["gen_params"]), dev),
            tree_to(params_from_jax(payload["gen_state"]), dev))


# ---------------------------------------------------------------------------
# Snapshot conversion and the factory's format dispatch
# ---------------------------------------------------------------------------

def snapshot_trees(pkl, encoder_checkpoint: Optional[str] = None) -> Dict:
    """A loaded reference training snapshot (``G_ema`` + encoder) -> the
    configs and numpy trees in the JAX layout: ``{"gen_cfg", "gen_params",
    "gen_state", "enc_cfg", "enc_params", "enc_state", "color_format",
    "geom_inject_resolutions", "args"}``.  The encoder is the snapshot's, or
    else ``encoder_checkpoint``'s (a reference ``.pt``)."""
    if not isinstance(pkl, dict):
        raise ValueError("unexpected snapshot structure: "
                         f"{type(pkl).__name__}, not a dict")
    args = _args_dict(pkl.get("args", {}) or {})
    flat_g = tx.flatten_module_state(pkl.get("G_ema", pkl.get("G")))
    gen_cfg = infer_generator_config(flat_g, args)
    gen_params, gen_state = convert_generator_state(flat_g, gen_cfg)

    enc_ckpt = pkl.get("encoder")
    if enc_ckpt is None and encoder_checkpoint:
        enc_ckpt = tx.load_torch_file(encoder_checkpoint)
    if enc_ckpt is None:
        raise ValueError(
            "No geometry encoder found in snapshot and no encoder checkpoint "
            "given (reference brush.py:588-590)")
    enc_cfg, enc_params, enc_state = encoder_trees_from_checkpoint(enc_ckpt)
    return {"gen_cfg": gen_cfg, "gen_params": gen_params,
            "gen_state": gen_state, "enc_cfg": enc_cfg,
            "enc_params": enc_params, "enc_state": enc_state,
            "color_format": args.get("color_format", "triad"),
            "geom_inject_resolutions": tuple(
                args.get("geom_inject_resolutions", (0,))),
            "args": args}


def _bundle_from_trees(t: Dict, dev) -> EngineBundle:
    trees = [tree_to(params_from_jax(t[k]), dev) for k in
             ("gen_params", "gen_state", "enc_params", "enc_state")]
    return EngineBundle(
        t["gen_cfg"], *trees[:2], t["enc_cfg"], *trees[2:],
        color_format=t["color_format"],
        geom_inject_resolutions=t["geom_inject_resolutions"],
        extra={"args": t["args"]})


def convert_reference_snapshot(path: str,
                               encoder_checkpoint: Optional[str] = None,
                               device="cuda") -> EngineBundle:
    """Reference training snapshot pkl -> EngineBundle (G_ema + encoder) of
    the port's tensors on ``device``."""
    dev = resolve_device(device)
    return _bundle_from_trees(snapshot_trees(
        tx.load_reference_pickle(path), encoder_checkpoint), dev)


def load_engine_bundle(gan_checkpoint: str,
                       encoder_checkpoint: Optional[str] = None,
                       device="cuda") -> EngineBundle:
    """A native bundle, or else a converted reference snapshot (reference
    brush.py:552-604), on ``device``.

    The file is read once, by the restricted unpickler; only a file that
    holds no native bundle is converted.  A file that cannot be read, or a
    native bundle that fails to load, raises its own error."""
    dev = resolve_device(device)
    payload = tx.load_reference_pickle(gan_checkpoint)
    if _is_native(payload):
        return _bundle_from_payload(payload, dev)
    logger.info("%s is not a native bundle; converting it as a reference "
                "snapshot", gan_checkpoint)
    return _bundle_from_trees(snapshot_trees(payload, encoder_checkpoint),
                              dev)
