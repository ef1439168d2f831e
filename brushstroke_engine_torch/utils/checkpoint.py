"""Native bundles and the JAX-layout -> torch-layout parameter conversion.

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

:func:`init_native_params` builds flagship-shaped random trees in the JAX
layout from a numpy seed, so a run needs no checkpoint and no JAX.
"""

from __future__ import annotations

import dataclasses
import pickle
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from brushstroke_engine_torch.models.generator import GeneratorConfig
from brushstroke_engine_torch.models.geo_encoder import GeoEncoderConfig
from brushstroke_engine_torch.models.synthesis import SynthesisConfig
from brushstroke_engine_torch.utils.util import resolve_device, tree_to

NATIVE_MAGIC = "brushstroke_engine_tpu.bundle.v1"


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
    """Config dicts of a native bundle -> (GeneratorConfig, GeoEncoderConfig)."""
    gen_d = _tupled(gen_cfg, ("posenc_inject_resolutions",))
    syn = _tupled(gen_d.pop("synthesis"), (
        "geom_feature_resolutions", "geom_feature_channels",
        "resample_taps", "pos_encoding_resolutions"))
    gen = GeneratorConfig(synthesis=SynthesisConfig(**syn), **gen_d)
    enc = GeoEncoderConfig(**_tupled(
        enc_cfg, ("down_filters", "post_filters", "up_filters")))
    return gen, enc


def load_native(path: str, device="cuda") -> EngineBundle:
    """Read a native bundle; its trees become the port's tensors on
    ``device`` (raises without CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("magic") != NATIVE_MAGIC:
        raise ValueError(f"not a native bundle: {path}")
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
        "enc_cfg": dataclasses.asdict(bundle.enc_cfg),
        **{k: params_to_jax(getattr(bundle, k)) for k in
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
    """The triad or canvas head; colors from the style affine or, with
    ``color_w_channels``, from a ``color_affine`` of their own."""
    if scfg.color_format == "orig":
        raise NotImplementedError("the 'orig' output head is not ported yet")
    out_ch = scfg.img_channels + scfg.torgb_extra_channels
    cw = scfg.color_w_channels
    p = {"affine": _fc(rng, scfg.w_dim, in_ch + (0 if cw else 9),
                       bias_init=1.0)}
    if cw:
        p["color_affine"] = _fc(rng, cw, 9)
    p.update(weight=_randn(rng, 1, 1, in_ch, out_ch),
             bias=np.zeros((out_ch,), np.float32),
             color_bias=np.zeros((9,), np.float32))
    return p


def _init_generator(cfg: GeneratorConfig, rng):
    mcfg = cfg.mapping
    feats = mcfg.features_list
    mapping = {f"fc{i}": _fc(rng, feats[i], feats[i + 1], mcfg.lr_multiplier)
               for i in range(mcfg.num_layers)}
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
    if cfg.kind != "sauto":
        raise NotImplementedError(f"the {cfg.kind!r} encoder is not ported")
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


def _init_discriminator(cfg, rng):
    """Shapes and distributions of the JAX ``discriminator_init``."""
    if cfg.c_dim > 0:
        raise NotImplementedError(
            "the conditional discriminator is not ported yet")

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
                    "out": _fc(rng, ch4, 1)}
    return params


def init_native_params(gen_cfg: GeneratorConfig, enc_cfg: GeoEncoderConfig,
                       seed: int = 0, disc_cfg=None) -> Dict:
    """Random numpy trees in the JAX layout from ``RandomState(seed)``:
    ``{"gen_params", "gen_state", "enc_params", "enc_state"}``, plus
    ``"disc_params"`` for a ``DiscriminatorConfig`` (drawn last, so the other
    trees do not depend on it)."""
    rng = np.random.RandomState(seed)
    enc_params, enc_state = _init_encoder(enc_cfg, rng)
    gen_params, gen_state = _init_generator(gen_cfg, rng)
    trees = {"gen_params": gen_params, "gen_state": gen_state,
             "enc_params": enc_params, "enc_state": enc_state}
    if disc_cfg is not None:
        trees["disc_params"] = _init_discriminator(disc_cfg, rng)
    return trees


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
