"""Write model weights in the reference's checkpoint layouts.

The inverse of the conversion in :mod:`utils.checkpoint`: numpy trees in the
JAX package's layout (as ``init_native_params`` draws them) become

  * the reference's state-dict names and layouts (generator, discriminator,
    'sauto' and 'conv' encoders) -- :func:`generator_state_dict`,
    :func:`discriminator_state_dict`, :func:`encoder_state_dict` and the
    encoder's ``args`` (:func:`encoder_args`);
  * a training snapshot pickled as the reference's ``persistence`` module
    pickles one (``{G, G_ema, D, args, encoder}``, every network a
    ``torch_utils.persistence._reconstruct_persistent_obj`` record holding
    ``_parameters`` / ``_buffers`` / ``_modules``) --
    :func:`write_reference_snapshot`;
  * a TF-legacy StyleGAN2 pickle (a (G, D, Gs) tuple of
    ``dnnlib.tflib.network.Network`` records with TF variable names) --
    :func:`write_tf_pickle`.

  * a CLIP checkpoint in OpenAI's state-dict layout at given widths
    (ViT-B/32's by default) -- :func:`clip_state_dict` -- and a byte-BPE
    merges file in CLIP's format -- :func:`write_bpe_merges`;
  * the metric detectors' published layouts: torchvision's Inception-v3
    feature extractor (:func:`inception_state_dict`), the ``lpips``
    package's AlexNet (:func:`lpips_state_dict`) and torchvision's VGG16 at
    a width divisor (:func:`vgg16_state_dict`).

So a smoke run or a test can build the files a user of the reference owns
from seeded weights, with no code of the reference.  The pickles name the
reference's globals through stand-in modules that exist only while they are
written.
"""

from __future__ import annotations

import contextlib
import gzip
import math
import pickle
import sys
import types
from typing import Dict, Optional

import numpy as np
import torch

from brushstroke_engine_torch.models.generator import GeneratorConfig
from brushstroke_engine_torch.models.geo_encoder import GeoEncoderConfig

_BUFFERS = ("noise_const", "w_avg", "running_mean", "running_var")


def _fc(flat, prefix, p):
    flat[prefix + ".weight"] = np.ascontiguousarray(np.asarray(p["weight"]).T)
    if "bias" in p:
        flat[prefix + ".bias"] = np.asarray(p["bias"])


def _oihw(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def generator_state_dict(cfg: GeneratorConfig, params, state) -> Dict:
    """A generator's JAX-layout (params, state) -> the reference's state
    dict (numpy)."""
    flat = {}
    mp = params["mapping"]
    for name in mp:
        _fc(flat, f"mapping.{name}", mp[name])
    if "w_avg" in state:
        flat["mapping.w_avg"] = np.asarray(state["w_avg"])
    for res in cfg.synthesis.block_resolutions:
        bp, b = params["synthesis"][f"b{res}"], f"synthesis.b{res}"
        if "const" in bp:
            flat[f"{b}.const"] = np.ascontiguousarray(
                np.transpose(np.asarray(bp["const"]), (2, 0, 1)))
        for conv in ("conv0", "conv1"):
            if conv not in bp:
                continue
            cp = bp[conv]
            _fc(flat, f"{b}.{conv}.affine", cp["affine"])
            flat[f"{b}.{conv}.weight"] = _oihw(cp["weight"])
            flat[f"{b}.{conv}.bias"] = np.asarray(cp["bias"])
            flat[f"{b}.{conv}.noise_strength"] = np.asarray(
                cp["noise_strength"], np.float32)
            key = f"b{res}.{conv}.noise_const"
            if key in state.get("noise", {}):
                flat[f"{b}.{conv}.noise_const"] = np.asarray(
                    state["noise"][key])
        if "torgb" in bp:
            tp = bp["torgb"]
            _fc(flat, f"{b}.torgb.affine", tp["affine"])
            flat[f"{b}.torgb.weight"] = _oihw(tp["weight"])
            flat[f"{b}.torgb.bias"] = np.asarray(tp["bias"])
            if "color_bias" in tp:
                flat[f"{b}.torgb.color_bias"] = np.asarray(tp["color_bias"])
            if "color_affine" in tp:
                _fc(flat, f"{b}.torgb.color_affine", tp["color_affine"])
    return flat


def discriminator_state_dict(cfg, params) -> Dict:
    """A discriminator's JAX-layout params -> the reference's state dict
    (the epilogue FC's columns back in NCHW flattening order)."""
    flat = {}
    for block, bp in params.items():
        if block == "mapping":
            for name in bp:
                _fc(flat, f"mapping.{name}", bp[name])
            continue
        for name, p in bp.items():
            prefix = f"{block}.{name}"
            if block == "b4" and name == "fc":
                ch4 = cfg.channels(4)
                w = np.asarray(p["weight"]).T                  # [out, HWC]
                w = w.reshape(-1, 4, 4, ch4).transpose(0, 3, 1, 2)
                flat[prefix + ".weight"] = np.ascontiguousarray(
                    w.reshape(w.shape[0], -1))
                flat[prefix + ".bias"] = np.asarray(p["bias"])
            elif block == "b4" and name == "out":
                _fc(flat, prefix, p)
            else:
                flat[prefix + ".weight"] = _oihw(p["weight"])
                if "bias" in p:
                    flat[prefix + ".bias"] = np.asarray(p["bias"])
    return flat


def _single_conv(flat, prefix, p, s, bn_index, transpose=False):
    w = np.asarray(p["conv"]["weight"])
    flat[prefix + ".0.weight"] = np.ascontiguousarray(
        np.transpose(w, (2, 3, 0, 1)) if transpose else _oihw(w))
    flat[prefix + ".0.bias"] = np.asarray(p["conv"]["bias"])
    bn = f"{prefix}.{bn_index}"
    flat[bn + ".weight"] = np.asarray(p["bn"]["scale"])
    flat[bn + ".bias"] = np.asarray(p["bn"]["bias"])
    flat[bn + ".running_mean"] = np.asarray(s["bn"]["mean"])
    flat[bn + ".running_var"] = np.asarray(s["bn"]["var"])


def encoder_state_dict(cfg: GeoEncoderConfig, params, state) -> Dict:
    """A geometry encoder's JAX-layout (params, state) -> the reference's
    state dict: 'sauto' (SingleConvolution, ScaleUp / ScaleUpV2, final 1x1)
    or 'conv' (ae_conv.py Sequentials)."""
    flat = {}
    enc_p, enc_s = params["encoder"], state["encoder"]
    dec_p, dec_s = params["decoder"], state["decoder"]
    if cfg.kind == "conv":
        for part, p, s in (("encoder", enc_p, enc_s),
                           ("decoder", dec_p, dec_s)):
            for name in p:
                _single_conv(flat, f"{part}.{name}", p[name], s[name], 2,
                             transpose=part == "decoder"
                             and name.startswith("layer"))
        return flat
    bn_idx = 2 if cfg.batchnorm_after_activation else 1
    for i in range(len(enc_p)):
        _single_conv(flat, f"encoder.model.{i}.conv", enc_p[f"layer{i}"],
                     enc_s[f"layer{i}"], bn_idx)
    if "first" in dec_p:
        _single_conv(flat, "decoder.first", dec_p["first"], dec_s["first"], 2)
    n_up = len(cfg.up_filters)
    for i in range(n_up):
        if cfg.scale_up_v2:
            _single_conv(flat, f"decoder.model.{i}.conv", dec_p[f"up{i}"],
                         dec_s[f"up{i}"], 2, transpose=True)
        else:
            _single_conv(flat, f"decoder.model.{i}.conv.conv",
                         dec_p[f"up{i}"], dec_s[f"up{i}"], 1)
    if "final" in dec_p:
        flat[f"decoder.model.{n_up}.weight"] = _oihw(dec_p["final"]["weight"])
        flat[f"decoder.model.{n_up}.bias"] = np.asarray(
            dec_p["final"]["bias"])
    return flat


def encoder_args(cfg: GeoEncoderConfig) -> Dict:
    """The reference autoencoder's ``args`` that describe ``cfg``."""
    common = {"model_name": cfg.kind, "encoder_in_channels": cfg.in_channels,
              "decoder_out_channels": cfg.out_channels,
              "preproc_type": cfg.preproc}
    if cfg.kind == "conv":
        return dict(common, width=cfg.img_width, emb_channel=cfg.emb_channel,
                    channel_factor=cfg.channel_factor,
                    enc_layer=cfg.num_layers)
    return dict(common, encoder_pre_filters=cfg.pre_filters,
                encoder_down_filters=",".join(map(str, cfg.down_filters)),
                encoder_post_filters=",".join(map(str, cfg.post_filters)),
                decoder_up_filters=",".join(map(str, cfg.up_filters)),
                decoder_pre_filters=cfg.decoder_pre_filters,
                neg_slope=cfg.neg_slope)


# ---------------------------------------------------------------------------
# Pickles
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _stand_in(module_path: str, name: str, fn):
    """``module_path.name`` resolvable as ``fn`` while a pickle is written."""
    parts = module_path.split(".")
    added = []
    for i in range(len(parts)):
        mod_name = ".".join(parts[:i + 1])
        if mod_name not in sys.modules:
            sys.modules[mod_name] = types.ModuleType(mod_name)
            added.append(mod_name)
    setattr(sys.modules[module_path], name, fn)
    fn.__module__, fn.__qualname__, fn.__name__ = module_path, name, name
    try:
        yield
    finally:
        for mod_name in added:
            del sys.modules[mod_name]


def _reconstruct_persistent_obj(meta):
    raise RuntimeError("a stand-in: read this pickle with "
                       "utils.torch_extract.load_reference_pickle")


def _tf_network(state):
    raise RuntimeError("a stand-in: read this pickle with "
                       "utils.torch_extract.load_reference_pickle")


class _Persisted:
    """Pickles as the reference's persistence record of a module."""

    def __init__(self, meta, reconstruct):
        self.meta, self.reconstruct = meta, reconstruct

    def __reduce__(self):
        return (self.reconstruct, (self.meta,))


def _tensor(a) -> torch.Tensor:
    """A CPU tensor of ``a``'s values and shape (0-d included)."""
    return torch.from_numpy(np.array(a, copy=True))


def module_state(flat: Dict) -> Dict:
    """A flat state dict -> nested nn.Module ``__dict__`` state
    (``_parameters`` / ``_buffers`` / ``_modules``) of torch tensors."""
    root = {"_parameters": {}, "_buffers": {}, "_modules": {}}
    for key, value in flat.items():
        node = root
        *path, leaf = key.split(".")
        for part in path:
            node = node["_modules"].setdefault(
                part, {"_parameters": {}, "_buffers": {}, "_modules": {}})
        kind = "_buffers" if leaf in _BUFFERS else "_parameters"
        node[kind][leaf] = _tensor(value)
    return root


def write_reference_snapshot(path: str, gen_flat: Dict, args: Dict,
                             encoder: Optional[Dict] = None,
                             disc_flat: Optional[Dict] = None) -> None:
    """A training snapshot as the reference writes it: ``G`` and ``G_ema``
    (and ``D``) as persistence records, ``args``, and ``encoder`` =
    ``{"args", "model_state"}`` when given."""
    def persisted(flat):
        return _Persisted({"type": "class", "version": 2,
                           "state": module_state(flat)},
                          _reconstruct_persistent_obj)
    snap = {"G": persisted(gen_flat), "G_ema": persisted(gen_flat),
            "args": args}
    if disc_flat is not None:
        snap["D"] = persisted(disc_flat)
    if encoder is not None:
        snap["encoder"] = {
            "args": encoder["args"],
            "model_state": {k: _tensor(v)
                            for k, v in encoder["model_state"].items()}}
    with _stand_in("torch_utils.persistence", "_reconstruct_persistent_obj",
                   _reconstruct_persistent_obj):
        with open(path, "wb") as f:
            pickle.dump(snap, f, protocol=4)


def tf_variables(gen_flat: Dict, cfg: GeneratorConfig) -> Dict:
    """The reference's generator state dict -> the TF variables of a
    StyleGAN2 ``Gs`` (legacy.py:109-205 read backwards: HWIO weights, the
    up-convs stored flipped, ``mod_bias`` minus one, noise ``[1,1,H,W]``)."""
    tf = {}
    if "mapping.w_avg" in gen_flat:
        tf["dlatent_avg"] = gen_flat["mapping.w_avg"]
    for i in range(cfg.mapping_layers):
        tf[f"mapping/Dense{i}/weight"] = np.ascontiguousarray(
            gen_flat[f"mapping.fc{i}.weight"].T)
        tf[f"mapping/Dense{i}/bias"] = gen_flat[f"mapping.fc{i}.bias"]
    tf["synthesis/4x4/Const/const"] = gen_flat["synthesis.b4.const"][None]

    def put(dst, src, noise_idx=None, flip=False):
        w = np.transpose(gen_flat[f"{src}.weight"], (2, 3, 1, 0))
        tf[f"{dst}/weight"] = np.ascontiguousarray(w[::-1, ::-1] if flip
                                                   else w)
        tf[f"{dst}/bias"] = gen_flat[f"{src}.bias"]
        tf[f"{dst}/mod_weight"] = np.ascontiguousarray(
            gen_flat[f"{src}.affine.weight"].T)
        tf[f"{dst}/mod_bias"] = gen_flat[f"{src}.affine.bias"] - 1
        if noise_idx is not None:
            tf[f"{dst}/noise_strength"] = gen_flat[f"{src}.noise_strength"]
            tf[f"synthesis/noise{noise_idx}"] = \
                gen_flat[f"{src}.noise_const"][None, None]

    put("synthesis/4x4/Conv", "synthesis.b4.conv1", noise_idx=0)
    for res in cfg.synthesis.block_resolutions:
        n = int(math.log2(res))
        if res > 4:
            put(f"synthesis/{res}x{res}/Conv0_up", f"synthesis.b{res}.conv0",
                noise_idx=2 * n - 5, flip=True)
            put(f"synthesis/{res}x{res}/Conv1", f"synthesis.b{res}.conv1",
                noise_idx=2 * n - 4)
        if f"synthesis.b{res}.torgb.weight" in gen_flat:
            put(f"synthesis/{res}x{res}/ToRGB", f"synthesis.b{res}.torgb")
    return tf


def write_tf_pickle(path: str, gen_flat: Dict, cfg: GeneratorConfig) -> None:
    """A TF-legacy StyleGAN2 pickle of the generator: (G, D, Gs), each a
    version-4 ``Network`` record with the static kwargs of ``cfg`` (the
    'orig' head; ``fmap_base`` is half the port's ``channel_base``)."""
    syn = cfg.synthesis
    state = {
        "version": 4,
        "static_kwargs": {
            "latent_size": cfg.z_dim, "dlatent_size": cfg.w_dim,
            "label_size": cfg.c_dim, "resolution": cfg.img_resolution,
            "num_channels": cfg.img_channels,
            "mapping_layers": cfg.mapping_layers,
            "fmap_base": syn.channel_base // 2, "fmap_max": syn.channel_max,
            "architecture": syn.architecture, "conv_clamp": syn.conv_clamp},
        "components": {},
        "variables": list(tf_variables(gen_flat, cfg).items()),
    }
    net = _Persisted(state, _tf_network)
    with _stand_in("dnnlib.tflib.network", "Network", _tf_network):
        with open(path, "wb") as f:
            pickle.dump((net, net, net), f, protocol=4)


#: CLIP ViT-B/32's widths (OpenAI's published configuration).
VIT_B32 = dict(embed_dim=512, image_resolution=224, vision_patch=32,
               vision_width=768, vision_layers=12, text_width=512,
               text_layers=12, context_length=77, vocab_size=49408)


def clip_state_dict(seed: int = 0, widths: Optional[Dict] = None
                    ) -> Dict[str, torch.Tensor]:
    """A seeded CLIP state dict with OpenAI's names and layouts
    (``visual.conv1.weight`` OIHW, ``*.attn.in_proj_weight`` ``[3D, D]``,
    ``text_projection`` ``[text_width, embed_dim]``, ...) at ``widths``
    (keys of :data:`VIT_B32`).  Weights are scaled by their fan-in and the
    LayerNorms perturbed from identity, so every tensor counts."""
    w = dict(VIT_B32 if widths is None else widths)
    gen = torch.Generator().manual_seed(seed)
    sd: Dict[str, torch.Tensor] = {}

    def randn(*shape, std):
        return torch.randn(shape, generator=gen) * std

    def ln(prefix, d):
        sd[f"{prefix}.weight"] = 1.0 + randn(d, std=0.1)
        sd[f"{prefix}.bias"] = randn(d, std=0.1)

    def blocks(prefix, d, layers):
        for i in range(layers):
            b = f"{prefix}.resblocks.{i}"
            sd[f"{b}.attn.in_proj_weight"] = randn(3 * d, d, std=d ** -0.5)
            sd[f"{b}.attn.in_proj_bias"] = randn(3 * d, std=0.02)
            sd[f"{b}.attn.out_proj.weight"] = randn(d, d, std=d ** -0.5)
            sd[f"{b}.attn.out_proj.bias"] = randn(d, std=0.02)
            ln(f"{b}.ln_1", d)
            sd[f"{b}.mlp.c_fc.weight"] = randn(4 * d, d, std=d ** -0.5)
            sd[f"{b}.mlp.c_fc.bias"] = randn(4 * d, std=0.02)
            sd[f"{b}.mlp.c_proj.weight"] = randn(d, 4 * d,
                                                 std=(4 * d) ** -0.5)
            sd[f"{b}.mlp.c_proj.bias"] = randn(d, std=0.02)
            ln(f"{b}.ln_2", d)

    vw, tw, p = w["vision_width"], w["text_width"], w["vision_patch"]
    grid = w["image_resolution"] // p
    sd["visual.conv1.weight"] = randn(vw, 3, p, p, std=(3 * p * p) ** -0.5)
    sd["visual.class_embedding"] = randn(vw, std=vw ** -0.5)
    sd["visual.positional_embedding"] = randn(grid * grid + 1, vw,
                                              std=vw ** -0.5)
    ln("visual.ln_pre", vw)
    blocks("visual.transformer", vw, w["vision_layers"])
    ln("visual.ln_post", vw)
    sd["visual.proj"] = randn(vw, w["embed_dim"], std=vw ** -0.5)
    sd["token_embedding.weight"] = randn(w["vocab_size"], tw, std=0.02)
    sd["positional_embedding"] = randn(w["context_length"], tw, std=0.01)
    blocks("transformer", tw, w["text_layers"])
    ln("ln_final", tw)
    sd["text_projection"] = randn(tw, w["embed_dim"], std=tw ** -0.5)
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    return sd


def bpe_merges_for(words) -> list:
    """Merges that build each word whole, left to right (``"i n"``,
    ``"in k</w>"`` for 'ink'), in first-use order without repeats."""
    merges = []
    for word in words:
        pieces = list(word[:-1]) + [word[-1] + "</w>"]
        left = pieces[0]
        for right in pieces[1:]:
            m = f"{left} {right}"
            if m not in merges:
                merges.append(m)
            left += right
    return merges


def write_bpe_merges(path: str, merges) -> None:
    """A merges file in CLIP's format (a version line, then one merge per
    line); gzipped when ``path`` ends in ``.gz``."""
    text = "\n".join(["#version: 0.2"] + list(merges)) + "\n"
    if path.endswith(".gz"):
        with gzip.open(path, "wt", encoding="utf-8") as f:
            f.write(text)
    else:
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)


def inception_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """torchvision ``inception_v3`` names and layouts (``<conv>.conv.weight``
    OIHW, ``<conv>.bn.*``) for every conv of the feature extractor: He-init
    weights from ``np.random.RandomState(seed)``, batch norms perturbed from
    identity."""
    from brushstroke_engine_torch.metrics.inception import CONVS
    rng = np.random.RandomState(seed)
    sd: Dict[str, torch.Tensor] = {}
    for (name, cin, cout, (kh, kw), _s, _p) in CONVS:
        std = float(np.sqrt(2.0 / (kh * kw * cin)))
        sd[f"{name}.conv.weight"] = _tensor(
            (std * rng.randn(cout, cin, kh, kw)).astype(np.float32))
        sd[f"{name}.bn.weight"] = _tensor(
            (1 + 0.05 * rng.randn(cout)).astype(np.float32))
        sd[f"{name}.bn.bias"] = _tensor(
            (0.05 * rng.randn(cout)).astype(np.float32))
        sd[f"{name}.bn.running_mean"] = _tensor(
            (0.05 * rng.randn(cout)).astype(np.float32))
        sd[f"{name}.bn.running_var"] = _tensor(
            (1 + 0.1 * rng.rand(cout)).astype(np.float32))
    return sd


def lpips_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """The ``lpips`` package's AlexNet state dict (``net.slice{i}.{j}`` convs
    OIHW, ``lin{i}.model.1.weight`` ``[1, C, 1, 1]`` calibration) of seeded
    weights."""
    from brushstroke_engine_torch.metrics.lpips import _ALEX_PLAN
    rng = np.random.RandomState(seed)
    sd: Dict[str, torch.Tensor] = {}
    cin = 3
    for i, ((cout, k, _s, _p), j) in enumerate(zip(_ALEX_PLAN,
                                                    (0, 3, 6, 8, 10))):
        std = float(np.sqrt(2.0 / (k * k * cin)))
        sd[f"net.slice{i + 1}.{j}.weight"] = _tensor(
            (std * rng.randn(cout, cin, k, k)).astype(np.float32))
        sd[f"net.slice{i + 1}.{j}.bias"] = _tensor(
            (0.01 * rng.randn(cout)).astype(np.float32))
        sd[f"lin{i}.model.1.weight"] = _tensor(
            (rng.rand(1, cout, 1, 1) / cout).astype(np.float32))
        cin = cout
    return sd


def vgg16_state_dict(seed: int = 0, width_div: int = 1,
                     fc: int = 4096) -> Dict[str, torch.Tensor]:
    """torchvision ``vgg16`` names and layouts (``features.N`` convs OIHW,
    ``classifier.0`` / ``.3`` ``[out, in]``) with every conv width divided
    by ``width_div`` and ``fc`` units per hidden layer: He-init weights from
    ``np.random.RandomState(seed)``."""
    from brushstroke_engine_torch.metrics.pr import _VGG_PLAN
    rng = np.random.RandomState(seed)
    sd: Dict[str, torch.Tensor] = {}
    cin, idx = 3, 0
    for spec in _VGG_PLAN:
        if spec == "M":
            idx += 1
            continue
        cout = int(spec) // width_div
        std = float(np.sqrt(2.0 / (9 * cin)))
        sd[f"features.{idx}.weight"] = _tensor(
            (std * rng.randn(cout, cin, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = _tensor(np.zeros(cout, np.float32))
        cin, idx = cout, idx + 2
    fin = cin * 49
    for i in (0, 3):
        sd[f"classifier.{i}.weight"] = _tensor(
            (np.sqrt(2.0 / fin) * rng.randn(fc, fin)).astype(np.float32))
        sd[f"classifier.{i}.bias"] = _tensor(np.zeros(fc, np.float32))
        fin = fc
    return sd
