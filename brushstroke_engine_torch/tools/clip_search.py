"""Text-driven brush search and optimization.

Counterpart of ``brushstroke_engine_tpu/tools/clip_search.py``:

  * :class:`FeatureDictionary`: embed style thumbnails (brush icons) and
    answer a text query with the top-k styles by cosine similarity;
  * :class:`ClipStyleOptimizer`: optimize a style's W+ (and optionally its
    noise) toward a text embedding, with background-clarity and
    geometry-adherence terms.

The backbone is pluggable (:class:`ClipBackbone`) and carries a ``kind``
label that search outputs print:

  * :class:`CLIPBackbone` (``kind="clip"``): the CLIP architecture of
    :mod:`.clip_model` over an OpenAI CLIP checkpoint; with pretrained
    weights, text -> style search is semantic;
  * :class:`HashingBackbone` (``kind="hashing"``): a deterministic
    random-projection embedder (words -> hashed bag of words on the unit
    sphere; images -> random conv features), the no-weights fallback.  Its
    rankings are NOT semantic.  A word's vector is seeded from a stable
    hash of the word (``zlib.crc32``), so an embedding is the same in every
    process; the JAX package seeds it from Python's ``hash``, which is
    randomized per process.
"""

from __future__ import annotations

import logging
import pickle
import re
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from brushstroke_engine_torch.utils.util import resolve_device

logger = logging.getLogger(__name__)

EMBED_DIM = 256


class ClipBackbone:
    """Interface: ``encode_image([B, H, W, 3] float [0, 1] tensor)`` ->
    ``[B, D]`` unit vectors (differentiable); ``encode_text(list[str])`` ->
    ``[N, D]`` unit vectors.  ``kind`` labels the backbone in search outputs
    (semantic or fallback)."""

    dim = EMBED_DIM
    kind = "abstract"
    device = torch.device("cpu")

    def encode_image(self, images) -> torch.Tensor:
        raise NotImplementedError

    def encode_text(self, texts: List[str]) -> torch.Tensor:
        raise NotImplementedError


class CLIPBackbone(ClipBackbone):
    """The CLIP model (``tools/clip_model.py``) over OpenAI weights."""

    kind = "clip"

    def __init__(self, weights_path: str, bpe_path: Optional[str] = None,
                 device="cuda"):
        from brushstroke_engine_torch.tools import clip_model as cm
        self.device = resolve_device(device)
        self.cfg, self.params, self.tokenizer = cm.load_openai_clip(
            weights_path, bpe_path, device=self.device)
        self.dim = self.cfg.embed_dim
        self._cm = cm

    def encode_image(self, images) -> torch.Tensor:
        return self._cm.encode_image(self.cfg, self.params, images)

    def encode_text(self, texts: List[str]) -> torch.Tensor:
        if self.tokenizer is None:
            raise ValueError("text encoding needs the BPE merges file "
                             "(bpe_path)")
        return self._cm.encode_text(self.cfg, self.params,
                                    self.tokenizer(texts))


def word_seed(word: str, seed: int) -> int:
    """The seed of one word's vector: a stable hash of the word and the
    backbone's seed (the same in every process), masked to 31 bits."""
    return zlib.crc32(f"{seed}\x00{word}".encode("utf-8")) & 0x7fffffff


class HashingBackbone(ClipBackbone):
    """Deterministic fallback backbone (no pretrained weights); NOT semantic.

    ``conv`` (``[8, 8, 3, 64]`` HWIO) and ``proj`` (``[64, dim]``) are the
    image tower's random weights: given (the parity tests carry the JAX
    package's across), else drawn from a ``torch.Generator`` seeded with
    ``seed``."""

    kind = "hashing"

    def __init__(self, seed: int = 0, dim: int = EMBED_DIM, device="cuda",
                 conv=None, proj=None):
        self.dim = dim
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        if conv is None:
            conv = 0.1 * torch.randn((8, 8, 3, 64), generator=gen)
        if proj is None:
            proj = torch.randn((64, dim), generator=gen) / 8.0
        self._conv = torch.as_tensor(np.array(conv, np.float32)).permute(
            3, 2, 0, 1).contiguous().to(self.device)       # -> OIHW
        self._proj = torch.as_tensor(np.array(proj, np.float32),
                                     device=self.device)
        self._seed = seed

    def encode_image(self, images) -> torch.Tensor:
        x = images.float().permute(0, 3, 1, 2) * 2 - 1
        feats = F.conv2d(x, self._conv, stride=8)
        emb = F.relu(feats).mean(dim=(2, 3)) @ self._proj
        return emb / emb.norm(dim=-1, keepdim=True)

    def encode_text(self, texts: List[str]) -> torch.Tensor:
        out = []
        for text in texts:
            vec = np.zeros(self.dim, np.float64)
            for word in re.findall(r"\w+", text.lower()):
                vec += np.random.RandomState(
                    word_seed(word, self._seed)).randn(self.dim)
            n = np.linalg.norm(vec)
            out.append(vec / n if n > 0 else vec)
        return torch.as_tensor(np.stack(out), dtype=torch.float32,
                               device=self.device)


def default_backbone(device="cuda") -> ClipBackbone:
    """CLIP ViT-B/32 when its weights are installed (``utils.weights``),
    else the labelled hashing fallback."""
    from brushstroke_engine_torch.utils.weights import find_weights
    path = find_weights("clip")
    if path:
        return CLIPBackbone(path, find_weights("clip_bpe"), device=device)
    return HashingBackbone(device=device)


class FeatureDictionary:
    """Style-thumbnail embedding index for text queries."""

    def __init__(self, backbone: Optional[ClipBackbone] = None):
        self.backbone = backbone or default_backbone()
        self.keys: List[str] = []
        self.features: Optional[np.ndarray] = None

    def add_images(self, keys: List[str], images):
        """images: ``[N, H, W, 3]`` float [0, 1] thumbnails (numpy)."""
        with torch.no_grad():
            emb = self.backbone.encode_image(torch.as_tensor(
                np.asarray(images, np.float32),
                device=self.backbone.device)).cpu().numpy()
        if self.features is None:
            self.features = emb
            self.keys = list(keys)
        else:
            self.features = np.concatenate([self.features, emb], axis=0)
            self.keys.extend(keys)

    def build_from_library(self, library, mapper, width: int = 128):
        """Embed the brush icon of every style of a library."""
        from brushstroke_engine_torch.engine.brush import GanBrushOptions
        ids = library.get_style_ids()
        icons = []
        for style_id in ids:
            opts = GanBrushOptions()
            library.set_style(style_id, opts)
            icons.append(mapper.get_brush_icon(opts).astype(np.float32)
                         / 255.0)
        self.add_images(ids, np.stack(icons))

    def get_top_results(self, query: str, k: int = 10
                        ) -> List[Tuple[str, float]]:
        if self.features is None:
            raise ValueError("the dictionary is empty")
        with torch.no_grad():
            text = self.backbone.encode_text([query]).cpu().numpy()[0]
        sims = self.features @ text
        order = np.argsort(-sims)[:k]
        return [(self.keys[i], float(sims[i])) for i in order]

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump({"keys": self.keys, "features": self.features}, f)

    @staticmethod
    def load(path: str, backbone: Optional[ClipBackbone] = None
             ) -> "FeatureDictionary":
        with open(path, "rb") as f:
            data = pickle.load(f)
        d = FeatureDictionary(backbone)
        d.keys = data["keys"]
        d.features = data["features"]
        return d


@dataclass(frozen=True)
class ClipOptConfig:
    num_steps: int = 300
    learning_rate: float = 0.02
    clip_weight: float = 1.0
    bg_weight: float = 0.5          # background clarity (uvs S over BG)
    geom_weight: float = 0.5        # geometry adherence (iou_inv)
    noise_reg_weight: float = 10.0
    optimize_noise: bool = False


class ClipStyleOptimizer:
    """Optimize W+ toward a text embedding.

    Per step: render the current style on a fresh geometry batch, embed the
    white-composited render, maximize its cosine similarity to the text
    embedding, plus the clarity and adherence terms.
    """

    def __init__(self, engine, backbone: Optional[ClipBackbone] = None,
                 cfg: ClipOptConfig = ClipOptConfig()):
        self.engine = engine
        self.backbone = backbone or HashingBackbone(device=engine.device)
        self.cfg = cfg

    def step_loss(self, params, geom, text_emb):
        """(total, clip loss) of ``params`` ({'w'[, 'noise']}) on one
        geometry batch ``[B, W, W, 1]`` (a tensor on the engine's device)."""
        from brushstroke_engine_torch.models.generator import generator_apply
        from brushstroke_engine_torch.models.geo_encoder import \
            geo_encoder_encode
        from brushstroke_engine_torch.tools.projection import \
            _noise_autocorr_reg
        from brushstroke_engine_torch.train.losses import compute_iou

        cfg, engine = self.cfg, self.engine
        with torch.no_grad():
            feats = geo_encoder_encode(engine.enc_cfg, engine.enc_params,
                                       engine.enc_state, geom,
                                       res=list(engine.enc_res))
        b = geom.shape[0]
        img, debug = generator_apply(
            engine.gen_cfg, engine.gen_params,
            {"w_avg": engine.gen_state.get("w_avg"),
             "noise": engine.gen_state["noise"]},
            ws=params["w"].expand(b, -1, -1), geom_features=feats,
            noise_mode="const", noise_buffers=params.get("noise"),
            return_debug_data=True)
        uvs = debug["uvs"]
        # White-composited render for the image embedding.
        alpha = uvs[..., :2].sum(dim=-1, keepdim=True)
        rgb = (img + 1) / 2 * alpha + (1 - alpha)
        emb = self.backbone.encode_image(rgb)
        clip_loss = 1.0 - (emb @ text_emb).mean()
        bg_loss = compute_iou(uvs[..., 2], geom[..., 0])
        geom_loss = compute_iou(uvs[..., :2].sum(dim=-1), 1.0 - geom[..., 0])
        total = cfg.clip_weight * clip_loss + cfg.bg_weight * bg_loss \
            + cfg.geom_weight * geom_loss
        if "noise" in params:
            total = total + cfg.noise_reg_weight * \
                _noise_autocorr_reg(params["noise"])
        return total, clip_loss

    def optimize(self, text: str, w_init, geometry_batches, seed: int = 0
                 ) -> Dict:
        from brushstroke_engine_torch.train.state import Adam
        from brushstroke_engine_torch.utils.util import (
            tree_leaves, tree_unflatten,
        )

        cfg, engine = self.cfg, self.engine
        dev = engine.device
        with torch.no_grad():
            text_emb = self.backbone.encode_text([text])[0].to(dev)
        params = {"w": torch.as_tensor(np.array(w_init, np.float32),
                                       device=dev)}
        if cfg.optimize_noise:
            rng = np.random.RandomState(seed)
            # Drawn in the JAX package's key order (sorted: its trees go
            # through jax.device_put).
            params["noise"] = {
                k: torch.as_tensor(rng.randn(*tuple(
                    engine.gen_state["noise"][k].shape)).astype(np.float32),
                    device=dev)
                for k in sorted(engine.gen_state["noise"])}
        opt = Adam(lr=cfg.learning_rate, b1=0.9, b2=0.999)
        opt_state = opt.init(params)
        total = clip_loss = None
        for step in range(cfg.num_steps):
            geom = torch.as_tensor(
                np.asarray(next(geometry_batches), np.float32), device=dev)
            leaves = [leaf.requires_grad_(True)
                      for leaf in tree_leaves(params)]
            total, clip_loss = self.step_loss(params, geom, text_emb)
            grads = torch.autograd.grad(total, leaves)
            with torch.no_grad():
                upd, opt_state = opt.update(tree_unflatten(params, grads),
                                            opt_state)
                params = tree_unflatten(params, [
                    leaf.detach() + u
                    for leaf, u in zip(leaves, tree_leaves(upd))])
            if (step + 1) % 50 == 0 or step + 1 == cfg.num_steps:
                logger.info("clip step %d: total %.4f clip %.4f", step + 1,
                            float(total.detach()),
                            float(clip_loss.detach()))
        out = {"w": params["w"].cpu().numpy(),
               "loss": float("inf") if total is None
               else float(total.detach()),
               "clip_loss": float("inf") if clip_loss is None
               else float(clip_loss.detach())}
        if "noise" in params:
            out["noise"] = {k: v.cpu().numpy()
                            for k, v in params["noise"].items()}
        return out
