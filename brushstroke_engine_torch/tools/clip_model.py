"""CLIP vision-text backbone (ViT image tower and causal text transformer)
over a parameter tree, with a converter from OpenAI CLIP state dicts.

Counterpart of ``brushstroke_engine_tpu/tools/clip_model.py``.  The model's
configuration is derived from the state dict's shapes, so ViT-B/32, ViT-B/16
and ViT-L/14 load.  The math is the published CLIP architecture: pre-norm
transformer blocks with QuickGELU, a class-token ViT with ln_pre / ln_post,
EOT-token text features (the EOT id is the largest, so ``argmax`` of the
ids finds it), a ``-inf`` causal mask, learned projections to the shared
embedding space.  Attention is plain matmul / softmax, as the JAX package's
(no hand kernel: it has no Pallas counterpart).

Text goes through the standard CLIP byte-BPE tokenizer
(:class:`SimpleTokenizer`, a copy of the JAX package's, pure Python) over
the merges file that ships with CLIP (``bpe_simple_vocab_16e6.txt[.gz]``).

:func:`load_openai_clip` runs no code of the file it reads: a state-dict
pickle loads with ``torch.load(..., weights_only=True)``, and OpenAI's
published ``.pt`` files, TorchScript archives, load with ``torch.jit.load``.
"""

from __future__ import annotations

import gzip
import html
import re
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from brushstroke_engine_torch.utils.util import resolve_device, tree_to

# ---------------------------------------------------------------------------
# Byte-BPE tokenizer (the standard CLIP text preprocessing).
# ---------------------------------------------------------------------------


@lru_cache()
def _bytes_to_unicode():
    bs = list(range(ord("!"), ord("~") + 1)) + \
        list(range(ord("\xa1"), ord("\xac") + 1)) + \
        list(range(ord("\xae"), ord("\xff") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class SimpleTokenizer:
    """CLIP byte-BPE tokenizer; ``bpe_path`` is the merges file shipped
    with CLIP (plain or gzipped)."""

    def __init__(self, bpe_path: str, context_length: int = 77):
        self.context_length = context_length
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]
                  if m]
        self.byte_encoder = _bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {}
        # CLIP's published pattern uses \p{L}/\p{N} (the regex module); the
        # stdlib-re ASCII classes below match it for English text.
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+", re.IGNORECASE)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and \
                        word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens = []
        text = html.unescape(html.unescape(text))
        text = re.sub(r"\s+", " ", text).strip().lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return tokens

    def __call__(self, texts: List[str]) -> np.ndarray:
        """texts -> ``[N, context_length]`` int32 with SOT / EOT and zero
        padding."""
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            toks = [sot] + self.encode(text)[:self.context_length - 2] + [eot]
            out[i, :len(toks)] = toks
        return out


# ---------------------------------------------------------------------------
# Architecture.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    image_resolution: int
    vision_width: int
    vision_layers: int
    vision_patch: int
    vision_heads: int
    context_length: int
    vocab_size: int
    text_width: int
    text_layers: int
    text_heads: int


_MEAN = (0.48145466, 0.4578275, 0.40821073)
_STD = (0.26862954, 0.26130258, 0.27577711)


def _ln(p, x, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _attention(p, x, heads: int, causal: bool):
    """Multi-head self-attention with torch's in_proj semantics, as plain
    matmul and softmax."""
    n, d = x.shape[-2], x.shape[-1]
    q, k, v = (x @ p["qkv_w"] + p["qkv_b"]).split(d, dim=-1)

    def split_heads(t):                                  # [.., H, N, dh]
        return t.reshape(t.shape[:-1] + (heads, d // heads)).transpose(-3, -2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    logits = (q @ k.transpose(-1, -2)) * (1.0 / np.sqrt(d // heads))
    if causal:
        mask = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    out = (logits.softmax(dim=-1) @ v).transpose(-3, -2).reshape(x.shape)
    return out @ p["out_w"] + p["out_b"]


def _block(p, x, heads: int, causal: bool):
    x = x + _attention(p["attn"], _ln(p["ln1"], x), heads, causal)
    h = _quick_gelu(_ln(p["ln2"], x) @ p["fc_w"] + p["fc_b"])
    return x + (h @ p["proj_w"] + p["proj_b"])


def resize_images(x, size: int):
    """NHWC images -> ``[B, size, size, C]``: half-pixel bilinear with
    ``jax.image.resize``'s antialiasing when it shrinks."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                      mode="bilinear", antialias=True, align_corners=False)
    return y.permute(0, 2, 3, 1)


def encode_image(cfg: CLIPConfig, params: Dict, images) -> torch.Tensor:
    """``[B, H, W, 3]`` float in [0, 1] (a tensor on the parameters'
    device) -> ``[B, embed_dim]`` unit vectors."""
    v = params["visual"]
    x = images.float()
    if tuple(x.shape[1:3]) != (cfg.image_resolution, cfg.image_resolution):
        x = resize_images(x, cfg.image_resolution)
    mean = torch.tensor(_MEAN, device=x.device)
    std = torch.tensor(_STD, device=x.device)
    x = ((x - mean) / std).permute(0, 3, 1, 2)
    x = F.conv2d(x, v["conv"], stride=cfg.vision_patch)    # [B, W, g, g]
    x = x.flatten(2).transpose(1, 2)                       # [B, g*g, W]
    cls = v["class_emb"].expand(x.shape[0], 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1) + v["pos_emb"]
    x = _ln(v["ln_pre"], x)
    for blk in v["blocks"]:
        x = _block(blk, x, cfg.vision_heads, causal=False)
    x = _ln(v["ln_post"], x[:, 0]) @ v["proj"]
    return x / x.norm(dim=-1, keepdim=True)


def encode_text(cfg: CLIPConfig, params: Dict, tokens) -> torch.Tensor:
    """``[N, context_length]`` int tokens -> ``[N, embed_dim]`` unit
    vectors."""
    t = params["text"]
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                             device=t["tok_emb"].device)
    x = t["tok_emb"][tokens] + t["pos_emb"][:tokens.shape[1]]
    for blk in t["blocks"]:
        x = _block(blk, x, cfg.text_heads, causal=True)
    x = _ln(t["ln_final"], x)
    eot = tokens.argmax(dim=-1)          # EOT has the highest token id
    x = x[torch.arange(x.shape[0], device=x.device), eot] @ t["text_proj"]
    return x / x.norm(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# OpenAI state-dict conversion.
# ---------------------------------------------------------------------------

def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(
        x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor)
        else x, np.float32))


def _ln_params(state, prefix):
    return {"scale": _f32(state[f"{prefix}.weight"]),
            "bias": _f32(state[f"{prefix}.bias"])}


def _convert_blocks(state, prefix, n_layers):
    blocks = []
    for i in range(n_layers):
        b = f"{prefix}.resblocks.{i}"
        blocks.append({
            "ln1": _ln_params(state, f"{b}.ln_1"),
            "attn": {
                "qkv_w": _f32(
                    state[f"{b}.attn.in_proj_weight"]).T.contiguous(),
                "qkv_b": _f32(state[f"{b}.attn.in_proj_bias"]),
                "out_w": _f32(
                    state[f"{b}.attn.out_proj.weight"]).T.contiguous(),
                "out_b": _f32(state[f"{b}.attn.out_proj.bias"]),
            },
            "ln2": _ln_params(state, f"{b}.ln_2"),
            "fc_w": _f32(state[f"{b}.mlp.c_fc.weight"]).T.contiguous(),
            "fc_b": _f32(state[f"{b}.mlp.c_fc.bias"]),
            "proj_w": _f32(state[f"{b}.mlp.c_proj.weight"]).T.contiguous(),
            "proj_b": _f32(state[f"{b}.mlp.c_proj.bias"]),
        })
    return blocks


def from_openai_state(state: Dict):
    """OpenAI CLIP state dict (ViT visual tower) -> (config, params), the
    params CPU f32 tensors.  Every size is derived from the shapes."""
    conv = _f32(state["visual.conv1.weight"])            # [W, 3, p, p] OIHW
    vision_width, _, patch, _ = conv.shape
    grid = int(np.sqrt(state["visual.positional_embedding"].shape[0] - 1))
    vision_layers = len({
        int(k.split(".")[3]) for k in state
        if k.startswith("visual.transformer.resblocks.")})
    text_layers = len({
        int(k.split(".")[2]) for k in state
        if k.startswith("transformer.resblocks.")})
    text_width = state["ln_final.weight"].shape[0]
    cfg = CLIPConfig(
        embed_dim=state["text_projection"].shape[1],
        image_resolution=grid * patch,
        vision_width=vision_width,
        vision_layers=vision_layers,
        vision_patch=patch,
        vision_heads=vision_width // 64,
        context_length=state["positional_embedding"].shape[0],
        vocab_size=state["token_embedding.weight"].shape[0],
        text_width=text_width,
        text_layers=text_layers,
        text_heads=text_width // 64,
    )
    params = {
        "visual": {
            "conv": conv,
            "class_emb": _f32(state["visual.class_embedding"]),
            "pos_emb": _f32(state["visual.positional_embedding"]),
            "ln_pre": _ln_params(state, "visual.ln_pre"),
            "blocks": _convert_blocks(state, "visual.transformer",
                                      vision_layers),
            "ln_post": _ln_params(state, "visual.ln_post"),
            "proj": _f32(state["visual.proj"]),
        },
        "text": {
            "tok_emb": _f32(state["token_embedding.weight"]),
            "pos_emb": _f32(state["positional_embedding"]),
            "blocks": _convert_blocks(state, "transformer", text_layers),
            "ln_final": _ln_params(state, "ln_final"),
            "text_proj": _f32(state["text_projection"]),
        },
    }
    return cfg, params


def load_openai_clip(weights_path: str, bpe_path: Optional[str] = None,
                     device="cuda"):
    """Load a CLIP checkpoint -> (config, params on ``device``, tokenizer).

    A TorchScript archive (OpenAI's published ``.pt``) loads through
    ``torch.jit.load``; anything else must be a state-dict pickle, loaded
    with ``weights_only=True``, so a file that names any other callable is
    refused.  The tokenizer needs the BPE merges file (None without one).
    """
    from brushstroke_engine_torch.utils.weights import load_state_dict
    dev = resolve_device(device)
    cfg, params = from_openai_state(load_state_dict(weights_path))
    tokenizer = SimpleTokenizer(bpe_path, cfg.context_length) \
        if bpe_path else None
    return cfg, tree_to(params, dev), tokenizer
