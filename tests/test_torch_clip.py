"""The port's CLIP model (``tools/clip_model.py``) and text search
(``tools/clip_search.py``: the backbones and ``FeatureDictionary``) against
the JAX package on the CPU, at the widths of ``tests/test_clip_model.py``
(embed 16, image 32, patch 8, widths 32 with 2 heads, 2 layers, context 16),
on a seeded state dict in OpenAI's layout
(``utils/reference_layout.py:clip_state_dict``) and a small merges file in
CLIP's format.

Tolerance: 1e-5 (relative and absolute) on unit embeddings and scores, the
same f32 math in another order; token ids exact.  Also pins the two faults
of the JAX package that the port does not copy (``ROADMAP.md`` §3): the
hashing backbone's per-process word seeds, and ``load_openai_clip`` running
code of the file it reads.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from brushstroke_engine_tpu.tools import clip_model as jcm
from brushstroke_engine_tpu.tools import clip_search as jcs
from brushstroke_engine_torch.tools import clip_model as tcm
from brushstroke_engine_torch.tools import clip_search as tcs
from brushstroke_engine_torch.utils import reference_layout as rl

TOL = dict(rtol=1e-5, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["a", "dark", "ink", "brush", "stroke", "soft", "charcoal", "wash"]
MERGES = rl.bpe_merges_for(WORDS)
TINY = dict(embed_dim=16, image_resolution=32, vision_patch=8,
            vision_width=32, vision_layers=2, text_width=32, text_layers=2,
            context_length=16, vocab_size=512 + len(MERGES) + 2)
TEXTS = ["a dark ink stroke", "Soft  CHARCOAL wash!", "inky brushes 42",
         "a &amp; b"]


def two_heads(cfg):
    """The converters derive heads as width // 64; these widths take 2."""
    return dataclasses.replace(cfg, vision_heads=2, text_heads=2)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip")
    state = rl.clip_state_dict(seed=1, widths=TINY)
    weights = str(d / "clip.pt")
    torch.save(state, weights)
    bpe = str(d / "bpe.txt.gz")
    rl.write_bpe_merges(bpe, MERGES)
    return state, weights, bpe


@pytest.fixture(scope="module")
def models(files):
    state, _, _ = files
    tcfg, tparams = tcm.from_openai_state(state)
    jcfg, jparams = jcm.from_openai_state(state)
    return two_heads(tcfg), tparams, two_heads(jcfg), jparams


def test_from_openai_state_equals_jax(models):
    """The configuration inferred from the shapes, and every parameter
    (the port keeps the conv OIHW, JAX transposes it to HWIO)."""
    tcfg, tparams, jcfg, jparams = models
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.image_resolution == 32 and tcfg.vision_layers == 2 \
        and tcfg.vocab_size == TINY["vocab_size"]
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), tparams))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jparams))
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_t:
        want = np.asarray(flat_j[path])
        if path[-1].key == "conv":
            want = np.transpose(want, (3, 2, 0, 1))
        np.testing.assert_array_equal(leaf, want)


def test_tokenizer_ids_equal_jax(files):
    _, _, bpe = files
    t = tcm.SimpleTokenizer(bpe, context_length=16)
    j = jcm.SimpleTokenizer(bpe, context_length=16)
    ids = t(TEXTS)
    np.testing.assert_array_equal(ids, j(TEXTS))
    assert ids.dtype == np.int32 and ids.shape == (len(TEXTS), 16)
    # The merges build 'ink' whole, and the EOT is the largest id.
    assert t.encoder["ink</w>"] in ids[0]
    assert t.encoder["<|endoftext|>"] == TINY["vocab_size"] - 1


@pytest.mark.parametrize("size", [32, 48, 20])
def test_encode_image_equals_jax(models, size):
    """At the model's 32 px, shrunk from 48 px (``jax.image.resize``'s
    antialias) and grown from 20 px."""
    tcfg, tparams, jcfg, jparams = models
    imgs = np.random.RandomState(size).rand(3, size, size, 3) \
        .astype(np.float32)
    got = tcm.encode_image(tcfg, tparams, torch.from_numpy(imgs)).numpy()
    want = np.asarray(jcm.encode_image(jcfg, jparams, jnp.asarray(imgs)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, **TOL)


def test_encode_text_equals_jax(models, files):
    tcfg, tparams, jcfg, jparams = models
    tok = tcm.SimpleTokenizer(files[2], context_length=16)
    rng = np.random.RandomState(1)
    ids = np.zeros((3, 16), np.int64)
    for i in range(3):
        n = rng.randint(3, 12)
        ids[i, :n] = rng.randint(1, TINY["vocab_size"] - 1, size=n)
        ids[i, n] = TINY["vocab_size"] - 1            # EOT = the max id
    ids = np.concatenate([ids, tok(TEXTS)])
    got = tcm.encode_text(tcfg, tparams, ids).numpy()
    want = np.asarray(jcm.encode_text(jcfg, jparams, ids))
    np.testing.assert_allclose(got, want, **TOL)


class _ScriptedCLIP(torch.nn.Module):
    """A module holding a state dict under its dotted names, to be saved as
    a TorchScript archive like OpenAI's published ``.pt`` files."""

    def __init__(self, state):
        super().__init__()
        for key, value in state.items():
            node = self
            *path, leaf = key.split(".")
            for part in path:
                if not hasattr(node, part):
                    node.add_module(part, torch.nn.Module())
                node = getattr(node, part)
            node.register_parameter(leaf, torch.nn.Parameter(value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def test_load_openai_clip_state_dict_and_torchscript(files, models,
                                                     tmp_path):
    state, weights, bpe = files
    tcfg, tparams, _, _ = models
    scripted = str(tmp_path / "clip_jit.pt")
    torch.jit.script(_ScriptedCLIP(state)).save(scripted)
    imgs = torch.from_numpy(np.random.RandomState(0).rand(2, 32, 32, 3)
                            .astype(np.float32))
    want = tcm.encode_image(tcfg, tparams, imgs)
    for path in (weights, scripted):
        cfg, params, tok = tcm.load_openai_clip(path, bpe, device="cpu")
        assert tok is not None and tok.context_length == 16
        np.testing.assert_array_equal(
            tcm.encode_image(two_heads(cfg), params, imgs).numpy(),
            want.numpy())


def _record_call(path):
    """A callable a crafted checkpoint names: loading it calls this."""
    with open(path, "w") as f:
        f.write("ran")
    return {"not": "a state dict"}


class _Crafted:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return (_record_call, (self.marker,))


def test_load_openai_clip_refuses_foreign_callables(tmp_path):
    """The JAX package's loader (``weights_only=False``) runs the callable a
    checkpoint names; the port's refuses the file and runs nothing."""
    marker = tmp_path / "ran.txt"
    path = str(tmp_path / "crafted.pt")
    torch.save(_Crafted(str(marker)), path)
    with pytest.raises(pickle.UnpicklingError):
        tcm.load_openai_clip(path, device="cpu")
    assert not marker.exists()
    with pytest.raises(KeyError):
        jcm.load_openai_clip(path)
    assert marker.read_text() == "ran"


def _hashing_pair(seed=0, dim=32):
    """The JAX hashing backbone and the port's with its image weights."""
    j = jcs.HashingBackbone(seed, dim)
    t = tcs.HashingBackbone(seed, dim, device="cpu",
                            conv=np.asarray(j._conv),
                            proj=np.asarray(j._proj))
    return j, t


def test_hashing_backbone_image_equals_jax():
    j, t = _hashing_pair()
    imgs = np.random.RandomState(3).rand(4, 32, 32, 3).astype(np.float32)
    np.testing.assert_allclose(
        t.encode_image(torch.from_numpy(imgs)).numpy(),
        np.asarray(j.encode_image(jnp.asarray(imgs))), **TOL)
    assert t.kind == j.kind == "hashing"


def test_hashing_backbone_text_is_the_jax_formula_with_stable_seeds(
        monkeypatch):
    """The port's text embedding is the JAX package's formula (a
    RandomState draw per word, summed, normalized) with the word seeds of
    ``word_seed`` in place of Python's ``hash``."""
    j, t = _hashing_pair(seed=3)
    monkeypatch.setattr(jcs, "hash", lambda key: tcs.word_seed(*key),
                        raising=False)
    np.testing.assert_allclose(t.encode_text(TEXTS).numpy(),
                               np.asarray(j.encode_text(TEXTS)), **TOL)


_EMBED_BOTH = (
    "import json, sys; sys.path.insert(0, {repo!r})\n"
    "from brushstroke_engine_torch.tools.clip_search import HashingBackbone\n"
    "from brushstroke_engine_tpu.tools import clip_search as jcs\n"
    "t = HashingBackbone(0, 32, device='cpu').encode_text({texts!r})\n"
    "j = jcs.HashingBackbone(0, 32).encode_text({texts!r})\n"
    "print(json.dumps([t.numpy().tolist(), j.tolist()]))\n")


def test_hashing_text_embedding_is_equal_across_processes():
    """Two processes with other ``PYTHONHASHSEED`` give the same port
    embedding; the JAX package's (seeded from ``hash``) differs."""
    import json
    outs = []
    for hash_seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hash_seed, JAX_PLATFORMS="cpu")
        res = subprocess.run(
            [sys.executable, "-c",
             _EMBED_BOTH.format(repo=REPO, texts=TEXTS[:2])],
            capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
        assert res.returncode == 0, res.stderr[-2000:]
        outs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert not np.allclose(outs[0][1], outs[1][1])


def test_feature_dictionary_top_results_equal_jax(files, models, tmp_path):
    """Both packages' CLIP backbones over the same checkpoint and merges:
    the same thumbnails, the same query -> the same ranking and scores; the
    port's dictionary saves and loads."""
    _, weights, bpe = files
    tb = tcs.CLIPBackbone(weights, bpe, device="cpu")
    jb = jcs.CLIPBackbone(weights, bpe)
    tb.cfg, jb.cfg = two_heads(tb.cfg), two_heads(jb.cfg)
    assert tb.kind == jb.kind == "clip"
    imgs = np.random.RandomState(4).rand(5, 32, 32, 3).astype(np.float32)
    keys = [f"s{i}" for i in range(5)]
    td, jd = tcs.FeatureDictionary(tb), jcs.FeatureDictionary(jb)
    td.add_images(keys[:3], imgs[:3])
    td.add_images(keys[3:], imgs[3:])
    jd.add_images(keys, imgs)
    np.testing.assert_allclose(td.features, np.asarray(jd.features), **TOL)
    for query in TEXTS[:2]:
        got, want = td.get_top_results(query, k=4), \
            jd.get_top_results(query, k=4)
        assert [k for k, _ in got] == [k for k, _ in want]
        np.testing.assert_allclose([s for _, s in got],
                                   [s for _, s in want], **TOL)
    td.save(str(tmp_path / "d.pkl"))
    again = tcs.FeatureDictionary.load(str(tmp_path / "d.pkl"), tb)
    assert again.keys == keys
    np.testing.assert_array_equal(again.features, td.features)


def test_weight_families_equal_jax(monkeypatch, tmp_path):
    """The port's registry names the JAX registry's families, file names
    and environment variables; ``find_weights('clip')`` finds a file
    through either place, as the JAX package's does."""
    from brushstroke_engine_tpu.utils import weights as jweights
    from brushstroke_engine_torch.utils import weights as tweights
    assert tweights.CANONICAL == jweights.CANONICAL
    monkeypatch.setenv("NEUBE_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.delenv("NEUBE_CLIP_WEIGHTS", raising=False)
    assert tweights.find_weights("clip") is None \
        and jweights.find_weights("clip") is None
    (tmp_path / "clip_vitb32.pt").write_bytes(b"")
    assert tweights.find_weights("clip") == jweights.find_weights("clip") \
        == str(tmp_path / "clip_vitb32.pt")
    other = tmp_path / "other.pt"
    other.write_bytes(b"")
    monkeypatch.setenv("NEUBE_CLIP_WEIGHTS", str(other))
    assert tweights.find_weights("clip") == str(other)
