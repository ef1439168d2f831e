"""Where pretrained weights are found (the port's copy of the discovery part
of ``brushstroke_engine_tpu/utils/weights.py``).

Both packages look in the same places, so a weights file placed there is
found by either: the family's environment variable (for example
``NEUBE_FID_DETECTOR=/path.pt``), else the family's canonical file name in
``$NEUBE_WEIGHTS_DIR`` (default: ``weights/`` at the repository root).
Nothing is fetched; without a file each consumer uses its labelled random
fallback.  ``tools/fetch_and_verify_weights.py`` installs verified local
files there and records their sha256 in ``manifest.json``
(:func:`sha256_file`, :func:`read_manifest`, :func:`write_manifest`);
:func:`load_state_dict` reads a weights file without running code of it.
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile
from typing import Dict, Optional

#: family -> (canonical filename, env var override)
CANONICAL: Dict[str, tuple] = {
    "inception": ("inception_v3.pt", "NEUBE_FID_DETECTOR"),
    "lpips": ("lpips_alex.pt", "NEUBE_LPIPS_WEIGHTS"),
    "vgg16": ("vgg16.pt", "NEUBE_VGG16_WEIGHTS"),
    "clip": ("clip_vitb32.pt", "NEUBE_CLIP_WEIGHTS"),
    "clip_bpe": ("bpe_simple_vocab_16e6.txt.gz", "NEUBE_CLIP_BPE"),
}


def weights_dir() -> str:
    d = os.environ.get("NEUBE_WEIGHTS_DIR")
    if d:
        return d
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo_root, "weights")


def find_weights(family: str) -> Optional[str]:
    """Path to a family's installed weights file, or None (-> random
    fallback).  The environment variable wins over the weights dir."""
    fname, env = CANONICAL[family]
    p = os.environ.get(env)
    if p:
        return p if os.path.exists(p) else None
    p = os.path.join(weights_dir(), fname)
    return p if os.path.exists(p) else None


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def read_manifest() -> Dict:
    p = os.path.join(weights_dir(), "manifest.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {}


def write_manifest(entries: Dict) -> str:
    """Merge ``entries`` into the weights dir's ``manifest.json`` (sorted
    keys); returns its path."""
    os.makedirs(weights_dir(), exist_ok=True)
    p = os.path.join(weights_dir(), "manifest.json")
    merged = read_manifest()
    merged.update(entries)
    with open(p, "w") as f:
        json.dump(merged, f, indent=2, sort_keys=True)
    return p


def is_torchscript(path: str) -> bool:
    """A TorchScript archive: a zip with a ``code/`` directory (a state-dict
    pickle saved by ``torch.save`` has ``data.pkl`` and ``data/`` only)."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any("/code/" in name for name in z.namelist())


def load_state_dict(path: str) -> Dict:
    """The tensors of a weights file, on the CPU, running no code of it: a
    TorchScript archive through ``torch.jit.load``, anything else through
    ``torch.load(weights_only=True)`` (a file naming another callable is
    refused); a ``{"state_dict": ...}`` wrapper is unwrapped."""
    import torch
    if is_torchscript(path):
        return dict(torch.jit.load(path, map_location="cpu").state_dict())
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    return dict(obj)
