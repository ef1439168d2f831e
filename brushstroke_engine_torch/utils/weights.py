"""Where pretrained weights are found (the port's copy of the discovery part
of ``brushstroke_engine_tpu/utils/weights.py``).

Both packages look in the same places, so a weights file placed there is
found by either: the family's environment variable (for example
``NEUBE_FID_DETECTOR=/path.pt``), else the family's canonical file name in
``$NEUBE_WEIGHTS_DIR`` (default: ``weights/`` at the repository root).
Nothing is fetched; without a file each consumer uses its labelled random
fallback.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

#: family -> (canonical filename, env var override)
CANONICAL: Dict[str, tuple] = {
    "inception": ("inception_v3.pt", "NEUBE_FID_DETECTOR"),
    "lpips": ("lpips_alex.pt", "NEUBE_LPIPS_WEIGHTS"),
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
