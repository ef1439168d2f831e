"""Brush identities.

The port's copy of ``seed_to_z`` from
``brushstroke_engine_tpu/engine/library.py``.
"""

from __future__ import annotations

import numpy as np


def seed_to_z(seed: int, z_dim: int) -> np.ndarray:
    """Seed -> z, bit-compatible with the reference (library.py:186) so the
    same seed names the same brush across engines."""
    return np.random.RandomState(seed=seed).randn(1, z_dim)
