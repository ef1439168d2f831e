"""FIR filter preparation for resampling ops.

The port's own copy of ``brushstroke_engine_tpu/ops/filters.py``.  Semantics
match the reference ``upfirdn2d.setup_filter`` but always materialize a 2D
filter: a separable tap vector ``f`` with ``sqrt(gain)`` per pass equals the
outer product ``f f^T * gain``.
"""

from __future__ import annotations

import numpy as np


def setup_filter(f, normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1.0) -> np.ndarray:
    """Prepare a 2D FIR filter for :func:`upfirdn2d`.

    Args:
      f: taps as list / 1D array (separable) / 2D array, or ``None`` (identity).
      normalize: scale so a DC signal keeps its magnitude.
      flip_filter: flip the filter (convolution vs correlation convention).
      gain: overall magnitude scaling.

    Returns:
      float32 ndarray of shape ``[fh, fw]``.
    """
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (0, 1, 2) and f.size > 0
    if f.ndim == 0:
        f = f[np.newaxis]
    if f.ndim == 1:
        if normalize:
            f = f / f.sum()
        f = np.outer(f, f)
    elif normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[::-1, ::-1]
    f = f * gain
    return np.ascontiguousarray(f, dtype=np.float32)


def default_resample_filter() -> np.ndarray:
    """The [1,3,3,1] binomial filter used throughout StyleGAN2."""
    return setup_filter([1, 3, 3, 1])
