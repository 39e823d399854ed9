"""Quadratic B-spline pieces shared with the box spline (port of the
parts of ``ionotomo_tpu.core.triquadratic`` the zp model uses).

The triquadratic field model itself (its 3-axis prefilter and 9-row
evaluators) is not ported yet; ROADMAP.md Queue 1 item 12 and kernel K6.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def _prefilter_matrix(n: int) -> np.ndarray:
    """Exact inverse of the 1-D interpolation system (f64 → f32, cached).

    Interior rows (c_{j-1} + 6 c_j + c_{j+1})/8 = f_j; boundary rows are
    the identity (linear-extrapolation closure). The inverse of the
    diagonally-dominant tridiagonal system is dense with geometrically
    decaying off-diagonals. The cached array is shared: callers copy it
    into a tensor and never write to it.
    """
    if n < 3:
        return np.eye(n, dtype=np.float32)
    B = np.zeros((n, n), np.float64)
    B[0, 0] = 1.0
    B[n - 1, n - 1] = 1.0
    idx = np.arange(1, n - 1)
    B[idx, idx - 1] = 1.0 / 8.0
    B[idx, idx] = 6.0 / 8.0
    B[idx, idx + 1] = 1.0 / 8.0
    return np.linalg.inv(B).astype(np.float32)


def _qb_weights(u: torch.Tensor) -> torch.Tensor:
    """Quadratic B-spline weights for offsets (-1, 0, 1); (..., 3)."""
    return torch.stack([
        0.5 * (0.5 - u) ** 2,
        0.75 - u * u,
        0.5 * (0.5 + u) ** 2,
    ], dim=-1)


def _qb_dweights(u: torch.Tensor) -> torch.Tensor:
    """d/du of the quadratic B-spline weights; (..., 3)."""
    return torch.stack([u - 0.5, -2.0 * u, u + 0.5], dim=-1)
