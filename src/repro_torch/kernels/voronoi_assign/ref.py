"""Oracle for voronoi_assign: brute-force nearest site in float64 numpy
(a copy of the JAX package's ``kernels/voronoi_assign/ref.py``), plus the
top-2 distance gap that decides which points a float32 engine must agree on."""

from __future__ import annotations

import numpy as np


def voronoi_assign_ref(points: np.ndarray, sites: np.ndarray) -> np.ndarray:
    """(N, 2) points x (E, 2) sites -> (N,) int32 nearest-site (ties: lowest id)."""
    p = np.asarray(points, np.float64)
    s = np.asarray(sites, np.float64)
    d = ((p[:, None, :] - s[None, :, :]) ** 2).sum(-1)
    return np.argmin(d, axis=1).astype(np.int32)


def top2_relative_gap(points: np.ndarray, sites: np.ndarray) -> np.ndarray:
    """(N,) float64: (d2 - d1) / d2 for each point's two nearest sites. A
    float32 engine is held bitwise only where this exceeds 1e-6; closer
    points sit on a cell boundary within float32 rounding."""
    p = np.asarray(points, np.float64)
    s = np.asarray(sites, np.float64)
    d = ((p[:, None, :] - s[None, :, :]) ** 2).sum(-1)
    if d.shape[1] < 2:
        return np.full(d.shape[0], np.inf)
    two = np.sort(d, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) / np.maximum(two[:, 1], 1e-300)
