"""Spatial hashing H_s via Voronoi point location (paper §3.4.1).

Port of ``repro.core.voronoi``: point location in the Voronoi diagram of the
edge sites is nearest-site search, evaluated as
``argmin_e(||s_e||^2 - 2 p.s_e)`` after centring points and sites on the
site centroid (raw coordinates near 77.6 deg would cancel catastrophically in
float32). Ties go to the lowest edge index.

The plain version computes the cross term elementwise (``p0*s0 + p1*s1``,
one rounding per operation) instead of through a matrix product, so the CUDA
kernel, which evaluates the same expression with round-to-nearest intrinsics
and no fused multiply-add, matches it bit for bit on the card.
``hash_spatial`` goes through the ``voronoi_assign`` kernel wrapper: the
plain version for CPU tensors, the kernel for CUDA tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.voronoi_assign import ops as voronoi_ops


def centred_sites(sites: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """(centroid (2,), centred sites (E, 2), squared norms (E,)), float32."""
    s = sites.to(torch.float32)
    c = s.mean(dim=0)
    sc = s - c
    snorm = sc[:, 0] * sc[:, 0] + sc[:, 1] * sc[:, 1]
    return c, sc, snorm


def voronoi_assign(points: torch.Tensor, sites: torch.Tensor) -> torch.Tensor:
    """Plain version: (N, 2) points x (E, 2) sites -> (N,) int32 nearest
    site, lowest index on ties (``torch.argmin`` returns the first)."""
    c, s, snorm = centred_sites(sites)
    p = points.to(torch.float32) - c
    cross = p[:, 0:1] * s[:, 0] + p[:, 1:2] * s[:, 1]           # (N, E)
    dist = snorm - 2.0 * cross
    return torch.argmin(dist, dim=-1).to(torch.int32)


def hash_spatial(lat: torch.Tensor, lon: torch.Tensor,
                 sites: torch.Tensor) -> torch.Tensor:
    """H_s: (lat, lon) -> edge index via Voronoi point location."""
    return voronoi_ops.hash_spatial_kernel(lat, lon, sites)
