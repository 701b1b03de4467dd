"""Fixed-size spatial/temporal slicing for the distributed index (§3.4.3).

Port of ``repro.core.slicing``. A shard's (or query's) spatial extent is cut
into a fixed grid of ``cell``-wide cells and its temporal extent into
``tau``-wide buckets; every slice is hashed with H_s / H_t, and the union of
the resulting edges is a multi-hot (..., E) mask. Ranges wider than the
static slice budget set ``overflow`` (callers broadcast for those).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import hashing
from repro_torch.core.voronoi import hash_spatial
from repro_torch.device import reciprocal_like


class SliceConfig(NamedTuple):
    """Static slicing geometry, shared by insert and query paths."""
    tau: float = 300.0          # temporal slice width (seconds); paper uses 5 min
    cell: float = 0.01          # spatial grid cell width (degrees ~ 1.1 km)
    max_t_slices: int = 16      # static budget of temporal slices per range
    max_s_slices: int = 16      # static budget of spatial cells per range (per axis: sqrt)
    lat0: float = 0.0           # grid origin
    lon0: float = 0.0


def temporal_slice_edges(t0: torch.Tensor, t1: torch.Tensor, n_edges: int,
                         cfg: SliceConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask (..., E) bool, overflow (...,) bool) for the buckets of [t0, t1]."""
    b0 = hashing.time_bucket(t0, cfg.tau)
    b1 = hashing.time_bucket(t1, cfg.tau)
    n_slices = b1 - b0 + 1
    overflow = n_slices > cfg.max_t_slices
    k = torch.arange(cfg.max_t_slices, dtype=torch.int32, device=t0.device)
    buckets = b0[..., None] + k
    valid = k < n_slices[..., None]
    edges = hashing.hash_time_bucket(buckets, n_edges)
    return _scatter_multihot(edges, valid, n_edges), overflow


def _cell_index(x: torch.Tensor, origin: float, cell: float) -> torch.Tensor:
    return torch.floor((x - origin) * reciprocal_like(cell, x)).to(torch.int32)


def spatial_slice_edges(lat0, lat1, lon0, lon1, sites: torch.Tensor,
                        cfg: SliceConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask (..., E) bool, overflow (...,) bool) for the grid cells of a
    bbox; each covered cell's centre is located with H_s."""
    n_edges = sites.shape[0]
    i0 = _cell_index(lat0, cfg.lat0, cfg.cell)
    i1 = _cell_index(lat1, cfg.lat0, cfg.cell)
    j0 = _cell_index(lon0, cfg.lon0, cfg.cell)
    j1 = _cell_index(lon1, cfg.lon0, cfg.cell)
    ni = i1 - i0 + 1
    nj = j1 - j0 + 1
    m = cfg.max_s_slices
    overflow = (ni > m) | (nj > m)
    k = torch.arange(m, dtype=torch.int32, device=lat0.device)
    ii = i0[..., None] + k
    jj = j0[..., None] + k
    vi = k < ni[..., None]
    vj = k < nj[..., None]
    # Cell centres for the KxK cartesian product of covered rows/cols.
    clat = cfg.lat0 + (ii.to(torch.float32) + 0.5) * cfg.cell
    clon = cfg.lon0 + (jj.to(torch.float32) + 0.5) * cfg.cell
    glat = clat[..., :, None].expand(clat.shape[:-1] + (m, m))
    glon = clon[..., None, :].expand(clon.shape[:-1] + (m, m))
    gvalid = vi[..., :, None] & vj[..., None, :]
    edges = hash_spatial(glat, glon, sites)
    flat_edges = edges.reshape(edges.shape[:-2] + (-1,))
    flat_valid = gvalid.reshape(gvalid.shape[:-2] + (-1,))
    return _scatter_multihot(flat_edges, flat_valid, n_edges), overflow


def _scatter_multihot(idx: torch.Tensor, valid: torch.Tensor,
                      n_edges: int) -> torch.Tensor:
    """(..., E) bool: OR over K of one_hot(idx[..., K]) where valid."""
    eye = torch.arange(n_edges, dtype=torch.int32, device=idx.device)
    return ((idx[..., None] == eye) & valid[..., None]).any(dim=-2)
