"""Replica placement with successor fallback (paper §3.4.1-3.4.2).

Port of ``repro.core.placement``. Three replicas per shard, one per content
dimension: ``r_s = H_s(spatial mid-point)``, ``r_t = H_t(temporal
mid-point)``, ``r_i = H_i(shardID)``. A candidate that is dead or already
used moves to the first allowed edge id at or after it (cyclically); when
no edge is allowed the slot degrades to the ``-1`` sentinel. With
``n_domains > 1`` the temporal replica avoids the spatial replica's failure
domain whenever an alive, unused edge exists outside it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import hashing
from repro_torch.core.voronoi import hash_spatial


class ShardMeta(NamedTuple):
    """Metadata accompanying a shard insertion (paper Fig 2)."""
    sid_hi: torch.Tensor   # (B,) int32 — shardID high word
    sid_lo: torch.Tensor   # (B,) int32 — shardID low word
    lat0: torch.Tensor     # (B,) float32 — bbox
    lat1: torch.Tensor
    lon0: torch.Tensor
    lon1: torch.Tensor
    t0: torch.Tensor       # (B,) float32 — temporal range
    t1: torch.Tensor


def successor_resolve(start: torch.Tensor,
                      forbidden: torch.Tensor) -> torch.Tensor:
    """First edge >= start (cyclically) that is not forbidden.

    ``start`` (B,) int32, ``forbidden`` (B, E) bool. Returns (B,) int32, or
    ``-1`` where every edge is forbidden.
    """
    e = forbidden.shape[-1]
    offs = torch.arange(e, dtype=torch.int64, device=start.device)
    idx = (start.to(torch.int64)[..., None] + offs) % e           # probe order
    ok = ~torch.gather(forbidden, -1, idx)
    first = torch.argmax(ok.to(torch.int32), dim=-1, keepdim=True)  # first True
    resolved = torch.gather(idx, -1, first)[..., 0]
    return torch.where(ok.any(dim=-1), resolved, -1).to(torch.int32)


def edge_domains(n_edges: int, n_domains: int, device="cpu") -> torch.Tensor:
    """(E,) int32 — failure domain of each edge: ``n_domains`` contiguous
    blocks of ``E / n_domains`` edges."""
    if n_domains < 1 or n_edges % n_domains:
        raise ValueError(
            f"n_domains={n_domains} must be >= 1 and divide n_edges="
            f"{n_edges} (contiguous device blocks).")
    return (torch.arange(n_edges, dtype=torch.int32, device=device)
            // (n_edges // n_domains))


def _spread_resolve(cand: torch.Tensor, used: torch.Tensor,
                    dom_used: torch.Tensor) -> torch.Tensor:
    """Successor-resolve ``cand`` preferring edges outside the failure
    domains already hosting a replica, where some unused edge exists there."""
    constrained = used | dom_used
    can_spread = (~constrained).any(dim=-1)
    forbidden = torch.where(can_spread[..., None], constrained, used)
    return successor_resolve(cand, forbidden)


def place_replicas(meta: ShardMeta, sites: torch.Tensor, alive: torch.Tensor,
                   tau: float, n_domains: int = 1) -> torch.Tensor:
    """(B, 3) int32 replica edges (spatial, temporal, id); distinct and
    alive, ``-1`` for slots that cannot be filled."""
    e = sites.shape[0]
    mid_lat = 0.5 * (meta.lat0 + meta.lat1)
    mid_lon = 0.5 * (meta.lon0 + meta.lon1)
    mid_t = 0.5 * (meta.t0 + meta.t1)

    cand_s = hash_spatial(mid_lat, mid_lon, sites)
    cand_t = hashing.hash_time(mid_t, tau, e)
    cand_i = hashing.hash_shard_id(meta.sid_hi, meta.sid_lo, e)

    dead = (~alive.to(torch.bool)).expand(cand_s.shape + (e,))
    eye = torch.arange(e, dtype=torch.int32, device=sites.device)

    r0 = successor_resolve(cand_s, dead)
    used = dead | (eye == r0[..., None])
    if n_domains == 1:
        r1 = successor_resolve(cand_t, used)
    else:
        dom = edge_domains(e, n_domains, sites.device)
        r0_dom = torch.where(r0 >= 0, dom[r0.clamp(min=0).long()], -1)
        dom_used = dom[None, :] == r0_dom[..., None]
        r1 = _spread_resolve(cand_t, used, dom_used)
    used = used | (eye == r1[..., None])
    # r_i stays the plain successor of H_i(shardID): sid point lookups
    # consult exactly that edge.
    r2 = successor_resolve(cand_i, used)
    return torch.stack([r0, r1, r2], dim=-1)


def parent_edge(lat: torch.Tensor, lon: torch.Tensor, sites: torch.Tensor,
                alive: torch.Tensor) -> torch.Tensor:
    """Parent edge of a drone: its Voronoi cell, or the successor if that edge
    is down (``-1`` when no edge is alive)."""
    cand = hash_spatial(lat, lon, sites)
    dead = (~alive.to(torch.bool)).expand(cand.shape + (alive.shape[0],))
    return successor_resolve(cand, dead)
