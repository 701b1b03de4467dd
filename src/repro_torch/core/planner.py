"""Query planning and load balancing (paper §3.5.2, Alg. 1).

Port of ``repro.core.planner``: pick exactly one alive replica edge per
matched shard. The greedy loops run batched over queries for a fixed number
of iterations (the reference's ``while_loop`` bound), with every update
masked to the queries still active, so no iteration reads a flag back to the
host and the result equals the reference's bit for bit. Ties take the first
index, as ``jnp.argmin``/``jnp.argmax`` do.

``plan_random`` draws the reference's threefry Gumbel noise per query key
(``repro_torch.core.threefry``: keys, bits and uniforms bit for bit JAX's,
the gumbels within the ulps of ``log``), so its picks equal the reference's
wherever the top two gumbels of a shard's alive replicas are not within
those ulps of each other.
"""

from __future__ import annotations

import torch

from repro_torch.core import threefry
from repro_torch.core.index import MatchedShards

_INT_MAX = (1 << 31) - 1


def _alive_replica_mask(matched: MatchedShards,
                        alive: torch.Tensor) -> torch.Tensor:
    """(Q, S, 3) bool — which replica slots are usable."""
    reps = matched.replicas
    ok = (reps >= 0) & alive[reps.clamp(min=0).long()]
    return ok & matched.valid[..., None]


def plan_random(matched: MatchedShards, alive: torch.Tensor,
                key: threefry.Keys) -> torch.Tensor:
    """(Q, S) int32 edge per shard, -1 where unassignable: the alive
    replica with the largest Gumbel draw, a uniform choice among them.

    ``key`` is one key (a pair of ints, folded with each query index) or a
    (Q, 2) batch of per-query keys on the device of ``matched``. Both forms
    draw the same gumbels for the same global query index, so a caller that
    tiles the query batch and slices the folded keys gets the untiled plan's
    rows."""
    ok = _alive_replica_mask(matched, alive)
    q, s, r = ok.shape
    if not isinstance(key, torch.Tensor):
        key = threefry.fold_in(key, torch.arange(q, device=ok.device))
    g = threefry.gumbel(key, (s, r))                               # (Q,S,3)
    pick = torch.argmax(torch.where(ok, g, float("-inf")), dim=-1)
    edge = torch.gather(matched.replicas, 2, pick[..., None])[..., 0]
    return torch.where(ok.any(dim=-1), edge, -1).to(torch.int32)


def plan_min_edges(matched: MatchedShards, alive: torch.Tensor) -> torch.Tensor:
    """Greedy set cover: repeatedly take the edge covering the most
    unassigned shards and give it all of them. (Q, S) int32, -1 unassigned."""
    reps = matched.replicas
    q, s, _ = reps.shape
    n_edges = alive.shape[0]
    ok = _alive_replica_mask(matched, alive)
    eye = torch.arange(n_edges, dtype=reps.dtype, device=reps.device)
    onehot = (reps[..., None] == eye) & ok[..., None]               # (Q,S,3,E)
    on_edge = onehot.any(dim=2)                                     # (Q,S,E)
    assignment = torch.full((q, s), -1, dtype=torch.int32, device=reps.device)
    unassigned = ok.any(dim=-1)                                     # (Q,S)
    for _ in range(min(n_edges, s) + 1):
        # Queries with nothing unassigned have cov == 0, so take is empty:
        # the update is a no-op for them without extra masking.
        cov = (on_edge & unassigned[..., None]).sum(dim=1, dtype=torch.int32)
        best = torch.argmax(cov, dim=-1)                            # (Q,)
        cov_best = torch.gather(cov, 1, best[:, None])              # (Q,1)
        has_best = torch.gather(on_edge, 2, best[:, None, None].expand(
            q, s, 1))[..., 0]
        take = unassigned & has_best & (cov_best > 0)
        assignment = torch.where(take, best[:, None].to(torch.int32), assignment)
        unassigned = unassigned & ~take & (cov_best > 0)
    return assignment


def plan_min_shards(matched: MatchedShards,
                    alive: torch.Tensor) -> torch.Tensor:
    """Paper Alg. 1 (MinShards): the least-loaded edge receives its
    least-replicated shard, one shard per iteration. (Q, S) int32."""
    reps = matched.replicas
    q, s, _ = reps.shape
    n_edges = alive.shape[0]
    dev = reps.device
    ok = _alive_replica_mask(matched, alive)
    eye = torch.arange(n_edges, dtype=reps.dtype, device=dev)
    hit = reps[..., None] == eye                                    # (Q,S,3,E)
    shard_ids = torch.arange(s, device=dev)
    assignment = torch.full((q, s), -1, dtype=torch.int32, device=dev)
    for _ in range(s + 1):
        active = ok.flatten(1).any(dim=1)                           # (Q,)
        per_edge = (hit & ok[..., None]).any(dim=2).sum(dim=1,
                                                        dtype=torch.int32)
        cnt = torch.where(per_edge > 0, per_edge, _INT_MAX)
        e_star = torch.argmin(cnt, dim=-1)                          # (Q,)
        on_e = ((reps == e_star[:, None, None]) & ok).any(dim=-1)   # (Q,S)
        n_rep = ok.sum(dim=-1, dtype=torch.int32)
        shard_key = torch.where(on_e, n_rep, _INT_MAX)
        s_star = torch.argmin(shard_key, dim=-1)                    # (Q,)
        # Masked write: for a query with no usable replica left the
        # reference's loop has stopped; an unmasked write would set
        # assignment[0] = 0 (argmin over the all-max sentinel).
        cur = torch.gather(assignment, 1, s_star[:, None])
        new = torch.where(active[:, None], e_star[:, None].to(torch.int32), cur)
        assignment.scatter_(1, s_star[:, None], new)
        ok = ok & ~(shard_ids[None, :] == s_star[:, None])[..., None]
    return assignment


def plan(strategy: str, matched: MatchedShards, alive: torch.Tensor,
         key: threefry.Keys | None = None) -> torch.Tensor:
    if strategy == "random":
        if key is None:
            raise ValueError("random planner needs a PRNG key")
        return plan_random(matched, alive, key)
    if strategy == "min_edges":
        return plan_min_edges(matched, alive)
    if strategy == "min_shards":
        return plan_min_shards(matched, alive)
    raise ValueError(f"unknown planner {strategy!r}")
