"""Distributed in-memory shard index with slicing + retention (§3.4.3).

Port of ``repro.core.index``; same static-shape layout:

  ent_f:    (E, CAP, 6)  float32  lat0, lat1, lon0, lon1, t0, t1
  ent_i:    (E, CAP, 5)  int32    sid_hi, sid_lo, r0, r1, r2
  valid:    (E, CAP)     bool
  cursor:   (E,)         int32    append position
  dropped:  (E,)         int32    entries lost to capacity overflow
  retired:  (E,)         int32    entries invalidated by retention
  ent_step: (E, CAP)     int32    ingest step that wrote the entry

Unlike the JAX package, which copies state functionally, ``insert_entries``,
``retire_entries`` and ``compact_index`` update the ``IndexState`` tensors
IN PLACE and return the same tensors (the index is tens of MB per deployment
and rewritten every insert). Callers that need the state before an update
must clone it first.

The writes are scatter-free of drop sentinels: torch has no ``mode="drop"``,
and masking rows out with a boolean index would read the count back to the
host. Each edge's writes land on a window of consecutive, distinct slots;
the slots of the window that receive no entry are rewritten with their old
contents, so every index written is unique and nothing syncs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.placement import ShardMeta


class IndexState(NamedTuple):
    ent_f: torch.Tensor
    ent_i: torch.Tensor
    valid: torch.Tensor
    cursor: torch.Tensor
    dropped: torch.Tensor
    retired: torch.Tensor
    ent_step: torch.Tensor


class QueryPred(NamedTuple):
    """A spatio-temporal query predicate (paper Fig 6); every field (Q,)."""
    lat0: torch.Tensor
    lat1: torch.Tensor
    lon0: torch.Tensor
    lon1: torch.Tensor
    t0: torch.Tensor
    t1: torch.Tensor
    sid_hi: torch.Tensor
    sid_lo: torch.Tensor
    has_spatial: torch.Tensor   # bool
    has_temporal: torch.Tensor  # bool
    has_sid: torch.Tensor       # bool
    is_and: torch.Tensor        # bool


class MatchedShards(NamedTuple):
    """Index-lookup result: the shards a query must touch (paper §3.5.1)."""
    sid_hi: torch.Tensor    # (Q, S)
    sid_lo: torch.Tensor    # (Q, S)
    replicas: torch.Tensor  # (Q, S, 3)
    valid: torch.Tensor     # (Q, S)
    overflow: torch.Tensor  # (Q,) — more than S distinct shards matched


def init_index(n_edges: int, capacity: int, device="cpu") -> IndexState:
    def z(shape, dt, fill=0):
        return torch.full(shape, fill, dtype=dt, device=device)
    return IndexState(
        ent_f=z((n_edges, capacity, 6), torch.float32),
        ent_i=z((n_edges, capacity, 5), torch.int32, -1),
        valid=z((n_edges, capacity), torch.bool, False),
        cursor=z((n_edges,), torch.int32),
        dropped=z((n_edges,), torch.int32),
        retired=z((n_edges,), torch.int32),
        ent_step=z((n_edges, capacity), torch.int32),
    )


def selected_order(mask: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Indices along ``dim`` with the True entries first, each group in
    ascending order: ``order[k]`` is the k-th selected row (the inverse of
    the reference's ``cumsum(mask) - 1`` rank)."""
    return torch.sort((~mask).to(torch.int32), dim=dim, stable=True)[1]


def insert_entries(state: IndexState, meta: ShardMeta, replicas: torch.Tensor,
                   edge_mask: torch.Tensor, step: int = 0) -> IndexState:
    """Write index entries for B shards onto all edges in their mask, in
    place (see the module docstring).

    ``replicas`` (B, 3) int32, ``edge_mask`` (B, E) bool, ``step`` the ingest
    step (a Python int) recorded per entry.
    """
    e, cap = state.valid.shape
    b = edge_mask.shape[0]
    dev = edge_mask.device
    n_sel = edge_mask.sum(dim=0, dtype=torch.int32)                 # (E,)
    # Entry k of edge e goes to slot cursor[e] + k; it exists while
    # k < n_sel[e] and is kept while the slot is < cap. A window of
    # J = min(B, cap) consecutive slots (mod cap) is distinct per edge.
    j = min(b, cap)
    k = torch.arange(j, dtype=torch.int32, device=dev)[:, None]     # (J, 1)
    pos = state.cursor[None, :] + k                                 # (J, E)
    ok = (k < n_sel[None, :]) & (pos < cap)
    slot = (pos % cap).long()
    src = selected_order(edge_mask)[:j]                             # (J, E)
    ee = torch.arange(e, device=dev)[None, :].expand(j, e)

    vals_f = torch.stack([meta.lat0, meta.lat1, meta.lon0, meta.lon1,
                          meta.t0, meta.t1], dim=-1).to(torch.float32)
    vals_i = torch.cat([meta.sid_hi[:, None].to(torch.int32),
                        meta.sid_lo[:, None].to(torch.int32),
                        replicas.to(torch.int32)], dim=-1)
    okc = ok[..., None]
    state.ent_f[ee, slot] = torch.where(okc, vals_f[src], state.ent_f[ee, slot])
    state.ent_i[ee, slot] = torch.where(okc, vals_i[src], state.ent_i[ee, slot])
    state.valid[ee, slot] = ok | state.valid[ee, slot]
    step_t = torch.full((), step, dtype=torch.int32, device=dev)
    state.ent_step[ee, slot] = torch.where(ok, step_t, state.ent_step[ee, slot])

    n_dropped = (n_sel - (cap - state.cursor)).clamp(min=0)
    state.dropped.add_(n_dropped)
    state.cursor.copy_(torch.minimum(state.cursor + n_sel,
                                     torch.full_like(n_sel, cap)))
    return state


def retire_entries(state: IndexState, t_watermark: torch.Tensor) -> IndexState:
    """Invalidate, in place, entries whose newest timestamp is behind the
    retention watermark of EVERY replica edge (``t_watermark`` (E,) float32,
    ``-inf`` until an edge has aged out a tuple)."""
    reps = state.ent_i[..., 2:5].long()                             # (E, CAP, 3)
    rep_wm = t_watermark[reps.clamp(0, t_watermark.shape[0] - 1)]
    inf = torch.full((), float("inf"), device=rep_wm.device)
    rep_wm = torch.where(reps >= 0, rep_wm, inf)
    gone_everywhere = state.ent_f[..., 5] < rep_wm.amin(dim=-1)
    stale = state.valid & gone_everywhere
    state.valid.logical_and_(~stale)
    state.retired.add_(stale.sum(dim=1, dtype=torch.int32))
    return state


def compact_index(state: IndexState) -> IndexState:
    """Squash valid entries to the front of each edge's table (stable order)
    and rewind the cursor, in place."""
    order = selected_order(state.valid, dim=1)                      # (E, CAP)
    cursor = state.valid.sum(dim=1, dtype=torch.int32)
    o3 = order[..., None]
    state.ent_f.copy_(torch.gather(state.ent_f, 1, o3.expand(-1, -1, 6)))
    state.ent_i.copy_(torch.gather(state.ent_i, 1, o3.expand(-1, -1, 5)))
    state.valid.copy_(torch.gather(state.valid, 1, order))
    state.ent_step.copy_(torch.gather(state.ent_step, 1, order))
    state.cursor.copy_(cursor)
    return state


def entry_matches(state: IndexState, pred: QueryPred) -> torch.Tensor:
    """(Q, E, CAP) bool — which index entries satisfy each query predicate."""
    f = state.ent_f
    i = state.ent_i

    def bc(x):  # (Q,) -> (Q, 1, 1)
        return x[:, None, None]
    sp = ~((bc(pred.lat1) < f[None, :, :, 0]) | (f[None, :, :, 1] < bc(pred.lat0)) |
           (bc(pred.lon1) < f[None, :, :, 2]) | (f[None, :, :, 3] < bc(pred.lon0)))
    tp = ~((bc(pred.t1) < f[None, :, :, 4]) | (f[None, :, :, 5] < bc(pred.t0)))
    ip = (i[None, :, :, 0] == bc(pred.sid_hi)) & (i[None, :, :, 1] == bc(pred.sid_lo))
    hs, ht, hi = bc(pred.has_spatial), bc(pred.has_temporal), bc(pred.has_sid)
    m_and = (sp | ~hs) & (tp | ~ht) & (ip | ~hi)
    m_or = (sp & hs) | (tp & ht) | (ip & hi)
    return torch.where(bc(pred.is_and), m_and, m_or) & state.valid[None]


# Candidates per query block in ``dedup_matched``: bounds the sort's scratch
# (about 40 bytes a candidate) without changing any result.
_DEDUP_BLOCK = 1 << 25


def _row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 cumsum of a (Q, N) bool tensor along its rows, as one
    flat scan: PyTorch's row-wise scan of a few very long rows is an order of
    magnitude slower on the card than a device-wide scan, and the integer
    result is the same."""
    flat = torch.cumsum(x.reshape(-1), 0).reshape(x.shape)
    return flat - (flat[:, :1] - x[:, :1].to(flat.dtype))


def _dedup_block(m, hi, lo, replicas, max_shards):
    q, n = m.shape
    # Lexicographic (hi, lo) signed order as one int64 key.
    key = hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) + (1 << 31))
    key_s, p1 = torch.sort(key, dim=1, stable=True)
    m1 = torch.gather(m, 1, p1)
    # Stable partition, matched first: the reference's lexsort((lo, hi, ~m)).
    n_m = m1.sum(dim=1, keepdim=True, dtype=torch.int64)
    pos = torch.arange(n, device=m.device)[None, :]
    c_m = _row_cumsum(m1)
    part = torch.where(m1, c_m - 1, n_m + pos - c_m)
    p2 = torch.empty_like(part).scatter_(1, part, torch.arange(
        n, device=m.device).expand(q, n))
    perm = torch.gather(p1, 1, p2)                                  # (Q, N)
    key_s = torch.gather(key_s, 1, p2)
    m_s = pos < n_m
    prev_same = torch.zeros_like(m_s)
    prev_same[:, 1:] = (key_s[:, 1:] == key_s[:, :-1]) & m_s[:, :-1]
    is_new = m_s & ~prev_same
    n_unique = is_new.sum(dim=1, keepdim=True, dtype=torch.int64)
    # Output order: new sids first, then the rest, each in sorted order —
    # the reference's lexsort((arange, ~is_new))[:max_shards].
    c_new = _row_cumsum(is_new)
    dest = torch.where(is_new, c_new - 1, n_unique + pos - c_new)
    inv = torch.empty_like(dest).scatter_(1, dest, torch.arange(
        n, device=m.device).expand(q, n))[:, :max_shards]           # (Q, S)
    src = torch.gather(perm, 1, inv)
    rep = torch.gather(replicas, 1, src[..., None].expand(-1, -1, 3))
    return (torch.gather(hi, 1, src), torch.gather(lo, 1, src), rep,
            torch.gather(is_new, 1, inv), n_unique[:, 0] > max_shards)


def dedup_matched(matched: torch.Tensor, sid_hi: torch.Tensor,
                  sid_lo: torch.Tensor, replicas: torch.Tensor,
                  max_shards: int) -> MatchedShards:
    """Deduplicate candidate shard ids, batched over queries: the valid slots
    hold the ``max_shards`` smallest distinct matched sids in ascending
    (sid_hi, sid_lo) order, each with the replicas of its first candidate;
    ``overflow`` flags queries with more distinct matches than fit. Every
    slot, valid or not, equals the reference's.

    ``matched``/``sid_hi``/``sid_lo`` (Q, N), ``replicas`` (Q, N, 3); the
    inputs may be expanded views (``lookup`` passes the index table
    broadcast over queries without copying it).
    """
    q, n = matched.shape
    step = max(1, _DEDUP_BLOCK // max(n, 1))
    outs = [_dedup_block(matched[a:a + step], sid_hi[a:a + step],
                         sid_lo[a:a + step], replicas[a:a + step], max_shards)
            for a in range(0, q, step)]
    return MatchedShards(*(torch.cat([o[i] for o in outs]) for i in range(5)))


def match_candidates(state: IndexState, pred: QueryPred,
                     lookup_mask: torch.Tensor):
    """(matched, sid_hi, sid_lo, replicas), each (Q, E*CAP[, 3]); the id and
    replica arrays are expanded views of the index table (no copy)."""
    q = pred.lat0.shape[0]
    e, cap = state.valid.shape
    match = entry_matches(state, pred) & lookup_mask[:, :, None]
    flat_m = match.reshape(q, e * cap)
    flat_i = state.ent_i.reshape(1, e * cap, 5)
    sid_hi = flat_i[..., 0].expand(q, -1)
    sid_lo = flat_i[..., 1].expand(q, -1)
    reps = flat_i[..., 2:5].expand(q, -1, -1)
    return flat_m, sid_hi, sid_lo, reps


def lookup(state: IndexState, pred: QueryPred, lookup_mask: torch.Tensor,
           max_shards: int) -> MatchedShards:
    """Index lookup (paper §3.5.1): match entries on the selected lookup
    edges, deduplicate shard ids across edges, return up to ``max_shards``."""
    flat_m, sid_hi, sid_lo, reps = match_candidates(state, pred, lookup_mask)
    return dedup_matched(flat_m, sid_hi, sid_lo, reps, max_shards)
