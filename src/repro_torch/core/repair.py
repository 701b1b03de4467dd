"""Anti-entropy repair: epoch-scoped re-replication after outages.

Port of ``repro.core.repair`` (its module docstring states the five sweep
steps and the outage-epoch contract; both hold here unchanged):

  1. re-placement of swept shards whose canonical replica set (under the
     current alive mask) differs from the stored one, where a live copy
     survives; a shard with none is unrepairable and keeps naming its dead
     replicas, so queries keep reporting the loss;
  2. tuple backfill of every new replica that lacks the shard's tuples, from
     the surviving replica holding the most of them;
  3. ring reclamation of copies on alive edges outside a swept shard's
     canonical set (re-packed in chronological order, freed slots reset);
  4. index backfill of every holder edge (slice owners + replicas) that
     lacks the shard's entry;
  5. entry reclamation on alive edges outside the canonical holder set.

``OutageLog`` restricts the sweep to the shards an outage could have
touched (entries written inside a closed window, stored replicas on a
still-dead edge, pending keys); the incremental sweep is bitwise the full
sweep (``outage=None``).

The sweep is host-side numpy, as the reference's is, and written as the
reference writes it (numpy fancy indexing, whose duplicate-slot semantics a
torch scatter does not share). On the card, each leaf is read to the host
once and written back once, in place (``copy_``) into the state's own
tensors (ROADMAP, "State updates": keep a clone of a state you still need);
the two placement calls of the swept subset, ``place_replicas`` and
``_index_edge_mask``, run on the state's device, so the ``hash64`` and
``voronoi_assign`` kernels run inside a repair on the card. Nothing of the
state is read inside the sweep loop.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.datastore import (_COUNT_SAT, StoreConfig, StoreState,
                                        _index_edge_mask)
from repro_torch.core.placement import ShardMeta, place_replicas

__all__ = ["OutageLog", "host_copy", "repair_state", "sid_key"]

# Leaves the sweep reads and writes back, by (StoreState | IndexState) field.
_INDEX_LEAVES = ("ent_f", "ent_i", "valid", "cursor", "dropped", "retired",
                 "ent_step")
_LOG_LEAVES = ("tup_f", "tup_sid", "tup_count", "tup_pos", "tup_overwritten")


def sid_key(hi, lo) -> int:
    """Pack a (sid_hi, sid_lo) pair into the sweep's 64-bit shard key."""
    return (int(hi) << 32) | (int(lo) & 0xFFFFFFFF)


class OutageLog(NamedTuple):
    """Host-side outage ledger driving the incremental sweep. Built by
    ``AerialDB`` from its fail/recover call history.

    windows:        closed epoch windows ``(fail_step, recover_step)`` —
                    membership is ``fail_step < ent_step <= recover_step``
                    (``fail_step == -1`` covers every entry).
    affected_edges: the edges of the outages still open (dead now).
    pending_sids:   64-bit shard keys swept under a degraded mask (or whose
                    entries were dropped at ingest), re-swept until a repair
                    completes with every edge alive.
    """
    windows: Tuple[Tuple[int, int], ...] = ()
    affected_edges: Tuple[int, ...] = ()
    pending_sids: Tuple[int, ...] = ()


def host_copy(x) -> np.ndarray:
    """A host numpy copy of a tensor or array-like ``x`` that shares no
    memory with it (``.cpu()`` of a CPU tensor is the tensor itself, which
    the sweep must not mutate)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _shard_table(ent_i, ent_f, valid):
    """Flatten valid index entries into a deduplicated shard table.

    Returns (ev, ec, entry_key, uniq_keys, first_idx): entry coordinates,
    each entry's 64-bit sid key, the ascending unique keys, and the index of
    each unique shard's first (representative) entry.
    """
    ev, ec = np.nonzero(valid)
    hi = ent_i[ev, ec, 0].astype(np.int64)
    lo = ent_i[ev, ec, 1].astype(np.int64) & 0xFFFFFFFF
    key = (hi << 32) | lo
    uniq, first = np.unique(key, return_index=True)
    return ev, ec, key, uniq, first


def _chrono_order(slots: np.ndarray, count: int, pos: int, cap: int):
    """Sort ring slot indices into write-chronological (oldest-first) order.

    Unwrapped rings (``count <= cap``) fill slots 0..count-1 in write order,
    so ascending slot IS chronological; wrapped rings start their window at
    ``pos`` (the next-overwrite = oldest slot)."""
    if count <= cap:
        return np.sort(slots)
    return slots[np.argsort((slots - pos) % cap, kind="stable")]


def _backfill_copy(tup_f, tup_sid, tup_count, tup_pos, tup_over,
                   src, dst, hit_chrono, hi, lo, cap: int) -> int:
    """Append shard (hi, lo)'s tuples from ``src``'s ring slots
    ``hit_chrono`` (chronological order) onto ``dst``'s ring through the
    normal cursor, clamped to the NEWEST ``cap`` tuples (a larger hit would
    scatter onto itself and inflate ``tup_count`` / ``tup_overwritten``).
    Returns the number of tuples copied; the telemetry counters are exact
    for any hit size, ``hit == cap`` and ``hit > cap`` included."""
    n_copy = min(int(hit_chrono.size), cap)
    take = hit_chrono[hit_chrono.size - n_copy:]
    slots = (int(tup_pos[dst]) + np.arange(n_copy)) % cap
    tup_f[dst][:, slots] = tup_f[src][:, take]
    tup_sid[dst][0, slots] = hi
    tup_sid[dst][1, slots] = lo
    before = min(int(tup_count[dst]), cap)
    tup_count[dst] = min(int(tup_count[dst]) + n_copy, _COUNT_SAT)
    after = min(int(tup_count[dst]), cap)
    tup_over[dst] = min(int(tup_over[dst]) + before + n_copy - after,
                        _COUNT_SAT)
    tup_pos[dst] = (int(tup_pos[dst]) + n_copy) % cap
    return n_copy


def repair_state(cfg: StoreConfig, state: StoreState, alive,
                 outage: Optional[OutageLog] = None, *,
                 timings: Optional[dict] = None) -> Tuple[StoreState, dict]:
    """Run the anti-entropy sweep (module docstring) against ``state``.

    Args:
      cfg:     deployment config (placement + slicing geometry).
      state:   StoreState on any device; updated IN PLACE when a shard is
               swept (clone it first to keep the pre-repair state).
      alive:   (E,) bool, tensor or array — the CURRENT availability mask;
               dead edges never receive copies or entries and are never
               mutated.
      outage:  optional ``OutageLog``; ``None`` sweeps every tracked shard.
      timings: optional dict, filled with the sweep's host seconds:
               ``d2h_s`` (leaves to the host), ``placement_s`` (the two
               device placement calls and their results' read-back),
               ``sweep_s`` (the numpy sweep) and ``h2d_s`` (the write-back),
               and ``swept`` (the subset's size).

    Returns (state, info): the same ``state`` and the reference's telemetry
    dict — ``shards_tracked``, ``shards_swept``, ``shards_replaced``,
    ``shards_unrepairable``, ``tuples_copied``, ``slots_reclaimed``,
    ``entries_rewritten``, ``entries_backfilled``, ``entries_reclaimed``,
    ``entries_dropped``, ``mode`` (``full``/``incremental``) and
    ``_swept_keys`` (the swept shards' sid keys, for the session's
    pending-sweep bookkeeping).
    """
    clock = {} if timings is None else timings
    clock.clear()
    clock.update(d2h_s=0.0, placement_s=0.0, sweep_s=0.0, h2d_s=0.0, swept=0)
    t0 = time.perf_counter()
    e = state.tup_f.shape[0]
    cap = cfg.tuple_capacity
    dev = state.tup_f.device
    alive_np = host_copy(alive).astype(bool)

    info = {"shards_tracked": 0, "shards_swept": 0, "shards_replaced": 0,
            "shards_unrepairable": 0, "tuples_copied": 0,
            "slots_reclaimed": 0, "entries_rewritten": 0,
            "entries_backfilled": 0, "entries_reclaimed": 0,
            "entries_dropped": 0,
            "mode": "full" if outage is None else "incremental",
            "_swept_keys": ()}

    ix = {f: host_copy(getattr(state.index, f)) for f in _INDEX_LEAVES}
    ent_f, ent_i, valid = ix["ent_f"], ix["ent_i"], ix["valid"]
    clock["d2h_s"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    ev, ec, key, uniq, first = _shard_table(ent_i, ent_f, valid)
    n = uniq.shape[0]
    info["shards_tracked"] = int(n)
    if n == 0:
        clock["sweep_s"] += time.perf_counter() - t0
        return state, info

    # Representative meta + stored replicas per tracked shard.
    f0 = ent_f[ev[first], ec[first]]                       # (N, 6)
    old3 = ent_i[ev[first], ec[first], 2:5]                # (N, 3)

    # --- sweep selection: the O(outage) filter -------------------------
    if outage is None:
        sel = np.ones(n, bool)
    else:
        inv = np.searchsorted(uniq, key)                   # entry -> shard
        ent_step = ix["ent_step"][ev, ec]
        in_win = np.zeros(ev.shape[0], bool)
        for fail_step, recover_step in outage.windows:
            in_win |= (ent_step > fail_step) & (ent_step <= recover_step)
        win_sel = np.zeros(n, bool)
        np.logical_or.at(win_sel, inv, in_win)
        aff = np.zeros(e, bool)
        if len(outage.affected_edges):
            aff[np.asarray(outage.affected_edges, int)] = True
        rep_sel = np.any((old3 >= 0) & aff[np.clip(old3, 0, e - 1)], axis=1)
        pend_sel = np.isin(
            uniq, np.asarray(outage.pending_sids, np.int64))
        sel = win_sel | rep_sel | pend_sel
    sel_idx = np.nonzero(sel)[0]
    info["shards_swept"] = int(sel_idx.size)
    info["_swept_keys"] = tuple(int(k) for k in uniq[sel_idx])
    clock["swept"] = int(sel_idx.size)
    clock["sweep_s"] += time.perf_counter() - t0
    if sel_idx.size == 0:
        # Nothing the outage could have touched — telemetry-only no-op.
        return state, info

    t0 = time.perf_counter()
    cursor, dropped, retired = ix["cursor"], ix["dropped"], ix["retired"]
    ent_step_tab = ix["ent_step"]
    tup_f, tup_sid, tup_count, tup_pos, tup_over = (
        host_copy(getattr(state, f)) for f in _LOG_LEAVES)
    step_now = int(state.steps)
    clock["d2h_s"] += time.perf_counter() - t0

    # Canonical placement under the current mask, for the swept subset in
    # one batch on the state's device (row-independent, so the rows equal a
    # full-store batch's), and where each swept shard's entry belongs.
    t0 = time.perf_counter()

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rows = (ev[first[sel_idx]], ec[first[sel_idx]])
    meta = ShardMeta(
        sid_hi=on_dev(ent_i[rows + (0,)]), sid_lo=on_dev(ent_i[rows + (1,)]),
        lat0=on_dev(f0[sel_idx, 0]), lat1=on_dev(f0[sel_idx, 1]),
        lon0=on_dev(f0[sel_idx, 2]), lon1=on_dev(f0[sel_idx, 3]),
        t0=on_dev(f0[sel_idx, 4]), t1=on_dev(f0[sel_idx, 5]))
    sites = cfg.sites_array(dev)
    alive_dev = on_dev(alive_np)
    new_dev = place_replicas(meta, sites, alive_dev, cfg.tau,
                             n_domains=cfg.n_failure_domains)
    new3_dev = torch.full((sel_idx.size, 3), -1, dtype=torch.int32,
                          device=dev)
    new3_dev[:, : cfg.replication] = new_dev[:, : cfg.replication]
    want_dev = _index_edge_mask(cfg, meta, new3_dev, sites, alive_dev)
    new3 = new3_dev.cpu().numpy()                          # (n_sel, 3)
    want = want_dev.cpu().numpy()                          # (n_sel, E)
    clock["placement_s"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    # Where entries currently exist, per shard x edge.
    present = np.zeros((n, e), bool)
    present[np.searchsorted(uniq, key), ev] = True

    # Entry groups per shard, precomputed once: entries of shard i are
    # order[starts[i]:ends[i]] (avoids an O(entries) rescan per shard).
    order = np.argsort(key, kind="stable")
    starts = np.searchsorted(key, uniq, side="left", sorter=order)
    ends = np.searchsorted(key, uniq, side="right", sorter=order)

    def live_window(edge):
        """Live ring slots on ``edge`` right now (backfills grow it)."""
        return min(int(tup_count[edge]), cap)

    def holds_tuples(edge, hi, lo):
        w = live_window(edge)
        return bool(np.any((tup_sid[edge, 0, :w] == hi)
                           & (tup_sid[edge, 1, :w] == lo)))

    reclaim = {}   # edge -> set of 64-bit sid keys to retire from its ring

    for j, i in enumerate(sel_idx):
        old_set = {int(r) for r in old3[i] if r >= 0}
        new_set = {int(r) for r in new3[j] if r >= 0}
        hi = int(ent_i[ev[first[i]], ec[first[i]], 0])
        lo = int(ent_i[ev[first[i]], ec[first[i]], 1])
        unrepairable = False

        if new_set != old_set:
            # 1-2. The copy source is the alive replica holding the MOST of
            # the shard's tuples (rings wrap at independent rates).
            hit = np.empty(0, np.int64)
            src = -1
            for cand in sorted(old_set):
                if not alive_np[cand]:
                    continue
                w = live_window(cand)
                h = np.nonzero((tup_sid[cand, 0, :w] == hi)
                               & (tup_sid[cand, 1, :w] == lo))[0]
                if h.size > hit.size:
                    hit, src = h, cand
            if hit.size == 0:
                # Unrepairable: keep the stored set, so the loss stays
                # visible (step 4 still backfills entries naming it).
                info["shards_unrepairable"] += 1
                unrepairable = True
                new3[j] = old3[i]
            else:
                idx = order[starts[i]:ends[i]]
                ent_i[ev[idx], ec[idx], 2:5] = new3[j]
                info["entries_rewritten"] += int(idx.size)
                info["shards_replaced"] += 1
                chrono = _chrono_order(hit, int(tup_count[src]),
                                       int(tup_pos[src]), cap)
                for dst in sorted(new_set):
                    if not alive_np[dst] or holds_tuples(dst, hi, lo):
                        continue
                    info["tuples_copied"] += _backfill_copy(
                        tup_f, tup_sid, tup_count, tup_pos, tup_over,
                        src, dst, chrono, hi, lo, cap)

        # 3. ring reclamation on alive edges outside the canonical set
        # (batched per edge after the sweep); unrepairable shards exempt.
        if not unrepairable:
            for dst in range(e):
                if alive_np[dst] and dst not in new_set:
                    reclaim.setdefault(dst, set()).add(sid_key(hi, lo))

        # 4. backfill missing index entries (slice owners + replicas).
        for dst in np.nonzero(want[j] & ~present[i])[0]:
            c = int(cursor[dst])
            if c >= valid.shape[1]:
                dropped[dst] += 1
                info["entries_dropped"] += 1
                continue
            ent_f[dst, c] = f0[i]
            ent_i[dst, c, 0] = hi
            ent_i[dst, c, 1] = lo
            ent_i[dst, c, 2:5] = new3[j]
            valid[dst, c] = True
            ent_step_tab[dst, c] = step_now
            cursor[dst] = c + 1
            info["entries_backfilled"] += 1

        # 5. entry reclamation on alive edges outside the holder set;
        # unrepairable shards keep every entry.
        if not unrepairable:
            idx = order[starts[i]:ends[i]]
            stale = idx[alive_np[ev[idx]] & ~want[j, ev[idx]]]
            if stale.size:
                valid[ev[stale], ec[stale]] = False
                np.add.at(retired, ev[stale], 1)
                info["entries_reclaimed"] += int(stale.size)

    # Step 3's re-pack, per edge: drop every live slot whose sid was retired
    # from this edge, squash survivors to the front in chronological order,
    # reset the freed slots (through the padded capacity) to the
    # never-written sentinel.
    for dst in sorted(reclaim):
        w = live_window(dst)
        if w == 0:
            continue
        chrono = _chrono_order(np.arange(w, dtype=np.int64),
                               int(tup_count[dst]), int(tup_pos[dst]), cap)
        k = ((tup_sid[dst, 0, chrono].astype(np.int64) << 32)
             | (tup_sid[dst, 1, chrono].astype(np.int64) & 0xFFFFFFFF))
        drop = np.isin(k, np.fromiter(reclaim[dst], np.int64,
                                      len(reclaim[dst])))
        n_drop = int(np.sum(drop))
        if n_drop == 0:
            continue
        keep = chrono[~drop]
        n_keep = keep.size
        tup_f[dst][:, :n_keep] = tup_f[dst][:, keep]
        tup_sid[dst][:, :n_keep] = tup_sid[dst][:, keep]
        tup_f[dst][:, n_keep:] = 0.0
        tup_sid[dst][:, n_keep:] = -1
        tup_count[dst] = n_keep
        tup_pos[dst] = n_keep % cap
        tup_over[dst] = min(int(tup_over[dst]) + n_drop, _COUNT_SAT)
        info["slots_reclaimed"] += n_drop
    clock["sweep_s"] += time.perf_counter() - t0

    # Write-back, in place: tup_dropped, steps and the latest cache are
    # left alone, as the reference leaves them.
    t0 = time.perf_counter()
    for f in _INDEX_LEAVES:
        getattr(state.index, f).copy_(torch.from_numpy(ix[f]))
    for f, a in zip(_LOG_LEAVES, (tup_f, tup_sid, tup_count, tup_pos,
                                  tup_over)):
        getattr(state, f).copy_(torch.from_numpy(a))
    clock["h2d_s"] += time.perf_counter() - t0
    return state, info
