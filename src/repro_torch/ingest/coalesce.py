"""Batch coalescing for the streaming ingest pipeline (port of
``repro.ingest.coalesce``, numpy only).

Accepted telemetry records are ragged — per-drone, arbitrary rates, gaps —
but the store wants shards: ``(B, R, 3+V)`` payloads plus a ``ShardMeta``
per shard, at a *small set of shapes* (the reference compiles each distinct
``(B, R)`` once; the port keeps the same batches so both packages take the
same inserts). This module owns that reshaping:

* ``group_shards``: stable-sort pending records by ``(drone, seq)`` and cut
  each drone's run into consecutive ``records_per_shard``-sized groups —
  one shard each, ``sid = (drone, per-drone emitted-shard counter)``, bbox
  and time range derived from the group. Seq gaps inside a group are
  tolerated (drops are data loss, not shard loss); the trailing partial
  group per drone stays pending unless draining, in which case partial
  groups are emitted batched BY SIZE (one ``(B_k, k, W)`` payload per
  distinct group size k, keeping the set of shapes bounded).
* ``plan_chunks``: split B shards into device batches — full
  ``batch_shards``-sized chunks (stacked into ONE ``ingest_rounds`` call)
  plus a descending powers-of-two tail, so a streaming session sees
  O(log B) insert shapes in all instead of one per flush size.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.api import ShardMeta

__all__ = ["plan_chunks", "group_shards"]


def plan_chunks(n: int, b_max: int) -> List[int]:
    """Batch sizes covering ``n`` shards: ``n // b_max`` full chunks, then a
    descending powers-of-two decomposition of the remainder — every size
    emitted is ``b_max`` or a power of two < ``b_max``, so the set of
    insert shapes stays O(log b_max) across a whole session."""
    if n < 0 or b_max < 1:
        raise ValueError(f"plan_chunks needs n >= 0, b_max >= 1 "
                         f"(got n={n}, b_max={b_max}).")
    sizes = [b_max] * (n // b_max)
    rem = n % b_max
    p = 1 << max(rem.bit_length() - 1, 0)
    while rem:
        if p <= rem:
            sizes.append(p)
            rem -= p
        p >>= 1
    return sizes


def group_shards(drone, seq, rows, records_per_shard: int,
                 shard_seq: Dict[int, int], drain: bool):
    """Cut sorted pending records into shard groups.

    Args:
      drone / seq: (N,) int arrays (any order; stably sorted here).
      rows:        (N, W) float32 records.
      records_per_shard: full-shard group size R.
      shard_seq:   per-drone emitted-shard counter, MUTATED as sids are
                   assigned (sid_lo must stay unique per drone across
                   flushes).
      drain:       emit trailing partial (< R) groups too.

    Returns ``(batches, leftover)``: ``batches`` maps group size k to a
    ``(payload (B_k, k, W) float32, ShardMeta numpy fields, submit_order
    (B_k, k) int)`` triple (``submit_order`` carries each record's original
    position, for latency accounting); ``leftover`` is the index array of
    records kept pending (empty when draining).
    """
    drone = np.asarray(drone)
    seq = np.asarray(seq)
    n = drone.shape[0]
    order = np.lexsort((seq, drone))
    d_s = drone[order]
    # Group boundaries: starts of each drone's run.
    starts = np.r_[0, np.nonzero(d_s[1:] != d_s[:-1])[0] + 1, n]
    per_size: Dict[int, List[Tuple[np.ndarray, int]]] = {}
    leftover: List[np.ndarray] = []
    r = records_per_shard
    for a, b in zip(starts[:-1], starts[1:]):
        did = int(d_s[a])
        run = order[a:b]
        n_full = (b - a) // r
        for g in range(n_full):
            per_size.setdefault(r, []).append((run[g * r:(g + 1) * r], did))
        tail = run[n_full * r:]
        if tail.size == 0:
            continue
        if drain:
            per_size.setdefault(tail.size, []).append((tail, did))
        else:
            leftover.append(tail)
    batches = {}
    for k, groups in sorted(per_size.items()):
        idx = np.stack([g for g, _ in groups])                   # (B_k, k)
        dids = np.asarray([d for _, d in groups], np.int32)
        pay = rows[idx].astype(np.float32)                       # (B_k, k, W)
        lo = np.empty(len(groups), np.int32)
        for i, did in enumerate(dids):
            lo[i] = shard_seq.get(int(did), 0)
            shard_seq[int(did)] = int(lo[i]) + 1
        meta = ShardMeta(
            sid_hi=dids, sid_lo=lo,
            lat0=pay[:, :, 1].min(1).astype(np.float32),
            lat1=pay[:, :, 1].max(1).astype(np.float32),
            lon0=pay[:, :, 2].min(1).astype(np.float32),
            lon1=pay[:, :, 2].max(1).astype(np.float32),
            t0=pay[:, :, 0].min(1).astype(np.float32),
            t1=pay[:, :, 0].max(1).astype(np.float32))
        batches[k] = (pay, meta, idx)
    left = (np.concatenate(leftover) if leftover
            else np.empty(0, np.int64))
    return batches, left
