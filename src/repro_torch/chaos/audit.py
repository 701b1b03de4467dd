"""Order-insensitive bitwise store audits (port of ``repro.chaos.audit``).

After recovery and repair, a faulted store holds exactly the data a
never-faulted run does — the same tuple bits on the same edges, the same
per-shard replica sets, the same index coverage — but not the same ring
layout: repair appends backfilled copies at ring tails in sweep order and
stamps backfilled index entries with the repair step, where the reference
interleaved them in insert order. The bitwise property (incremental repair
== full sweep from the same pre-state) is asserted on states directly;
equivalence across histories is asserted on this module's canonical form:
:func:`canonical_content` sorts each edge's live ring window by record bits
and reduces the index to per-shard (replica set, holder-edge set), so two
stores with the same content compare equal whatever their write order or
entry epochs.

Precondition: no retention eviction during the compared histories. Ring
wraparound retires the oldest tuples per edge, and faults skew per-edge
load, so once any ring wraps, the faulted and never-faulted histories age
out different tuples. Harnesses that gate on content equality size
``tuple_capacity`` above the workload's total volume and check
``tup_overwritten == 0``.

Each leaf is read to the host once (``.cpu()``); on the card that waits
for the work queued on the state.
"""

from __future__ import annotations

import numpy as np

__all__ = ["canonical_content", "assert_content_equal"]


def canonical_content(db) -> dict:
    """Canonical (order-insensitive, bit-exact) content of a session's
    store: ``edges`` — per-edge (w, 2 + width) int64 matrices of the live
    ring window's records ``[sid_hi, sid_lo, float32-bits...]`` sorted
    lexicographically, and ``index`` — ``{sid_key: (replica tuple, holder
    edge tuple)}`` over valid entries."""
    state, cfg = db.state, db.cfg
    cap = cfg.tuple_capacity
    tup_f = state.tup_f.cpu().numpy()
    tup_sid = state.tup_sid.cpu().numpy()
    tup_count = state.tup_count.cpu().numpy()
    edges = []
    for e in range(cfg.n_edges):
        w = min(int(tup_count[e]), cap)
        rows = np.empty((w, 2 + cfg.tuple_width), np.int64)
        rows[:, 0] = tup_sid[e, 0, :w]
        rows[:, 1] = tup_sid[e, 1, :w]
        # float32 bit patterns, not values: NaN payload channels stay
        # comparable and -0.0 != 0.0 stays visible.
        rows[:, 2:] = tup_f[e, :, :w].T.astype(np.float32).view(np.int32)
        edges.append(rows[np.lexsort(rows.T[::-1])])

    ent_i = state.index.ent_i.cpu().numpy()
    valid = state.index.valid.cpu().numpy()
    index: dict = {}
    for v, c in zip(*np.nonzero(valid)):
        key = (int(ent_i[v, c, 0]) << 32) | (int(ent_i[v, c, 1])
                                             & 0xFFFFFFFF)
        reps = tuple(sorted(int(r) for r in ent_i[v, c, 2:5] if r >= 0))
        holders = index.setdefault(key, (reps, set()))[1]
        holders.add(int(v))
    return {"edges": edges,
            "index": {k: (reps, tuple(sorted(h)))
                      for k, (reps, h) in sorted(index.items())}}


def assert_content_equal(a: dict, b: dict, msg: str = "") -> None:
    """Assert two :func:`canonical_content` snapshots are identical."""
    assert len(a["edges"]) == len(b["edges"]), f"{msg}edge count differs"
    for e, (ra, rb) in enumerate(zip(a["edges"], b["edges"])):
        np.testing.assert_array_equal(
            ra, rb, err_msg=f"{msg}edge {e} ring content differs")
    assert a["index"].keys() == b["index"].keys(), (
        f"{msg}tracked shard sets differ: only-a="
        f"{sorted(set(a['index']) - set(b['index']))[:5]} only-b="
        f"{sorted(set(b['index']) - set(a['index']))[:5]}")
    for k in a["index"]:
        assert a["index"][k] == b["index"][k], (
            f"{msg}shard {k >> 32}/{k & 0xFFFFFFFF}: "
            f"{a['index'][k]} != {b['index'][k]}")
