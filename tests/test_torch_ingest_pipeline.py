"""The streaming ingest pipeline of ``repro_torch`` held against the JAX
package's: the port of ``tests/test_ingest_pipeline.py``, case by case. The
port's ``IngestPipeline`` over a port session on the CPU and the reference's
over a JAX session take the same stream in lockstep; policy: every StoreState
/ IndexState leaf bitwise, the counters and every flush summary equal
(``latency_s`` by its length only: it is a wall clock), ``latest()`` bitwise,
query counts equal.

Also here: the retry and give-up path and a crash replayed from the journal
against the reference, and the package boundary (``repro_torch.ingest`` and
the session import neither JAX nor the JAX package).

``test_latest_cache_identical_on_meshes`` runs the reference's mesh case
on both of its layouts, the ``(4,) ("edge",)`` mesh and the ``(2, 2)
("fleet", "edge")`` mesh: pipelines over the JAX package's 4-device mesh,
the port's one-process mesh of the same layout and the port's single
store.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.api import AerialDB as JaxDB
from repro.core import datastore as jds
from repro.ingest import IngestPipeline as JaxPipeline
from repro.ingest import PipelineCrash as JaxCrash
from repro.ingest import TransientDispatchError as JaxTransient
from repro.ingest import group_shards as j_group_shards
from repro.ingest import plan_chunks as j_plan_chunks
from repro_torch import convert
from repro_torch.api import AerialDB, Query
from repro_torch.core import datastore as tds
from repro_torch.data.synthetic import CityConfig, DroneFleet, make_sites
from repro_torch.ingest import (IngestPipeline, PipelineCrash,
                                TransientDispatchError, group_shards,
                                latest_oracle, plan_chunks)
from test_torch_repair import (Pair, _assert_states_identical, _bits,
                               bucketed_reference_placement,  # noqa: F401
                               mesh_pair)

E = 8
D_MAX = 16
R = 4
SITES = tuple(map(tuple, make_sites(E, CityConfig(), seed=3).tolist()))
CFG_KW = dict(n_edges=E, sites=SITES, tuple_capacity=2048, index_capacity=512,
              max_shards_per_query=64, records_per_shard=R, retention_every=2,
              max_drones=D_MAX)
CATCH_ALL = dict(q=1, t0=-1e9, t1=1e9, has_temporal=True, is_and=True)


class PipePair:
    """A JAX pipeline and a port pipeline (CPU) driven in lockstep."""

    def __init__(self, pipe_kw=None, **overrides):
        kw = dict(CFG_KW, **overrides)
        pipe_kw = pipe_kw or {}
        self.j = JaxPipeline(JaxDB.open(jds.StoreConfig(**kw), seed=0), **pipe_kw)
        self.t = IngestPipeline(AerialDB.open(tds.StoreConfig(**kw), seed=0,
                                              device="cpu"), **pipe_kw)

    def submit_arrays(self, *cols):
        jc, tc = self.j.submit_arrays(*cols), self.t.submit_arrays(*cols)
        assert tc == jc
        return tc

    def submit(self, records):
        jc, tc = self.j.submit(records), self.t.submit(records)
        assert tc == jc
        return tc

    def flush(self, **kw):
        jout, tout = self.j.flush(**kw), self.t.flush(**kw)
        _assert_summaries_equal(tout, jout)
        return tout

    def check(self, msg=""):
        _assert_states_identical(self.t.db.state, self.j.db.state, msg)
        assert self.t.counters == self.j.counters, msg
        assert self.t.pending == self.j.pending
        assert self.t.reconcile() == self.j.reconcile(), msg
        trec, tval = self.t.latest()
        jrec, jval = self.j.latest()
        np.testing.assert_array_equal(tval, jval)
        np.testing.assert_array_equal(_bits(trec), _bits(jrec))

    def total_count(self):
        jres, _ = self.j.db.query(jds.make_pred(**CATCH_ALL),
                                  key=jax.random.key(0))
        tres, _ = self.t.db.query(
            tds.make_pred(**CATCH_ALL, device="cpu"),
            key=convert.key_from_numpy(jax.random.key_data(jax.random.key(0))))
        assert int(tres.count[0]) == int(np.asarray(jres.count)[0])
        return int(tres.count[0])


def _assert_summaries_equal(got, want):
    assert set(got) == set(want)
    for k in got:
        if k == "latency_s":
            assert np.asarray(got[k]).shape == np.asarray(want[k]).shape
        else:
            assert got[k] == want[k], k


def _stream(seed, n_drones=10, max_seq=12):
    """An adversarial stream and its clean form, as ``(drone, seq, rows)``
    triples: records of up to ``max_seq`` seqs a drone with about a tenth of
    the seqs never sent, a tenth of the records NaN from a random value
    channel on, a tenth re-sent, all shuffled; ``clean`` is the deduped set
    sorted by ``(drone, seq)``."""
    rng = np.random.default_rng(seed)
    drone, seq, rows = [], [], []
    for d in range(n_drones):
        n = int(rng.integers(1, max_seq + 1))
        for s in np.arange(n)[rng.random(n) > 0.1]:
            row = np.empty(7, np.float32)
            row[:3] = (1000.0 * s + d, 12.9 + 0.001 * d, 77.5 + 0.0005 * s)
            row[3:] = rng.normal(25, 5, 4)
            if rng.random() < 0.1:
                row[3 + int(rng.integers(0, 4)):] = np.nan
            drone.append(d), seq.append(s), rows.append(row)
    drone, seq, rows = np.asarray(drone), np.asarray(seq), np.stack(rows)
    dup = rng.integers(0, len(drone), max(len(drone) // 10, 1))
    order = rng.permutation(np.r_[np.arange(len(drone)), dup])
    srt = np.lexsort((seq, drone))
    return ((drone[order], seq[order], rows[order]),
            (drone[srt], seq[srt], rows[srt]))


def _submit_stream(pipe, stream, n_chunks):
    d, s, rows = stream
    for part in np.array_split(np.arange(d.shape[0]), n_chunks):
        pipe.submit_arrays(d[part], s[part], rows[part, 0], rows[part, 1],
                           rows[part, 2], rows[part, 3:])


# ---------------------------------------------------------------------------
# adversarial streams == the sorted, deduped stream; port == JAX
# ---------------------------------------------------------------------------


@given(st.integers(0, 1 << 30))
@settings(deadline=None, max_examples=6)
def test_adversarial_stream_state_bitwise_equivalent(seed):
    """A shuffled, duplicated, partial, gappy stream in bursts, then one
    drain: the port's state is bitwise the clean stream's through a port
    pipeline, and bitwise the reference pipeline's on the same bursts."""
    rng = np.random.default_rng(seed + 1)
    stream, clean = _stream(seed)
    adv = PipePair()
    ref = IngestPipeline(AerialDB.open(tds.StoreConfig(**CFG_KW), seed=0,
                                       device="cpu"))
    _submit_stream(adv, stream, int(rng.integers(1, 5)))
    _submit_stream(ref, clean, 1)
    assert adv.t.counters["accepted"] == clean[0].shape[0]
    assert adv.t.counters["duplicate"] == stream[0].shape[0] - clean[0].shape[0]
    adv.flush(drain=True)
    ref.flush(drain=True)
    _assert_states_identical(adv.t.db.state, ref.db.state)
    adv.check()
    rec = adv.t.reconcile()
    assert rec["ok"], rec
    assert rec["pending"] == 0


@given(st.integers(0, 1 << 30))
@settings(deadline=None, max_examples=4)
def test_burst_interleaved_flushes_content_equivalent(seed):
    """Flushes between submit bursts: every flush summary, the states and
    the counters equal the reference's; the catch-all count is the deduped
    total and the latest cache equals the oracle."""
    rng = np.random.default_rng(seed + 2)
    stream, clean = _stream(seed)
    pair = PipePair()
    d, s, rows = stream
    for part in np.array_split(np.arange(d.shape[0]), int(rng.integers(2, 5))):
        pair.submit_arrays(d[part], s[part], rows[part, 0], rows[part, 1],
                           rows[part, 2], rows[part, 3:])
        pair.flush()
        pair.check()
    pair.flush(drain=True)
    pair.check()
    rec = pair.t.reconcile()
    assert rec["ok"] and rec["pending"] == 0, rec
    assert pair.total_count() == clean[0].shape[0]
    o_rec, o_val = latest_oracle(clean[0], clean[2][:, 0], clean[2], D_MAX)
    got = pair.t.db.latest()
    np.testing.assert_array_equal(got.valid.numpy(), o_val)
    np.testing.assert_array_equal(_bits(got.record.numpy()), _bits(o_rec))


def test_pipeline_latest_overlays_pending():
    """Unflushed records are part of ``latest()``: the overlay equals the
    oracle over everything submitted, and the reference's overlay."""
    pair = PipePair()
    stream, clean = _stream(7)
    _submit_stream(pair, stream, 1)
    pair.flush()
    assert pair.t.pending > 0
    o_rec, o_val = latest_oracle(clean[0], clean[2][:, 0], clean[2], D_MAX)
    rec, val = pair.t.latest()
    np.testing.assert_array_equal(val, o_val)
    np.testing.assert_array_equal(_bits(rec), _bits(o_rec))
    assert int(pair.t.db.latest().valid.sum()) <= int(o_val.sum())
    pair.check()


# ---------------------------------------------------------------------------
# mechanics: dedup, holes, backpressure, chunk planning
# ---------------------------------------------------------------------------


def test_out_of_order_and_gap_refill():
    """A seq gap leaves holes that late arrivals fill exactly once."""
    pair = PipePair()

    def sub(pairs):
        return pair.submit([(d, s, 10.0 * s + d, 12.9, 77.5, 1, 2, 3, 4)
                            for d, s in pairs])
    c = sub([(0, 0), (0, 5)])
    assert c["accepted"] == 2
    c = sub([(0, 3)])
    assert c["accepted"] == 3 and c["duplicate"] == 0
    c = sub([(0, 3), (0, 5), (0, 0)])
    assert c["accepted"] == 3 and c["duplicate"] == 3
    assert pair.t._holes == pair.j._holes == {0: {1, 2, 4}}


def test_malformed_and_partial_records():
    pair = PipePair()
    c = pair.submit([
        (0, 0, 1.0, 12.9, 77.5, 1.0, 2.0, 3.0, 4.0),   # complete
        (1, 0, np.nan, 12.9, 77.5, 1.0),               # malformed t
        (-3, 0, 1.0, 12.9, 77.5),                      # malformed id
        (2, 0, 2.0, 12.9, 77.5, 1.0),                  # partial (1 of 4)
        (3, 0, 3.0, 12.9, 77.5),                       # partial (0 of 4)
        {"drone_id": 4, "seq": 0, "t": 4.0, "lat": 12.9, "lon": 77.5,
         "values": [1.0, 2.0]},                        # partial dict
    ])
    assert c["accepted"] == 4 and c["partial"] == 3
    assert c["dropped"] == 2 and c["dropped_malformed"] == 2
    with pytest.raises(ValueError, match="n_values"):
        pair.t.submit([(0, 1, 1.0, 12.9, 77.5, 1, 2, 3, 4, 5)])
    with pytest.raises(ValueError, match="n_values"):
        pair.t.submit_arrays([0], [1], [1.0], [12.9], [77.5], np.ones((1, 5)))
    pair.flush(drain=True)
    pair.check()


def test_backpressure_bounds_pending():
    pair = PipePair(pipe_kw=dict(max_pending=10))
    d = np.zeros(25, np.int64)
    s = np.arange(25)
    c = pair.submit_arrays(d, s, s * 1.0, d + 12.9, d + 77.5)
    assert c["accepted"] == 10 and pair.t.pending == 10
    assert c["dropped_backpressure"] == 15
    pair.flush(drain=True)
    c = pair.submit_arrays(d[:5], s[:5] + 100, s[:5] + 100.0, d[:5] + 12.9,
                           d[:5] + 77.5)
    assert c["accepted"] == 15 and pair.t.pending == 5
    rec = pair.t.reconcile()
    assert rec["accepted"] == rec["flushed_records"] + rec["pending"]
    pair.check()


def test_batch_shards_default_and_bound():
    """The default device batch is the largest power of two (at most 256)
    whose shards fit a ring; a batch that could wrap a ring raises as the
    reference's does."""
    for cap, r in ((2048, 4), (1 << 18, 60), (256, 8)):
        kw = dict(CFG_KW, tuple_capacity=cap, records_per_shard=r)
        pipe = IngestPipeline(AerialDB.open(tds.StoreConfig(**kw), device="cpu"))
        ref = JaxPipeline(JaxDB.open(jds.StoreConfig(**kw)))
        assert pipe.batch_shards == ref.batch_shards
    with pytest.raises(ValueError, match="tuple_capacity"):
        IngestPipeline(AerialDB.open(tds.StoreConfig(**CFG_KW), device="cpu"),
                       batch_shards=1024)


@given(st.integers(0, 4096), st.integers(1, 256))
@settings(deadline=None, max_examples=50)
def test_plan_chunks_partition_property(n, b_max):
    sizes = plan_chunks(n, b_max)
    assert sizes == j_plan_chunks(n, b_max)
    assert sum(sizes) == n
    assert all(s == b_max or (s & (s - 1)) == 0 for s in sizes)
    tail = [s for s in sizes if s != b_max]
    assert len(tail) == len(set(tail))


def test_group_shards_sid_continuity():
    """sid_lo keeps counting across flushes per drone, groups follow seq
    order, and every batch equals the reference's."""
    seqs = ({}, {})
    rows = np.arange(24, dtype=np.float32).reshape(8, 3)
    d = np.array([0, 0, 0, 0, 1, 1, 1, 1])
    s = np.array([3, 2, 1, 0, 0, 1, 2, 3])
    for shift in (0, 4):
        got = group_shards(d, s + shift, rows, 4, seqs[0], drain=False)
        want = j_group_shards(d, s + shift, rows, 4, seqs[1], drain=False)
        assert list(got[0]) == list(want[0]) == [4]
        for g, w in zip(got[0][4][1], want[0][4][1]):
            np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(got[0][4][0], want[0][4][0])
        np.testing.assert_array_equal(got[0][4][1].sid_lo, [shift // 4] * 2)
        np.testing.assert_array_equal(got[0][4][1].sid_hi, [0, 1])
        assert got[1].size == 0
    assert seqs[0] == seqs[1]


def test_group_shards_drain_batches_tails_by_size():
    """Draining emits each drone's trailing partial group in a batch of its
    size, as the reference does; without draining the tails stay left."""
    rng = np.random.default_rng(3)
    d = np.repeat(np.arange(5), [9, 6, 3, 4, 7])
    s = np.concatenate([rng.permutation(k) for k in (9, 6, 3, 4, 7)])
    rows = rng.normal(size=(d.size, 7)).astype(np.float32)
    for drain in (False, True):
        got = group_shards(d, s, rows, 4, {}, drain)
        want = j_group_shards(d, s, rows, 4, {}, drain)
        assert sorted(got[0]) == sorted(want[0])
        for k in got[0]:
            for g, w in zip(got[0][k], want[0][k]):
                if isinstance(g, tuple):
                    for gf, wf in zip(g, w):
                        np.testing.assert_array_equal(gf, np.asarray(wf))
                else:
                    np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[1], want[1])


def test_query_latest_builder_surface():
    """``Query().latest()`` is terminal and goes through ``AerialDB.query``."""
    db = AerialDB.open(tds.StoreConfig(**CFG_KW), seed=0, device="cpu")
    p, m = DroneFleet(6, records_per_shard=R, seed=5).next_shards()
    db.insert(p, m)
    via_query = db.query(Query().latest())
    direct = db.latest()
    for f in direct._fields:
        assert torch.equal(getattr(via_query, f), getattr(direct, f))
    with pytest.raises(ValueError, match="latest"):
        Query().latest().time(0, 1)
    with pytest.raises(ValueError, match="latest"):
        Query().latest().agg("mean", channel=1)
    with pytest.raises(ValueError, match="latest"):
        Query().time(0, 1).latest()
    with pytest.raises(ValueError, match="latest"):
        Query().latest() & Query().time(0, 1)
    with pytest.raises(ValueError, match="QueryPred"):
        Query().latest().build("cpu")


# ---------------------------------------------------------------------------
# epoch-aware retention on a reclaimed-then-refilled ring
# ---------------------------------------------------------------------------


def test_retention_watermark_survives_ring_reclamation():
    """After repair's ring reclamation rewinds ``tup_count`` below capacity,
    the next sweep's watermark on that edge is finite and equals the oldest
    retained timestamp, and an aged entry planted there retires — on both
    packages, bitwise."""
    cap = 128
    pair = Pair(replication=1, tuple_capacity=cap, retention_every=1,
                max_drones=D_MAX)
    fleet = DroneFleet(12, records_per_shard=8, seed=17)
    pair.ingest(fleet, 1)
    pair.both("fail_device", 1)
    pair.ingest(fleet, 2)
    pair.both("recover_device", 1)
    assert pair.t.last_repair == pair.j.last_repair
    assert pair.t.last_repair["slots_reclaimed"] > 0
    pair.check()
    count = pair.t.state.tup_count.numpy()
    over = pair.t.state.tup_overwritten.numpy()
    reclaimed = np.nonzero((count > 0) & (count < cap) & (over > 0))[0]
    assert reclaimed.size, (count, over)

    # the wrap-during-outage corner: a valid entry whose data aged out
    e = int(reclaimed[0])
    slot = int(np.nonzero(pair.t.state.index.valid.numpy()[e])[0][0])
    jidx = pair.j.state.index
    jidx = jidx._replace(
        ent_f=jidx.ent_f.at[e, slot, 4].set(-1e9).at[e, slot, 5].set(-1e9),
        ent_i=jidx.ent_i.at[e, slot, 2].set(e).at[e, slot, 3].set(-1)
                        .at[e, slot, 4].set(-1))
    pair.j = JaxDB(pair.jcfg, pair.j.state._replace(index=jidx), pair.j.alive,
                   jax.random.key(1))
    tstate = tds.clone_state(pair.t.state)
    tstate.index.ent_f[e, slot, 4:6] = -1e9
    tstate.index.ent_i[e, slot, 2:5] = torch.tensor([e, -1, -1], dtype=torch.int32)
    pair.t = AerialDB(pair.tcfg, tstate, pair.t.alive, device="cpu",
                      key=convert.key_from_numpy(
                          jax.random.key_data(jax.random.key(1))))
    p, m = fleet.next_shards()
    jinfo, info = pair.both("insert", p, m)
    wm = info["retention_watermark"].numpy()
    np.testing.assert_array_equal(_bits(wm), _bits(jinfo["retention_watermark"]))
    _assert_states_identical(pair.t.state, pair.j.state)
    count2 = pair.t.state.tup_count.numpy()
    still_rewound = reclaimed[count2[reclaimed] <= cap]
    assert still_rewound.size
    assert np.isfinite(wm[still_rewound]).all(), wm
    tup_f = pair.t.state.tup_f.numpy()
    for ee in still_rewound:
        w = min(int(count2[ee]), cap)
        assert wm[ee] == tup_f[ee, 0, :w].min(), ee
    valid_e = pair.t.state.index.valid.numpy()[e]
    t1_e = pair.t.state.index.ent_f.numpy()[e, :, 5]
    assert not np.any(valid_e & (t1_e == -1e9))
    assert int(info["index_entries_retired"].numpy()[e]) >= 1


# ---------------------------------------------------------------------------
# the flush scheduler and the post-flush fan-out
# ---------------------------------------------------------------------------


def _full_shards(n_drones=4, step=0):
    n = n_drones * R
    drone = np.repeat(np.arange(n_drones, dtype=np.int64), R)
    seq = np.tile(np.arange(R, dtype=np.int64), n_drones) + step * R
    return (drone, seq, seq.astype(np.float64), np.full(n, 12.95),
            np.full(n, 77.55))


def test_maybe_flush_deadline_scheduler():
    """maybe_flush fires iff the clock passes the armed deadline, re-arms
    an interval ahead and stamps deadline/late_s, as the reference."""
    pair = PipePair(pipe_kw=dict(flush_interval_s=5.0))
    pair.submit_arrays(*_full_shards())
    for pipe in (pair.t, pair.j):
        assert pipe.maybe_flush(now=100.0) is None
        assert pipe.maybe_flush(now=104.9) is None
    out = pair.t.maybe_flush(now=106.0)
    _assert_summaries_equal(out, pair.j.maybe_flush(now=106.0))
    assert out["flushed_records"] == 4 * R
    assert out["deadline"] == 105.0
    assert out["late_s"] == pytest.approx(1.0)
    assert pair.t.last_flush is out
    assert pair.t.maybe_flush(now=110.9) is None
    assert pair.j.maybe_flush(now=110.9) is None
    pair.submit_arrays(*_full_shards(step=1))
    out = pair.t.maybe_flush(now=111.0)
    _assert_summaries_equal(out, pair.j.maybe_flush(now=111.0))
    assert out["flushed_records"] == 4 * R
    assert out["late_s"] == pytest.approx(0.0)
    pair.check()
    with pytest.raises(ValueError, match="flush interval"):
        IngestPipeline(pair.t.db).maybe_flush(now=0.0)


def test_on_flush_fanout_is_error_isolated():
    """on_flush fires once a record-shipping flush; a raising subscriber is
    counted, never propagated."""
    seen = []

    def cb(summary):
        seen.append(summary["flushed_records"])
        raise RuntimeError("subscriber exploded")

    pipe = IngestPipeline(AerialDB.open(tds.StoreConfig(**CFG_KW), seed=0,
                                        device="cpu"), on_flush=cb)
    pipe.submit_arrays(*_full_shards())
    out = pipe.flush()
    assert out["flushed_records"] == 4 * R
    assert seen == [4 * R]
    assert pipe.counters["on_flush_errors"] == 1
    pipe.flush()
    assert seen == [4 * R]
    assert pipe.reconcile()["ok"]


# ---------------------------------------------------------------------------
# faults: retries, give-ups, a crash replayed from the journal
# ---------------------------------------------------------------------------


def _seeded_faults(seed, p, error):
    rng = np.random.default_rng(seed)

    def hook(pipe, attempt):
        if rng.random() < p:
            raise error("injected")
    return hook


@pytest.mark.parametrize("max_retries", [0, 2])
def test_transient_faults_retry_or_return_to_pending(max_retries):
    """Seeded transient faults on half the dispatch attempts: both packages
    retry, give up and return the same chunks to pending, so counters,
    summaries and states stay equal, and a fault-free drain reconciles."""
    pair = PipePair(pipe_kw=dict(max_retries=max_retries,
                                 sleep=lambda s: None, batch_shards=4))
    pair.t.fault_hook = _seeded_faults(5, 0.5, TransientDispatchError)
    pair.j.fault_hook = _seeded_faults(5, 0.5, JaxTransient)
    stream, clean = _stream(21, n_drones=12, max_seq=24)
    d, s, rows = stream
    for part in np.array_split(np.arange(d.shape[0]), 3):
        pair.submit_arrays(d[part], s[part], rows[part, 0], rows[part, 1],
                           rows[part, 2], rows[part, 3:])
        pair.flush()
        assert pair.t.reconcile()["counters_ok"]
        pair.check()
    assert pair.t.counters["retries"] + pair.t.counters["gave_up"] > 0
    pair.t.fault_hook = pair.j.fault_hook = None
    pair.flush(drain=True)
    pair.check()
    assert pair.t.reconcile()["ok"]
    assert pair.total_count() == clean[0].shape[0]


def test_crash_mid_flush_recovers_from_journal(tmp_path):
    """A crash on a flush's second dispatch propagates and leaves the torn
    state; a fresh pipeline over a fresh session replays the journal and
    holds every accepted record once, as the reference's does."""
    stream, clean = _stream(33, n_drones=12, max_seq=24)
    pipes = {}
    for name, make, crash in (("port", IngestPipeline, PipelineCrash),
                              ("jax", JaxPipeline, JaxCrash)):
        path = tmp_path / f"{name}.bin"
        db = (AerialDB.open(tds.StoreConfig(**CFG_KW), seed=0, device="cpu")
              if name == "port" else JaxDB.open(jds.StoreConfig(**CFG_KW), seed=0))
        pipe = make(db, journal=path, batch_shards=2)

        def hook(p, attempt, calls=[0], crash=crash):
            calls[0] += 1
            if calls[0] == 2:
                raise crash("killed mid-flush")
        pipe.fault_hook = hook
        _submit_stream(pipe, stream, 2)
        with pytest.raises(crash):
            pipe.flush(drain=True)
        pipe.close()
        fresh = (AerialDB.open(tds.StoreConfig(**CFG_KW), seed=0, device="cpu")
                 if name == "port" else JaxDB.open(jds.StoreConfig(**CFG_KW), seed=0))
        pipes[name] = make(fresh, journal=path)
        rep = pipes[name].replay_journal()
        assert rep["accepted"] == clean[0].shape[0] and rep["already_seen"] == 0
        pipes[name].flush(drain=True)
        assert pipes[name].reconcile()["ok"]
    assert pipes["port"].counters == pipes["jax"].counters
    _assert_states_identical(pipes["port"].db.state, pipes["jax"].db.state)
    assert ((tmp_path / "port.bin").read_bytes()
            == (tmp_path / "jax.bin").read_bytes())


# ---------------------------------------------------------------------------
# the latest cache on both mesh layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", ["edge4", "fleet2x2"])
def test_latest_cache_identical_on_meshes(mesh_name):
    """The same pipeline traffic into the JAX package's mesh, the port's
    mesh of the same layout and the port's single store: every StoreState
    leaf (the replicated latest cache included) bitwise identical, the
    counters equal, and ``latest()`` equal to the oracle on every side."""
    jmesh, tmesh = mesh_pair(mesh_name)
    kw = dict(CFG_KW)
    stream, clean = _stream(23)
    pipes = [JaxPipeline(JaxDB.open(jds.StoreConfig(**kw), mesh=jmesh,
                                    seed=0)),
             IngestPipeline(AerialDB.open(tds.StoreConfig(**kw), tmesh,
                                          seed=0)),
             IngestPipeline(AerialDB.open(tds.StoreConfig(**kw), seed=0,
                                          device="cpu"))]
    for pipe in pipes:
        _submit_stream(pipe, stream, 2)
        pipe.flush(drain=True)
    for pipe in pipes[1:]:
        _assert_states_identical(pipe.db.state, pipes[0].db.state)
        assert pipe.counters == pipes[0].counters
        assert pipe.reconcile() == pipes[0].reconcile()
    o_rec, o_val = latest_oracle(clean[0], clean[2][:, 0], clean[2], D_MAX)
    for pipe in pipes:
        got = pipe.db.latest()
        np.testing.assert_array_equal(np.asarray(got.valid), o_val)
        np.testing.assert_array_equal(_bits(got.record), _bits(o_rec))


# ---------------------------------------------------------------------------
# the package boundary
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_the_reference():
    """``repro_torch.ingest``, the session, ``repro_torch.chaos``, the
    federated runtime, the two-process smoke, every example under
    ``repro_torch.examples``, the static-analysis package
    ``repro_torch.analysis`` (its three layers), the Mamba1 blocks
    ``repro_torch.models.mamba`` and falcon-mamba-7b's config, imported in
    a fresh interpreter, bring in no module of JAX or of the JAX package."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "src")
    code = ("import sys; import repro_torch.ingest, repro_torch.api.session, "
            "repro_torch.chaos, repro_torch.distributed.federation, "
            "repro_torch.launch.mesh, repro_torch.launch.multihost_smoke, "
            "repro_torch.analysis.lint, repro_torch.analysis.retrace, "
            "repro_torch.analysis.collective_contract, "
            "repro_torch.models.mamba, repro_torch.configs.falcon_mamba_7b, "
            "pkgutil, importlib, repro_torch.examples; "
            "names = [m.name for m in pkgutil.iter_modules("
            "repro_torch.examples.__path__)]; "
            "assert {'quickstart', 'query_api_tour', 'disaster_analytics', "
            "'federated_quickstart', 'streaming_ingest_demo', 'serve_lm', "
            "'train_lm'} <= set(names), names; "
            "[importlib.import_module('repro_torch.examples.' + n) for n in names]; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(repr(bad))")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout
