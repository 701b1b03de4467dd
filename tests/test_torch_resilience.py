"""Resilience of ``repro_torch`` under edge and failure-domain loss, held
against the JAX package: the port of ``tests/test_resilience.py``, case by
case (paper §3.5.3, Fig 14: with 3 replicas over three content dimensions,
any <= 2 edge failures leave every shard reachable, so queries stay exact;
3+ failures lose data gracefully; a recovered edge's lookup hole is
backfilled by repair).

Policy as ``tests/test_torch_repair.py`` (whose lockstep ``Pair`` of
sessions and bucketed reference placement this file reuses): leaves,
QueryResult count/min/max and QueryInfo bitwise, vsum/vmean to rtol 1e-5,
repair telemetry, ``ledger()`` and ``canonical_content`` equal. The
mesh case (``test_mesh_incompatible_failure_domains_rejected``) opens the
sessions on each package's 2-block edge mesh.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.api import AerialDB as JaxDB
from repro.chaos import audit as jaudit
from repro.core import datastore as jds
from repro.core import repair as jrepair
from repro_torch import convert
from repro_torch.api.session import AerialDB
from repro_torch.chaos import audit as taudit
from repro_torch.core import datastore as tds
from repro_torch.core import repair as trepair
from repro_torch.core.placement import ShardMeta
from repro_torch.data.synthetic import CityConfig, DroneFleet, make_sites
from repro_torch.launch.mesh import make_edge_mesh
from test_torch_repair import (Pair, _assert_query_equal,
                               _assert_states_identical,
                               bucketed_reference_placement)  # noqa: F401

E = 10
CATCH_ALL = dict(q=1, t0=0.0, t1=1e9, has_temporal=True, is_and=True)


def _tkey(k):
    return convert.key_from_numpy(jax.random.key_data(k))


def _build(planner="min_shards"):
    """The reference's module store in both packages: 3 rounds of 10 drones
    x 12 records on 10 edges, every edge alive. Returns (jax cfg, jax state,
    port cfg, port state, total tuples)."""
    sites = tuple(map(tuple, make_sites(E, CityConfig(), seed=3).tolist()))
    kw = dict(n_edges=E, sites=sites, tuple_capacity=4096, index_capacity=1024,
              max_shards_per_query=64, records_per_shard=12, planner=planner)
    jdb = JaxDB.open(jds.StoreConfig(**kw))
    tdb = AerialDB.open(tds.StoreConfig(**kw), device="cpu")
    fleet = DroneFleet(10, records_per_shard=12)
    total = 0
    for _ in range(3):
        payload, meta = fleet.next_shards()
        jdb.insert(payload, meta)
        tdb.insert(payload, meta)
        total += payload.shape[0] * payload.shape[1]
    _assert_states_identical(tdb.state, jdb.state)
    return jdb.cfg, jdb.state, tdb.cfg, tdb.state, total


JCFG, JSTATE, TCFG, TSTATE, TOTAL = _build()


def _query_both(dead, w, seed=0, jcfg=JCFG, tcfg=TCFG):
    """One query under the alive mask with ``dead`` edges down, through both
    packages' single-device query; returns the port's (result, info)."""
    alive = np.ones(E, bool)
    alive[list(dead)] = False
    jres, jinfo = jds._query(jcfg, JSTATE, jds.make_pred(**w),
                             jnp.asarray(alive), jax.random.key(seed))
    tres, tinfo = tds.run_query(tcfg, TSTATE, tds.make_pred(**w, device="cpu"),
                                torch.from_numpy(alive),
                                key=_tkey(jax.random.key(seed)))
    _assert_query_equal(tres, tinfo, jres, jinfo)
    return tres, tinfo


@given(st.sets(st.integers(0, E - 1), min_size=0, max_size=2))
@settings(deadline=None, max_examples=30)
def test_exact_results_up_to_two_failures(dead):
    res, _ = _query_both(dead, CATCH_ALL)
    assert int(res.count[0]) == TOTAL


@given(st.sets(st.integers(0, E - 1), min_size=3, max_size=4),
       st.integers(0, 1 << 30))
@settings(deadline=None, max_examples=20)
def test_graceful_degradation_three_plus_failures(dead, seed):
    res, _ = _query_both(dead, CATCH_ALL, seed)
    got = int(res.count[0])
    assert 0.5 * TOTAL <= got <= TOTAL


def test_query_during_partial_failure_spatial():
    w = dict(q=1, lat0=12.85, lat1=13.10, lon0=77.45, lon1=77.75, t0=0.0,
             t1=1e9, has_spatial=True, has_temporal=True)
    res, _ = _query_both([1, 4], w, 1)
    assert int(res.count[0]) == TOTAL


@pytest.mark.parametrize("planner", ["random", "min_edges", "min_shards"])
def test_all_planners_resilient(planner):
    """Every planner over the module store with edges 0 and 9 down, by an
    explicit key; then a session of that planner adopting the store fails
    them, queries with its own keys, recovers (an incremental repair) and
    queries again: the answers, QueryInfo and the session keys stay the
    reference's (fail, recover and repair take no split)."""
    jcfg = dataclasses.replace(JCFG, planner=planner)
    tcfg = dataclasses.replace(TCFG, planner=planner)
    res, _ = _query_both([0, 9], dict(CATCH_ALL, is_and=True), 2, jcfg, tcfg)
    assert int(res.count[0]) == TOTAL, planner
    jdb = JaxDB(jcfg, JSTATE, jnp.ones(E, bool), jax.random.key(5))
    tdb = AerialDB(tcfg, tds.clone_state(TSTATE), key=_tkey(jax.random.key(5)),
                   device="cpu")
    for db in (jdb, tdb):
        db.fail_edges(0, 9)
    w = dict(q=3, t0=[0.0, 0.0, 300.0], t1=[1e9, 600.0, 900.0],
             has_temporal=True, is_and=True)
    for step in range(2):
        jres, jinfo = jdb.query(jds.make_pred(**w))
        tres, tinfo = tdb.query(tds.make_pred(**w, device="cpu"))
        _assert_query_equal(tres, tinfo, jres, jinfo)
        assert int(tres.count[0]) == TOTAL
        np.testing.assert_array_equal(convert.key_to_numpy(tdb._key),
                                      np.asarray(jax.random.key_data(jdb._key)))
        for db in (jdb, tdb):
            db.recover_edges(0, 9)
        assert tdb.last_repair == jdb.last_repair
        assert tdb.ledger() == jdb.ledger()


def test_assignment_avoids_dead_edges():
    _, info = _query_both([2, 5], dict(CATCH_ALL, is_and=True), 3)
    assert int(info.subquery_edges.numpy()[0]) <= E - 2


# ---------------------------------------------------------------------------
# the facade: device failures, degraded accounting, recovery re-replication
# ---------------------------------------------------------------------------

FACADE_KW = dict(
    sites=tuple(map(tuple, make_sites(8, CityConfig(), seed=3).tolist())),
    n_edges=8, tuple_capacity=2048, index_capacity=512,
    max_shards_per_query=64, records_per_shard=12, retention_every=4,
    n_failure_domains=1)


def _facade(**overrides) -> Pair:
    return Pair(**dict(FACADE_KW, **overrides))


def _query_pair(pair, w, seed):
    jres, jinfo = pair.j.query(jds.make_pred(**w), key=jax.random.key(seed))
    tres, tinfo = pair.t.query(tds.make_pred(**w, device="cpu"),
                               key=_tkey(jax.random.key(seed)))
    _assert_query_equal(tres, tinfo, jres, jinfo)
    return tres, tinfo


def _wide_shard(seed=24, sid=(77, 9)):
    """One wide shard spanning many slice cells and buckets, so its index
    entry lands on slice-owner edges beyond its 3 replicas."""
    rng = np.random.default_rng(seed)
    r = 12
    t = np.linspace(0.0, 1100.0, r, dtype=np.float32)
    lat = np.linspace(12.90, 13.00, r, dtype=np.float32)
    lon = np.linspace(77.50, 77.62, r, dtype=np.float32)
    vals = rng.normal(size=(r, 4)).astype(np.float32)
    payload = np.concatenate([t[:, None], lat[:, None], lon[:, None], vals],
                             axis=1)[None]
    meta = ShardMeta(
        sid_hi=np.asarray([sid[0]], np.int32),
        sid_lo=np.asarray([sid[1]], np.int32),
        lat0=lat.min(keepdims=True), lat1=lat.max(keepdims=True),
        lon0=lon.min(keepdims=True), lon1=lon.max(keepdims=True),
        t0=t.min(keepdims=True), t1=t.max(keepdims=True))
    return payload, meta


def test_mass_failure_one_alive_edge_keeps_every_tuple():
    pair = _facade()
    pair.both("fail_edges", list(range(1, 8)))
    p, m = DroneFleet(5, records_per_shard=12, seed=21).next_shards()
    jinfo, tinfo = pair.both("insert", p, m)
    reps = tinfo["replicas"].numpy()
    np.testing.assert_array_equal(reps, np.asarray(jinfo["replicas"]))
    np.testing.assert_array_equal(reps, np.broadcast_to([0, -1, -1], reps.shape))
    res, qi = _query_pair(pair, CATCH_ALL, 0)
    assert int(res.count[0]) == 5 * 12
    assert float(qi.completeness_bound[0]) == 1.0
    pair.check()


def test_mass_failure_zero_alive_edges_explicit_drop():
    pair = _facade()
    pair.both("fail_edges", list(range(8)))
    p, m = DroneFleet(3, records_per_shard=12, seed=22).next_shards()
    _, tinfo = pair.both("insert", p, m)
    assert (tinfo["replicas"].numpy() == -1).all()
    assert int(tinfo["intake_per_edge"].sum()) == 0
    res, _ = _query_pair(pair, CATCH_ALL, 0)
    assert int(res.count[0]) == 0
    pair.check()
    pair.both("recover_edges", list(range(8)))
    assert pair.t.last_repair == pair.j.last_repair
    pair.check()


def test_membership_ids_validated_eagerly():
    """Out-of-range, negative, duplicate and empty ids raise on the host
    before the mask changes (on the card an out-of-range index would be a
    device-side assert)."""
    db = AerialDB.open(tds.StoreConfig(**FACADE_KW), device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        db.fail_edges(8)
    with pytest.raises(ValueError, match="out of range"):
        db.fail_edges([0, 1000])
    with pytest.raises(ValueError, match="out of range"):
        db.recover_edges(-1)
    with pytest.raises(ValueError, match="duplicate"):
        db.fail_edges(3, 3)
    with pytest.raises(ValueError, match="no edge ids"):
        db.fail_edges([])
    assert bool(db.alive.all()) and db.ledger()["open_outages"] == []
    db.fail_edges(7).recover_edges(7)
    db.fail_edges(np.array([6, 2]))
    assert db.alive.numpy().tolist() == [i not in (2, 6) for i in range(8)]


def test_device_failure_requires_domains():
    db = AerialDB.open(tds.StoreConfig(**FACADE_KW), device="cpu")
    with pytest.raises(ValueError, match="failure domains"):
        db.fail_device(0)
    db4 = AerialDB.open(tds.StoreConfig(**dict(FACADE_KW, n_failure_domains=4)),
                        device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        db4.fail_device(4)
    db4.fail_device(3)
    assert db4.ledger()["open_outages"] == [([6, 7], 0)]


def test_mesh_incompatible_failure_domains_rejected():
    """Failure domains finer than the mesh's device blocks void the
    whole-device durability guarantee: both packages' sessions refuse them
    with the same message; one domain a block, or none, is accepted."""
    from repro.launch.mesh import make_edge_mesh as j_make_edge_mesh
    if jax.device_count() < 2:
        pytest.skip("needs >= 2 host devices")
    msgs = []
    for db_cls, cfg_cls, mesh in (
            (JaxDB, jds.StoreConfig, j_make_edge_mesh(2)),
            (AerialDB, tds.StoreConfig, make_edge_mesh(2, device="cpu"))):
        with pytest.raises(ValueError, match="n_failure_domains") as err:
            db_cls.open(cfg_cls(**dict(FACADE_KW, n_failure_domains=4)),
                        mesh=mesh)
        msgs.append(str(err.value))
        db_cls.open(cfg_cls(**dict(FACADE_KW, n_failure_domains=2)), mesh=mesh)
        db_cls.open(cfg_cls(**FACADE_KW), mesh=mesh)
    assert msgs[0] == msgs[1]


def test_device_failure_completeness_exact():
    """One whole failure domain down under failure-domain placement: the
    catch-all query stays exactly complete and reports the lost replica
    slots, for every domain, on both packages."""
    pair = _facade(n_failure_domains=4)
    payloads, metas = DroneFleet(10, records_per_shard=12, seed=23).next_rounds(4)
    pair.both("ingest_rounds", payloads, metas)
    total = int(np.prod(payloads.shape[:3]))
    for device in range(4):
        pair.both("fail_device", device)
        assert int(pair.t.alive.sum()) == 6
        res, info = _query_pair(pair, CATCH_ALL, device)
        assert int(res.count[0]) == total, f"device {device}"
        assert float(info.completeness_bound[0]) == 1.0
        assert int(info.replicas_lost[0]) > 0
        pair.both("recover_device", device, repair=False)
        assert bool(pair.t.alive.all())
    pair.check()


def test_degraded_accounting_unreachable_shard():
    pair = _facade()
    payload, meta = _wide_shard()
    _, info = pair.both("insert", payload, meta)
    reps = info["replicas"].numpy()
    holders = set(np.nonzero(info["index_writes_per_edge"].numpy() > 0)[0].tolist())
    assert holders - {int(r) for r in reps[0]}, (holders, reps)
    pair.both("fail_edges", sorted({int(r) for r in reps[0]}))
    res, qi = _query_pair(pair, dict(q=1, sid_hi=77, sid_lo=9, has_sid=True), 1)
    assert int(res.count[0]) == 0
    assert int(qi.shards_matched[0]) == 1
    assert float(qi.completeness_bound[0]) == 0.0
    assert int(qi.replicas_lost[0]) == 3


def _outage_lifecycle(repair):
    """Ingest, lose a domain, keep ingesting, recover (with or without the
    repair), on both packages; returns (pair, the during-outage metas)."""
    pair = _facade(n_failure_domains=4)
    fleet = DroneFleet(10, records_per_shard=12, seed=25)
    pair.both("ingest_rounds", *fleet.next_rounds(2))
    pair.both("fail_device", 1)
    pay2, met2 = fleet.next_rounds(2)
    pair.both("ingest_rounds", pay2, met2)
    pair.both("recover_device", 1, repair=repair)
    return pair, met2


def _point_counts(pair, met2):
    hi = np.asarray(met2.sid_hi).reshape(-1)
    lo = np.asarray(met2.sid_lo).reshape(-1)
    res, _ = _query_pair(pair, dict(q=hi.size, sid_hi=hi, sid_lo=lo,
                                    has_sid=True), 2)
    return res.count.numpy()


def test_repair_backfills_recovered_edge_lookup_hole():
    """Shards ingested during an outage never wrote entries to the dead
    edges; after the repair every one of them point-queries exactly. The
    ``repair=False`` control shows the hole, and a deferred repair closes
    it."""
    pair, met2 = _outage_lifecycle(repair=True)
    rep = pair.t.last_repair
    assert rep == pair.j.last_repair
    assert rep["shards_replaced"] > 0 and rep["entries_backfilled"] > 0
    np.testing.assert_array_equal(_point_counts(pair, met2), 12)
    pair.check()
    ctl, met2 = _outage_lifecycle(repair=False)
    assert (_point_counts(ctl, met2) < 12).any()
    assert ctl.t.ledger()["closed_windows"] == [([2, 3], 2, 4)]
    assert ctl.t.ledger() == ctl.j.ledger()
    ctl.repair_against_full()
    np.testing.assert_array_equal(_point_counts(ctl, met2), 12)


def test_repair_never_launders_unrepairable_shards():
    pair = _facade()
    p, m = DroneFleet(6, records_per_shard=12, seed=26).next_shards()
    _, info = pair.both("insert", p, m)
    reps = sorted({int(r) for r in info["replicas"].numpy()[0]})
    other = next(e for e in range(8) if e not in reps)
    pair.both("fail_edges", reps + [other])
    pair.both("recover_edges", other)
    assert pair.t.last_repair == pair.j.last_repair
    assert pair.t.last_repair["shards_unrepairable"] > 0
    pair.check()
    w = dict(q=1, sid_hi=int(m.sid_hi[0]), sid_lo=int(m.sid_lo[0]), has_sid=True)
    res, qi = _query_pair(pair, w, 4)
    assert int(res.count[0]) == 0
    if int(qi.shards_matched[0]) == 1:
        assert float(qi.completeness_bound[0]) == 0.0
        assert int(qi.replicas_lost[0]) == 3
    pair.both("recover_edges", reps)
    pair.check()
    res, _ = _query_pair(pair, w, 5)
    assert int(res.count[0]) == 12


def test_repair_backfills_entries_for_unrepairable_shards():
    pair = _facade()
    pair.both("fail_edges", 0)
    payload, meta = _wide_shard(seed=28, sid=(55, 4))
    _, info = pair.both("insert", payload, meta)
    holders = sorted(np.nonzero(info["index_writes_per_edge"].numpy() > 0)[0].tolist())
    assert 0 not in holders
    pair.both("fail_edges", holders)
    pair.both("recover_edges", 0)
    assert pair.t.last_repair == pair.j.last_repair
    assert pair.t.last_repair["shards_unrepairable"] > 0
    pair.check()
    ent_i = pair.t.state.index.ent_i.numpy()
    on0 = (pair.t.state.index.valid.numpy()[0]
           & (ent_i[0, :, 0] == 55) & (ent_i[0, :, 1] == 4))
    assert on0.any()
    reps = ent_i[0][on0][0, 2:5]
    assert not pair.t.alive.numpy()[reps[reps >= 0]].any()
    res, qi = _query_pair(pair, dict(q=1, sid_hi=55, sid_lo=4, has_sid=True), 7)
    assert int(res.count[0]) == 0
    assert int(qi.shards_matched[0]) == 1
    assert float(qi.completeness_bound[0]) == 0.0
    assert int(qi.replicas_lost[0]) == 3


def _wiped_pre_state(seed, n_wiped):
    """An insert's store on both packages with the lowest-id replica's copy of
    the first shard overwritten (all of it, or its first ``n_wiped`` slots),
    and an alive mask with the second replica down. Returns (pair, jax
    state, port state, alive, (hi, lo))."""
    pair = _facade()
    p, m = DroneFleet(6, records_per_shard=12, seed=seed).next_shards()
    _, info = pair.both("insert", p, m)
    hi, lo = int(m.sid_hi[0]), int(m.sid_lo[0])
    reps = sorted({int(r) for r in info["replicas"].numpy()[0]})
    tup_sid = pair.t.state.tup_sid.numpy().copy()
    slots = ((tup_sid[reps[0], 0] == hi) & (tup_sid[reps[0], 1] == lo)).nonzero()[0]
    assert slots.size == 12
    tup_sid[reps[0], :, slots[:n_wiped]] = -2
    jstate = pair.j.state._replace(tup_sid=jnp.asarray(tup_sid))
    tstate = tds.clone_state(pair.t.state)._replace(
        tup_sid=torch.from_numpy(tup_sid))
    alive = np.ones(8, bool)
    alive[reps[1]] = False
    return pair, jstate, tstate, alive, (hi, lo)


def _repair_both(pair, jstate, tstate, alive):
    jnew, jinfo = jrepair.repair_state(pair.jcfg, jstate, jnp.asarray(alive))
    tnew, tinfo = trepair.repair_state(pair.tcfg, tstate, alive)
    assert tinfo == jinfo
    _assert_states_identical(tnew, jnew)
    return jnew, tnew, tinfo


def test_repair_skips_sources_that_lost_their_copy():
    pair, jstate, tstate, alive, (hi, lo) = _wiped_pre_state(27, 12)
    jnew, tnew, info = _repair_both(pair, jstate, tstate, alive)
    assert info["shards_unrepairable"] == 0 and info["tuples_copied"] >= 12
    db2 = AerialDB(pair.tcfg, tnew, alive, device="cpu")
    res, _ = db2.query(tds.make_pred(q=1, sid_hi=hi, sid_lo=lo, has_sid=True,
                                     device="cpu"), key=_tkey(jax.random.key(6)))
    assert int(res.count[0]) == 12


def test_repair_prefers_fullest_surviving_copy():
    """With the lowest-id survivor holding 6 of 12 tuples, the moved copy is
    sourced from the full one: random-planner queries over 8 keys see 12
    (or the remnant's 6), never 0, on both packages alike."""
    pair, jstate, tstate, alive, (hi, lo) = _wiped_pre_state(29, 6)
    jnew, tnew, _ = _repair_both(pair, jstate, tstate, alive)
    jdb2 = JaxDB(dataclasses.replace(pair.jcfg, planner="random"), jnew,
                 jnp.asarray(alive), jax.random.key(0))
    tdb2 = AerialDB(dataclasses.replace(pair.tcfg, planner="random"), tnew,
                    alive, device="cpu")
    w = dict(q=1, sid_hi=hi, sid_lo=lo, has_sid=True)
    counts = set()
    for k in range(8):
        jres, jinfo = jdb2.query(jds.make_pred(**w), key=jax.random.key(k))
        tres, tinfo = tdb2.query(tds.make_pred(**w, device="cpu"),
                                 key=_tkey(jax.random.key(k)))
        _assert_query_equal(tres, tinfo, jres, jinfo)
        counts.add(int(tres.count[0]))
    assert 12 in counts and 0 not in counts and counts <= {6, 12}, counts


def test_repair_matches_never_failed_store():
    """After recovery and repair, the catch-all and the outage-window
    queries equal a store that never failed, and the canonical content of
    both packages' faulted stores equals the never-failed twins'."""
    ok = _facade(n_failure_domains=4)
    pay, met = DroneFleet(10, records_per_shard=12, seed=25).next_rounds(4)
    ok.both("ingest_rounds", pay, met)
    pair, _ = _outage_lifecycle(repair=True)
    # no ring wrapped: the faulted store's only overwrites are the slots the
    # repair reclaimed
    assert int(ok.t.state.tup_overwritten.sum()) == 0
    assert int(pair.t.state.tup_overwritten.sum()) == \
        pair.t.last_repair["slots_reclaimed"] > 0
    t = np.asarray(pay)[2:, :, :, 0]
    for w in (CATCH_ALL, dict(q=1, t0=float(t.min()), t1=float(t.max()),
                              has_temporal=True, is_and=True)):
        r1, _ = _query_pair(ok, w, 3)
        r2, _ = _query_pair(pair, w, 3)
        np.testing.assert_array_equal(r1.count.numpy(), r2.count.numpy())
        np.testing.assert_allclose(r1.vsum.numpy(), r2.vsum.numpy(), rtol=1e-6)
    got = taudit.canonical_content(pair.t)
    want = jaudit.canonical_content(pair.j)
    taudit.assert_content_equal(got, want)
    assert got["index"] == want["index"]
    taudit.assert_content_equal(got, taudit.canonical_content(ok.t))
    jaudit.assert_content_equal(want, jaudit.canonical_content(ok.j))
