"""The first port slice as a whole: the single-device store round trip of
``repro_torch`` held against the JAX package on one multi-round stream
(8 edges, 12 drones, 60-sample shards, capacity 4096: every ring wraps and
retention sweeps retire index entries).

Policy: every StoreState / IndexState leaf and every insert-info entry
bitwise; count, vmin, vmax, overflow and every QueryInfo field bitwise;
vsum and vmean to rtol 1e-5 (reduction order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import AerialDB as JaxDB
from repro.api import Query as JQuery
from repro.core import datastore as jds
from repro.distributed.federation import ingest_rounds as j_ingest_rounds
from repro_torch import convert
from repro_torch.api.query import Query as TQuery
from repro_torch.api.session import AerialDB
from repro_torch.core import datastore as tds
from repro_torch.data.synthetic import CityConfig, DroneFleet, make_sites

E, DRONES, R, ROUNDS, CAP = 8, 12, 60, 28, 4096
SITES = tuple(map(tuple, make_sites(E, CityConfig(), seed=3).tolist()))
CFG_KW = dict(n_edges=E, sites=SITES, tuple_capacity=CAP, index_capacity=96,
              max_shards_per_query=24, records_per_shard=R)
DEAD = (2, 5)


@pytest.fixture(scope="module")
def stream():
    fleet = DroneFleet(DRONES, records_per_shard=R, seed=1)
    return fleet.next_rounds(ROUNDS)


@pytest.fixture(scope="module")
def stores(stream):
    """The same stream through both packages: (jax state, jax info, port db,
    port info)."""
    payloads, metas = stream
    jcfg = jds.StoreConfig(**CFG_KW)
    jstate, jinfo = j_ingest_rounds(jcfg, jds.init_store(jcfg), payloads,
                                    metas, jnp.ones(E, bool))
    db = AerialDB.open(tds.StoreConfig(**CFG_KW), device="cpu")
    tinfo = db.ingest_rounds(payloads, metas)
    return jstate, jinfo, db, tinfo


def _leaves(state_np, prefix=""):
    for k, v in state_np.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


LEAVES = [name for name, _ in _leaves(convert.state_to_numpy(
    tds.init_store(tds.StoreConfig(**CFG_KW), device="cpu")))]


@pytest.mark.parametrize("leaf", LEAVES)
def test_state_leaf_bitwise(stores, leaf):
    jstate, _, db, _ = stores
    want = dict(_leaves(convert.state_to_numpy(
        convert.state_from_numpy(jstate, "cpu"))))[leaf]
    got = dict(_leaves(convert.state_to_numpy(db.state)))[leaf]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_stream_wraps_rings_and_retires_entries(stores):
    _, _, db, _ = stores
    st = db.state
    assert int(st.tup_count.min()) > CAP              # every ring wrapped
    assert int(st.tup_overwritten.sum()) > 0
    assert int(st.index.retired.sum()) > 0            # retention swept
    assert int(st.steps) == ROUNDS


def test_insert_info_bitwise(stores):
    _, jinfo, _, tinfo = stores
    assert set(jinfo) == set(tinfo)
    for k in jinfo:
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                      err_msg=k)


def test_insert_equals_ingest_rounds(stream, stores):
    payloads, metas = stream
    db = AerialDB.open(tds.StoreConfig(**CFG_KW), device="cpu")
    for i in range(ROUNDS):
        db.insert(payloads[i], type(metas)(*(f[i] for f in metas)))
    for (name, a), (_, b) in zip(_leaves(convert.state_to_numpy(db.state)),
                                 _leaves(convert.state_to_numpy(stores[2].state))):
        np.testing.assert_array_equal(a, b, err_msg=name)


def _workload(stream, kind, q=10, seed=0):
    """Queries around real shards of the retained tail (plus a few random
    ones), so most match: AND, OR, or shard-id predicates."""
    payloads, metas = stream
    rng = np.random.default_rng(seed)
    rnd = rng.integers(ROUNDS - 4, ROUNDS, q)
    drn = rng.integers(0, DRONES, q)
    pad = rng.uniform(0.0, 0.01, q).astype(np.float32)
    w = dict(lat0=metas.lat0[rnd, drn] - pad, lat1=metas.lat1[rnd, drn] + pad,
             lon0=metas.lon0[rnd, drn] - pad, lon1=metas.lon1[rnd, drn] + pad,
             t0=metas.t0[rnd, drn] - 200 * pad / 0.01,
             t1=metas.t1[rnd, drn] + 100.0)
    w = {k: v.astype(np.float32) for k, v in w.items()}
    w["lat0"][-2:] = rng.uniform(12.9, 13.0, 2).astype(np.float32)
    w["lat1"][-2:] = w["lat0"][-2:] + np.float32(0.05)
    if kind == "and":
        return dict(q=q, **w, has_spatial=True, has_temporal=True, is_and=True)
    if kind == "or":
        return dict(q=q, **w, has_spatial=True, has_temporal=True,
                    is_and=False)
    return dict(q=q, t0=w["t0"], t1=w["t1"], sid_hi=metas.sid_hi[rnd, drn],
                sid_lo=metas.sid_lo[rnd, drn], has_sid=True, has_temporal=True,
                is_and=True)


def _compare(jres, jinfo, tres, tinfo):
    for f in jds.QueryResult._fields:
        a, b = getattr(tres, f).numpy(), np.asarray(getattr(jres, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f in ("vsum", "vmean"):
            np.testing.assert_allclose(a, b, rtol=1e-5, equal_nan=True, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    for f in jds.QueryInfo._fields:
        np.testing.assert_array_equal(getattr(tinfo, f).numpy(),
                                      np.asarray(getattr(jinfo, f)), err_msg=f)


@pytest.mark.parametrize("channels", [(0,), (3, 1, 2)])
@pytest.mark.parametrize("kind", ["and", "or", "sid"])
@pytest.mark.parametrize("planner", ["min_shards", "min_edges"])
def test_query_matches_jax(stores, stream, planner, kind, channels):
    jstate, _, db, _ = stores
    w = _workload(stream, kind)
    alive = np.ones(E, bool)
    jcfg = jds.StoreConfig(**CFG_KW, planner=planner)
    jres, jinfo = jds._query(jcfg, jstate, jds.make_pred(**w), jnp.asarray(alive),
                             jax.random.key(0),
                             agg=jds.AggSpec(channels=channels))
    tdb = AerialDB(dataclasses.replace(db.cfg, planner=planner), db.state,
                   alive, device="cpu")
    tres, tinfo = tdb.query(tds.make_pred(**w, device="cpu"),
                            agg=tds.AggSpec(channels=channels))
    _compare(jres, jinfo, tres, tinfo)
    assert int(tres.count.sum()) > 0


@pytest.mark.parametrize("planner", ["min_shards", "min_edges"])
def test_query_with_dead_edges_matches_jax(stores, stream, planner):
    jstate, _, db, _ = stores
    w = _workload(stream, "and", seed=3)
    alive = np.ones(E, bool)
    alive[list(DEAD)] = False
    jcfg = jds.StoreConfig(**CFG_KW, planner=planner)
    jres, jinfo = jds._query(jcfg, jstate, jds.make_pred(**w), jnp.asarray(alive),
                             jax.random.key(0),
                             agg=jds.AggSpec(channels=(0, 2)))
    tdb = AerialDB(dataclasses.replace(db.cfg, planner=planner), db.state,
                   alive, device="cpu")
    tres, tinfo = tdb.query(tds.make_pred(**w, device="cpu"),
                            agg=tds.AggSpec(channels=(0, 2)))
    _compare(jres, jinfo, tres, tinfo)
    assert int(tinfo.replicas_lost.sum()) > 0


def test_ingest_with_dead_edges_matches_jax(stream):
    payloads, metas = stream
    alive = np.ones(E, bool)
    alive[list(DEAD)] = False
    jcfg = jds.StoreConfig(**CFG_KW)
    jstate, _ = j_ingest_rounds(jcfg, jds.init_store(jcfg), payloads[:6],
                                type(metas)(*(f[:6] for f in metas)),
                                jnp.asarray(alive))
    db = AerialDB(tds.StoreConfig(**CFG_KW),
                  tds.init_store(tds.StoreConfig(**CFG_KW), device="cpu"),
                  alive, device="cpu")
    db.ingest_rounds(payloads[:6], type(metas)(*(f[:6] for f in metas)))
    for (name, a), (_, b) in zip(
            _leaves(convert.state_to_numpy(db.state)),
            _leaves(convert.state_to_numpy(convert.state_from_numpy(jstate, "cpu")))):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(db.state.tup_count[list(DEAD)].sum()) == 0


def test_adopted_jax_state_answers_like_jax(stores, stream):
    """A JAX-built store carried over through convert answers queries the
    way the JAX package does."""
    jstate, _, _, _ = stores
    w = _workload(stream, "or", seed=5)
    jcfg = jds.StoreConfig(**CFG_KW)
    jres, jinfo = jds._query(jcfg, jstate, jds.make_pred(**w), jnp.ones(E, bool),
                             jax.random.key(0), agg=jds.AggSpec(channel=1))
    db = AerialDB(tds.StoreConfig(**CFG_KW),
                  convert.state_from_numpy(jstate, "cpu"), device="cpu")
    assert db._steps == ROUNDS
    tres, tinfo = db.query(tds.make_pred(**w, device="cpu"),
                           agg=tds.AggSpec(channel=1))
    _compare(jres, jinfo, tres, tinfo)


def test_query_builder_batch_matches_jax_facade(stores):
    jstate, _, db, _ = stores
    jdb = JaxDB(jds.StoreConfig(**CFG_KW), jstate, jnp.ones(E, bool),
                jax.random.key(0))
    t_end = float(db.state.tup_f[:, 0].max())
    specs = [(12.9, 13.05, 77.5, 77.7, t_end - 900, t_end), (0, 0, 0, 0, 0, 0)]

    def build(Q, s):
        q = Q().bbox(*s[:4]).time(*s[4:]) if s[0] else Q().shard(3, ROUNDS - 1)
        return q.agg("mean", "count", channel=2)
    jres, jinfo = jdb.query(JQuery.batch(*(build(JQuery, s) for s in specs)))
    tres, tinfo = db.query(TQuery.batch(*(build(TQuery, s) for s in specs),
                                        device="cpu"))
    _compare(jres, jinfo, tres, tinfo)
    assert set(tres.view(tds.AggSpec(channel=2, ops=("mean", "count")))) == {
        "mean", "count", "completeness_bound", "replicas_lost"}


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tds.StoreConfig(**CFG_KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AerialDB.open(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tds.make_pred(q=1, t0=0.0, t1=1.0, has_temporal=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TQuery().time(0, 1).build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.state_from_numpy(
            convert.state_to_numpy(tds.init_store(cfg, device="cpu")))


def test_validation_matches_reference():
    with pytest.raises(ValueError, match="inverted t range"):
        tds.make_pred(q=2, t0=[0.0, 5.0], t1=[1.0, 4.0], has_temporal=True,
                      device="cpu")
    tds.make_pred(q=1, t0=5.0, t1=4.0, has_temporal=True, is_and=False,
                  device="cpu")                  # OR clauses are exempt
    for kw, msg in ((dict(replication=4), "replication"),
                    (dict(retention_every=0), "retention_every"),
                    (dict(max_drones=-1), "max_drones"),
                    (dict(n_failure_domains=3), "n_failure_domains"),
                    (dict(sites=SITES[:3]), "sites")):
        with pytest.raises(ValueError, match=msg):
            tds.StoreConfig(**{**CFG_KW, **kw})
    with pytest.raises(ValueError, match="exceeding tuple_capacity"):
        tds.check_batch_fits(tds.StoreConfig(**CFG_KW), (100, 60))
    assert tds.StoreConfig(tuple_capacity=100).padded_capacity == 128
    with pytest.raises(ValueError, match="out of range"):
        tds.AggSpec(channel=4).validate_for(tds.StoreConfig(**CFG_KW))
    with pytest.raises(ValueError, match="inverted time"):
        TQuery().time(5, 4)


def test_unported_features_raise(stores):
    """The latest-per-drone cache, once unported, now holds the reference's
    contract: a disabled cache raises ValueError on both entry points, and
    a store with a cache opens."""
    with pytest.raises(ValueError, match="max_drones"):
        stores[2].latest()
    with pytest.raises(ValueError, match="max_drones"):
        stores[2].query(TQuery().latest())
    db = AerialDB.open(tds.StoreConfig(**CFG_KW, max_drones=4), device="cpu")
    assert db.latest().record.shape == (4, 3 + db.cfg.n_values)
    assert not bool(db.latest().valid.any())
