"""The latest-per-drone cache of ``repro_torch`` held against the JAX package:
``core.datastore._update_latest`` on seeded batches, the ``AerialDB``
sessions' ``latest()`` / ``Query().latest()`` after a stream with a crafted
round, the random planner's key sequence around latest queries, and the
host oracle and overlay of ``repro_torch.ingest.latest``.

Policy: every cache row, every StoreState leaf and every ``LatestResult``
field bitwise (NaN payloads included, compared as int32 words); plans and
``QueryInfo`` of random-planner queries bitwise away from top-2 gumbel gaps
under 1e-5, as ``tests/test_torch_planner_random.py`` holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import AerialDB as JaxDB
from repro.api import Query as JQuery
from repro.core import datastore as jds
from repro.core import index as ji
from repro.ingest import latest as jlatest
from repro_torch import convert
from repro_torch.api.query import Query
from repro_torch.api.session import AerialDB
from repro_torch.core import datastore as tds
from repro_torch.data.synthetic import (CityConfig, DroneFleet,
                                        latest_edge_round, make_sites)
from repro_torch.ingest import latest as tlatest

W = 7


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bitwise(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _batch(rng, b, r, d, ids=None, t=None, nan_channels=0.0):
    """(payload (b, r, W) float32, sid_hi (b,) int32): ids in [0, d) and t
    from a few integers (ties everywhere) unless given."""
    p = rng.standard_normal((b, r, W)).astype(np.float32)
    p[..., 0] = rng.integers(0, 4, (b, r)) if t is None else t(rng, (b, r))
    if nan_channels:
        p[..., 3:][rng.random((b, r, W - 3)) < nan_channels] = np.nan
    ids = rng.integers(0, d, b) if ids is None else ids(rng, b)
    return p, ids.astype(np.int32)


SPECIAL_T = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, -1.0],
                     np.float32)


def _case(name, rng):
    """(D, [(payload, sid_hi), ...] in insert order)."""
    if name == "dup_ties":
        return 4, [_batch(rng, 8, 5, 4, ids=lambda g, b: g.integers(0, 2, b))]
    if name == "cache_ties":
        first = _batch(rng, 6, 4, 3)
        again = first[0].copy()
        again[..., 3:] = rng.standard_normal(again[..., 3:].shape)
        return 3, [first, (again, first[1][::-1].copy()), first]
    if name == "special_t":
        pick = (lambda g, s: g.choice(SPECIAL_T, s))
        return 4, [_batch(rng, 8, 6, 4, t=pick) for _ in range(3)]
    if name == "ids_out":
        ids = (lambda g, b: g.integers(-3, 8, b))
        return 5, [_batch(rng, 10, 3, 5, ids=ids) for _ in range(3)]
    if name == "nan_channels":
        return 4, [_batch(rng, 6, 5, 4, nan_channels=0.4) for _ in range(2)]
    if name == "d1":
        ids = (lambda g, b: g.integers(-1, 3, b))
        return 1, [_batch(rng, 5, 4, 1, ids=ids) for _ in range(3)]
    if name == "none_in_range":
        ids = (lambda g, b: g.choice(np.array([-2, -1, 4, 9]), b))
        return 4, [_batch(rng, 6, 3, 4), _batch(rng, 6, 3, 4, ids=ids)]
    if name == "rounds":
        pick = (lambda g, s: g.choice(SPECIAL_T, s) + g.integers(0, 3, s))
        ids = (lambda g, b: g.integers(-1, 7, b))
        return 6, [_batch(rng, 7, 4, 6, ids=ids, t=pick, nan_channels=0.2)
                   for _ in range(6)]
    raise ValueError(name)


CASES = ["dup_ties", "cache_ties", "special_t", "ids_out", "nan_channels",
         "d1", "none_in_range", "rounds"]


@pytest.mark.parametrize("name", CASES)
def test_update_latest_matches_jax(name):
    """Round after round, the port's in-place update equals the reference's
    ``_update_latest`` bitwise, and both equal the host oracle over every
    record so far."""
    d, rounds = _case(name, np.random.default_rng(CASES.index(name)))
    jf, js = jnp.zeros((d, W), jnp.float32), jnp.full((d,), -1, jnp.int32)
    tf, ts = torch.zeros((d, W)), torch.full((d,), -1, dtype=torch.int32)
    seen_rows, seen_ids = [], []
    for k, (p, ids) in enumerate(rounds):
        jf, js = jds._update_latest(jf, js, jnp.asarray(p), jnp.asarray(ids),
                                    jnp.int32(k + 1))
        out = tds._update_latest(tf, ts, torch.from_numpy(p),
                                 torch.from_numpy(ids), k + 1)
        assert out[0] is tf and out[1] is ts            # in place
        assert ts.dtype == torch.int32 and tf.dtype == torch.float32
        _assert_bitwise(tf.numpy(), jf, f"{name} round {k} record")
        _assert_bitwise(ts.numpy(), js, f"{name} round {k} last_seen")
        seen_rows.append(p.reshape(-1, W))
        seen_ids.append(np.repeat(ids, p.shape[1]))
        rows, dids = np.concatenate(seen_rows), np.concatenate(seen_ids)
        rec, valid = tlatest.latest_oracle(dids, rows[:, 0], rows, d)
        np.testing.assert_array_equal(valid, ts.numpy() >= 0)
        _assert_bitwise(tf.numpy()[valid], rec[valid], f"{name} vs oracle")


def test_update_latest_signed_zero_and_order():
    """-0.0 and +0.0 tie in both passes, so the later record wins whichever
    sign it carries; shuffling the batch's shard order moves the winner
    exactly as the flat-index rule says."""
    p = np.zeros((4, 2, W), np.float32)
    p[..., 1] = np.arange(8).reshape(4, 2)
    p[:, :, 0] = [[-0.0, 0.0], [0.0, -0.0], [-1.0, -0.0], [-2.0, -3.0]]
    ids = np.array([0, 0, 0, 1], np.int32)
    for perm in ([0, 1, 2, 3], [2, 1, 0, 3], [1, 2, 0, 3]):
        jf, js = jds._update_latest(jnp.zeros((2, W)), jnp.full((2,), -1, jnp.int32),
                                    jnp.asarray(p[perm]), jnp.asarray(ids[perm]),
                                    jnp.int32(3))
        tf, ts = torch.zeros((2, W)), torch.full((2,), -1, dtype=torch.int32)
        tds._update_latest(tf, ts, torch.from_numpy(p[perm]),
                           torch.from_numpy(ids[perm]), 3)
        _assert_bitwise(tf.numpy(), jf, str(perm))
        _assert_bitwise(ts.numpy(), js, str(perm))
        np.testing.assert_array_equal(ts.numpy(), [3, 3])


# -- sessions ----------------------------------------------------------------

E, DRONES, R, ROUNDS, D = 8, 12, 60, 6, 16
SITES = tuple(map(tuple, make_sites(E, CityConfig(), seed=3).tolist()))
CFG_KW = dict(n_edges=E, sites=SITES, tuple_capacity=4096, index_capacity=512,
              max_shards_per_query=128, records_per_shard=R)


def _crafted(fleet, db):
    """The fleet's next round reworked by ``latest_edge_round`` against the
    port session's cache."""
    lat = db.latest()
    cached_t = np.where(lat.valid.numpy(), lat.record[:, 0].numpy(), np.nan)
    payload, meta = fleet.next_shards()
    p, ids = latest_edge_round(payload, meta.sid_hi, cached_t, D, seed=3)
    return p, meta._replace(sid_hi=ids)


@pytest.fixture(scope="module")
def sessions():
    """The same stream into a cached store of each package: rounds, a
    crafted round, and two more rounds. Returns (jax db, port db, every
    (payload, sid_hi) inserted, both latest() answers right after the
    crafted round)."""
    fleet = DroneFleet(DRONES, records_per_shard=R, seed=5)
    jdb = JaxDB.open(jds.StoreConfig(**CFG_KW), max_drones=D)
    tdb = AerialDB.open(tds.StoreConfig(**CFG_KW), max_drones=D, device="cpu")
    inserted = []
    payloads, metas = fleet.next_rounds(ROUNDS)
    for db in (jdb, tdb):
        db.ingest_rounds(payloads, metas)
    inserted += list(zip(payloads, metas.sid_hi))
    p, meta = _crafted(fleet, tdb)
    for db in (jdb, tdb):
        db.insert(p, meta)
    inserted.append((p, meta.sid_hi))
    # copies: the JAX package donates its state to the next ingest
    crafted = (jds.LatestResult(*(np.array(f) for f in jdb.latest())),
               tds.LatestResult(*(f.clone() for f in tdb.latest())))
    payloads, metas = fleet.next_rounds(2)
    for db in (jdb, tdb):
        db.ingest_rounds(payloads, metas)
    inserted += list(zip(payloads, metas.sid_hi))
    return jdb, tdb, inserted, crafted


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


LEAVES = [name for name, _ in _leaves(convert.state_to_numpy(tds.init_store(
    tds.StoreConfig(**CFG_KW, max_drones=D), device="cpu")))]


@pytest.mark.parametrize("leaf", LEAVES)
def test_session_state_leaf_bitwise(sessions, leaf):
    jdb, tdb, *_ = sessions
    want = dict(_leaves(convert.state_to_numpy(
        convert.state_from_numpy(jdb.state, "cpu"))))[leaf]
    got = dict(_leaves(convert.state_to_numpy(tdb.state)))[leaf]
    _assert_bitwise(got, want, leaf)


def _oracle(inserted):
    rows = np.concatenate([p.reshape(-1, p.shape[-1]) for p, _ in inserted])
    ids = np.concatenate([np.repeat(i, R) for _, i in inserted])
    rec, valid, src = tlatest.latest_oracle_sorted(ids, rows[:, 0], rows, D)
    return rec, valid, np.where(valid, src // (DRONES * R) + 1, -1)


def _assert_latest(got, want, oracle):
    for f in tds.LatestResult._fields:
        _assert_bitwise(getattr(got, f).numpy(), getattr(want, f), f)
    rec, valid, last_seen = oracle
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    _assert_bitwise(got.record.numpy(), rec)
    np.testing.assert_array_equal(got.last_seen.numpy(), last_seen)


def test_session_latest_matches_jax_and_oracle(sessions):
    """``latest()`` and ``query(Query().latest())`` equal the reference's
    field by field, and the oracle over every inserted record, right after
    the crafted round and at the end of the stream."""
    jdb, tdb, inserted, (j_crafted, t_crafted) = sessions
    crafted_step = ROUNDS + 1
    oracle = _oracle(inserted[:crafted_step])
    _assert_latest(t_crafted, j_crafted, oracle)
    rec, valid, last_seen = oracle
    # the crafted round reached the cache: NaN channels, rows it wrote,
    # rows it left (drones whose records it excluded), rows never seen
    assert np.isnan(rec).any() and not valid[DRONES:].any()
    assert (last_seen == crafted_step).any() and (last_seen == ROUNDS).any()
    oracle = _oracle(inserted)
    _assert_latest(tdb.latest(), jdb.latest(), oracle)
    via_query = tdb.query(Query().latest())
    assert isinstance(via_query, tds.LatestResult)
    _assert_latest(via_query, jdb.query(JQuery().latest()), oracle)


def test_latest_disabled_and_agg_raise(sessions):
    """The reference's errors, on both packages: a disabled cache on both
    entry points, and an ``agg=`` beside a latest() query."""
    jdb, tdb, *_ = sessions
    jnone = JaxDB.open(jds.StoreConfig(**CFG_KW))
    tnone = AerialDB.open(tds.StoreConfig(**CFG_KW), device="cpu")
    for db, q in ((jnone, JQuery), (tnone, Query)):
        with pytest.raises(ValueError, match="max_drones"):
            db.latest()
        with pytest.raises(ValueError, match="max_drones"):
            db.query(q().latest())
    for db, q, spec in ((jdb, JQuery, jds.AggSpec()), (tdb, Query, tds.AggSpec())):
        with pytest.raises(ValueError, match="latest"):
            db.query(q().latest(), agg=spec)


# -- the random planner's key sequence around latest queries ----------------

GAP = 1e-5


def _near_tie_rows(jdb, jkey, w):
    """(Q,) bool: queries whose reference plan holds a shard whose top two
    gumbels among its usable replicas are under GAP apart."""
    jpred = jds.make_pred(**w)
    s = jdb.cfg.max_shards_per_query
    lookup_mask, _ = jds._lookup_sets(jdb.cfg, jpred, jdb.cfg.sites_array(), jdb.alive)
    m = ji.lookup(jdb.state.index, jpred, lookup_mask, s)
    reps, valid, alive = np.asarray(m.replicas), np.asarray(m.valid), np.asarray(jdb.alive)
    ok = (reps >= 0) & alive[np.clip(reps, 0, None)] & valid[..., None]
    keys = jax.vmap(jax.random.fold_in, (None, 0))(jkey, jnp.arange(w["q"]))
    g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (s, 3)))(keys))
    top = np.sort(np.where(ok, g, np.float32(-1e30)), axis=-1)
    return ((ok.sum(-1) >= 2) & (top[..., -1] - top[..., -2] < GAP)).any(-1)


def test_random_planner_keys_skip_latest_queries():
    """A random-planner session that interleaves latest() reads with range
    queries: the latest reads take no split, so the session key, the
    answers and QueryInfo follow the reference's query for query."""
    kw = dict(CFG_KW, planner="random", max_drones=D)
    payloads, metas = DroneFleet(DRONES, records_per_shard=R, seed=4).next_rounds(ROUNDS)
    jdb = JaxDB.open(jds.StoreConfig(**kw), seed=7)
    tdb = AerialDB.open(tds.StoreConfig(**kw), seed=7, device="cpu")
    jdb.ingest_rounds(payloads, metas)
    tdb.ingest_rounds(payloads, metas)
    jkey = jax.random.key(7)
    rng = np.random.default_rng(0)
    pad = np.float32(0.02)
    for i in range(3):
        for db, q in ((jdb, JQuery), (tdb, Query)):
            db.latest()
            db.query(q().latest())
        rnd, drn = rng.integers(0, ROUNDS, 12), rng.integers(0, DRONES, 12)
        w = dict(q=12, lat0=metas.lat0[rnd, drn] - pad, lat1=metas.lat1[rnd, drn] + pad,
                 lon0=metas.lon0[rnd, drn] - pad, lon1=metas.lon1[rnd, drn] + pad,
                 t0=metas.t0[rnd, drn] - np.float32(900.0),
                 t1=metas.t1[rnd, drn] + np.float32(900.0),
                 has_spatial=True, has_temporal=True, is_and=True)
        jkey, sub = jax.random.split(jkey)
        rows = ~_near_tie_rows(jdb, sub, w)
        jres, jinfo = jdb.query(jds.make_pred(**w))
        tres, tinfo = tdb.query(tds.make_pred(**w, device="cpu"))
        np.testing.assert_array_equal(convert.key_to_numpy(tdb._key),
                                      np.asarray(jax.random.key_data(jkey)))
        assert rows.sum() >= 11 and int(tres.count.sum()) > 0
        np.testing.assert_array_equal(tres.count.numpy(), np.asarray(jres.count))
        for f in jds.QueryInfo._fields:
            np.testing.assert_array_equal(getattr(tinfo, f).numpy()[rows],
                                          np.asarray(getattr(jinfo, f))[rows],
                                          err_msg=f)
    for f in tds.LatestResult._fields:
        _assert_bitwise(getattr(tdb.latest(), f).numpy(), getattr(jdb.latest(), f), f)


# -- the host oracle and overlay ----------------------------------------------

def _records(seed, n, d):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-2, d + 2, n)
    t = rng.choice(SPECIAL_T, n) + rng.integers(0, 4, n).astype(np.float32)
    rows = rng.standard_normal((n, W)).astype(np.float32)
    rows[:, 0] = t
    rows[rng.random((n, W)) < 0.1] = np.nan
    rows[:, 0] = t
    return ids, t, rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_and_overlay_match_reference(seed):
    d = 9
    ids, t, rows = _records(seed, 400, d)
    want = jlatest.latest_oracle(ids, t, rows, d)
    got = tlatest.latest_oracle(ids, t, rows, d)
    for g, x in zip(got, want):
        _assert_bitwise(g, x)
    sorted_form = tlatest.latest_oracle_sorted(ids, t, rows, d)
    for g, x in zip(sorted_form[:2], want):
        _assert_bitwise(g, x)
    src = sorted_form[2]
    np.testing.assert_array_equal(src >= 0, want[1])
    _assert_bitwise(rows[src[src >= 0]], want[0][want[1]])
    p_ids, p_t, p_rows = _records(seed + 10, 50, d)
    base = [a.copy() for a in want]
    j_rec, j_val = jlatest.overlay_latest(*[a.copy() for a in base], p_ids, p_t, p_rows)
    t_rec, t_val = tlatest.overlay_latest(*[a.copy() for a in base], p_ids, p_t, p_rows)
    _assert_bitwise(t_rec, j_rec)
    _assert_bitwise(t_val, j_val)


def test_sorted_oracle_matches_loop_on_a_stream():
    """The vectorised oracle against the loop form over a real stream with a
    crafted round spliced in (a fleet's records, 60 a shard)."""
    fleet = DroneFleet(30, records_per_shard=R, seed=8)
    payloads, metas = fleet.next_rounds(4)
    cached_t = payloads[-1, :, -1, 0]
    p, ids = latest_edge_round(payloads[-1], metas.sid_hi[-1], cached_t, 30, seed=1)
    rows = np.concatenate([payloads.reshape(-1, W), p.reshape(-1, W)])
    dids = np.concatenate([np.repeat(metas.sid_hi.reshape(-1), R), np.repeat(ids, R)])
    want = tlatest.latest_oracle(dids, rows[:, 0], rows, 30)
    got = tlatest.latest_oracle_sorted(dids, rows[:, 0], rows, 30)
    for g, x in zip(got[:2], want):
        _assert_bitwise(g, x)
    assert np.isnan(want[0]).any() and want[1].all()
