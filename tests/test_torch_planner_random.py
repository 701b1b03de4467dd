"""The port's random planner (``repro_torch.core.planner.plan_random``) and
the session's key custody held against the JAX package.

Policy: the plans are bitwise the reference's at every shard whose top two
gumbels among its alive replicas are at least 1e-5 apart (the gumbels
differ from JAX's by the ulps of ``log``, under 1e-6); such near-ties are
counted, and rows that hold one are left out of the bitwise comparison.
Query results follow the port's comparison policy (count, vmin, vmax,
overflow and every QueryInfo field bitwise; vsum and vmean to rtol 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import AerialDB as JaxDB
from repro.core import datastore as jds
from repro.core import index as ji
from repro.core import planner as jpl
from repro_torch import convert
from repro_torch.api.query import Query
from repro_torch.api.session import AerialDB
from repro_torch.core import datastore as tds
from repro_torch.core import index as ti
from repro_torch.core import planner as tpl
from repro_torch.core import threefry
from repro_torch.data.synthetic import CityConfig, DroneFleet, make_sites

GAP = 1e-5


def _case(seed, q=16, s=32, e=10, n_dead=0):
    rng = np.random.default_rng(seed)
    valid = rng.random((q, s)) < 0.8
    valid[0] = False                                 # a row with nothing valid
    reps = rng.integers(-1, e, (q, s, 3)).astype(np.int32)
    reps[1, :4] = -1                                 # shards with no replica left
    parts = (rng.integers(0, 100, (q, s)).astype(np.int32),
             rng.integers(0, 100, (q, s)).astype(np.int32), reps, valid,
             np.zeros(q, bool))
    alive = np.ones(e, bool)
    alive[rng.choice(e, n_dead, replace=False)] = False
    return parts, alive


def _usable(parts, alive):
    reps, valid = parts[2], parts[3]
    return (reps >= 0) & alive[np.clip(reps, 0, None)] & valid[..., None]


def _near_ties(jkeys, ok):
    """(Q, S) bool: shards whose top two reference gumbels among their
    usable replicas are under GAP apart."""
    s, r = ok.shape[1:]
    g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (s, r)))(jkeys))
    top = np.sort(np.where(ok, g, np.float32(-1e30)), axis=-1)
    return (ok.sum(-1) >= 2) & (top[..., -1] - top[..., -2] < GAP)


def _plans(parts, alive, jkey, tkey):
    want = np.asarray(jpl.plan("random", ji.MatchedShards(*map(jnp.asarray, parts)),
                               jnp.asarray(alive), jkey))
    got = tpl.plan("random", ti.MatchedShards(*map(torch.from_numpy, parts)),
                   torch.from_numpy(alive), tkey)
    assert got.dtype == torch.int32 and got.shape == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("n_dead", [0, 3, 10])
@pytest.mark.parametrize("form", ["one key", "key batch"])
def test_plan_random_matches_jax(n_dead, form):
    parts, alive = _case(n_dead, n_dead=n_dead)
    q = parts[0].shape[0]
    jkey = jax.random.key(100 + n_dead)
    qkeys = jax.vmap(jax.random.fold_in, (None, 0))(jkey, jnp.arange(q))
    if form == "one key":
        got, want = _plans(parts, alive, jkey,
                           convert.key_from_numpy(jax.random.key_data(jkey)))
    else:
        got, want = _plans(parts, alive, qkeys, convert.key_from_numpy(
            jax.random.key_data(qkeys), "cpu"))
    ok = _usable(parts, alive)
    near = _near_ties(qkeys, ok)
    np.testing.assert_array_equal(got[~near], want[~near])
    assert (got[~ok.any(-1)] == -1).all()
    assert (got[0] == -1).all() and (got[1, :4] == -1).all()
    if n_dead == 10:
        assert (got == -1).all()
    else:
        assigned = got[got >= 0]
        assert assigned.size and alive[assigned].all()


def test_plan_random_many_triples_away_from_near_ties():
    """65,536 shards with three live replicas each: the picks equal the
    reference's wherever the top-2 gap is at least 1e-5."""
    q, s, e = 512, 128, 80
    rng = np.random.default_rng(21)
    reps = np.stack([rng.permutation(e)[:3] for _ in range(q * s)]).reshape(
        q, s, 3).astype(np.int32)
    parts = (np.zeros((q, s), np.int32), np.zeros((q, s), np.int32), reps,
             np.ones((q, s), bool), np.zeros(q, bool))
    alive = np.ones(e, bool)
    jkey = jax.random.key(2024)
    got, want = _plans(parts, alive, jkey, threefry.key(2024))
    qkeys = jax.vmap(jax.random.fold_in, (None, 0))(jkey, jnp.arange(q))
    near = _near_ties(qkeys, _usable(parts, alive))
    np.testing.assert_array_equal(got[~near], want[~near])
    assert near.sum() < 16                           # none in this draw


def test_plan_random_key_forms_and_tiles_agree():
    """One key, the equivalent (Q, 2) batch of folded keys, and the tiles
    (0:3, 3:7, 2:5) of that batch give one plan, as the reference's
    tiling invariant (tests/test_planner_property.py) requires."""
    rng = np.random.default_rng(5)
    q, s, e = 7, 6, 5
    reps = rng.integers(-1, e, size=(q, s, 3)).astype(np.int32)
    ids = torch.from_numpy(np.tile(np.arange(s, dtype=np.int32), (q, 1)))
    matched = ti.MatchedShards(sid_hi=ids, sid_lo=ids, replicas=torch.from_numpy(reps),
                               valid=torch.ones((q, s), dtype=torch.bool),
                               overflow=torch.zeros(q, dtype=torch.bool))
    alive = torch.from_numpy(rng.integers(0, 2, size=e).astype(bool))
    key = threefry.key(11)
    full = tpl.plan("random", matched, alive, key)
    qkeys = threefry.fold_in(key, torch.arange(q))
    torch.testing.assert_close(full, tpl.plan("random", matched, alive, qkeys),
                               rtol=0, atol=0)
    for sl in (slice(0, 3), slice(3, 7), slice(2, 5)):
        tile = ti.MatchedShards(*[f[sl] for f in matched])
        torch.testing.assert_close(full[sl], tpl.plan("random", tile, alive, qkeys[sl]),
                                   rtol=0, atol=0, msg=str(sl))


# -- the facade --------------------------------------------------------------

E, DRONES, R, ROUNDS, S = 8, 12, 60, 6, 128
SITES = tuple(map(tuple, make_sites(E, CityConfig(), seed=3).tolist()))
CFG_KW = dict(n_edges=E, sites=SITES, tuple_capacity=4096, index_capacity=512,
              max_shards_per_query=S, records_per_shard=R, planner="random")


@pytest.fixture(scope="module")
def pair():
    """The same rounds into a random-planner store of each package, both
    opened with seed 7; nothing wraps, so every tuple is retained."""
    payloads, metas = DroneFleet(DRONES, records_per_shard=R, seed=4).next_rounds(ROUNDS)
    jdb = JaxDB.open(jds.StoreConfig(**CFG_KW), seed=7)
    jdb.ingest_rounds(payloads, metas)
    tdb = AerialDB.open(tds.StoreConfig(**CFG_KW), seed=7, device="cpu")
    tdb.ingest_rounds(payloads, metas)
    return jdb, tdb, payloads, metas


def _workload(metas, q=12, seed=0):
    """AND queries around real shards, so each matches several shards with
    three replicas to pick from."""
    rng = np.random.default_rng(seed)
    rnd = rng.integers(0, ROUNDS, q)
    drn = rng.integers(0, DRONES, q)
    pad = np.float32(0.02)
    return dict(q=q, lat0=metas.lat0[rnd, drn] - pad, lat1=metas.lat1[rnd, drn] + pad,
                lon0=metas.lon0[rnd, drn] - pad, lon1=metas.lon1[rnd, drn] + pad,
                t0=metas.t0[rnd, drn] - np.float32(900.0),
                t1=metas.t1[rnd, drn] + np.float32(900.0),
                has_spatial=True, has_temporal=True, is_and=True)


def _query_near_ties(jdb, jkey, w):
    """(Q,) bool: queries whose reference plan holds a near-tie."""
    jpred = jds.make_pred(**w)
    q = w["q"]
    lookup_mask, _ = jds._lookup_sets(jdb.cfg, jpred, jdb.cfg.sites_array(), jdb.alive)
    matched = ji.lookup(jdb.state.index, jpred, lookup_mask, S)
    ok = _usable(tuple(np.asarray(f) for f in matched), np.asarray(jdb.alive))
    qkeys = jax.vmap(jax.random.fold_in, (None, 0))(jkey, jnp.arange(q))
    return _near_ties(qkeys, ok).any(-1)


def _compare(jres, jinfo, tres, tinfo, rows):
    for f in jds.QueryResult._fields:
        a, b = getattr(tres, f).numpy(), np.asarray(getattr(jres, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f in ("vsum", "vmean"):
            np.testing.assert_allclose(a, b, rtol=1e-5, equal_nan=True, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    for f in jds.QueryInfo._fields:
        np.testing.assert_array_equal(getattr(tinfo, f).numpy()[rows],
                                      np.asarray(getattr(jinfo, f))[rows], err_msg=f)


def test_facade_session_keys_match_jax(pair):
    """Three consecutive queries without ``key=``: each session splits its
    own key, so the port's answers and QueryInfo follow the reference's
    query for query."""
    jdb, tdb, _, metas = pair
    jkey = jax.random.key(7)
    spec_j, spec_t = jds.AggSpec(channels=(0, 2)), tds.AggSpec(channels=(0, 2))
    edges = []
    for i in range(3):
        w = _workload(metas, seed=i)
        jkey, sub = jax.random.split(jkey)
        rows = ~_query_near_ties(jdb, sub, w)
        jres, jinfo = jdb.query(jds.make_pred(**w), agg=spec_j)
        tres, tinfo = tdb.query(tds.make_pred(**w, device="cpu"), agg=spec_t)
        _compare(jres, jinfo, tres, tinfo, rows)
        assert rows.sum() >= w["q"] - 1
        assert int(tres.count.sum()) > 0
        np.testing.assert_array_equal(convert.key_to_numpy(tdb._key),
                                      np.asarray(jax.random.key_data(jkey)))
        edges.append(tinfo.subquery_edges.numpy())
    # the planner's picks reach the answer's metadata and change with the key
    assert any((a != b).any() for a, b in zip(edges, edges[1:]))


def test_facade_explicit_key_matches_jax(pair):
    """``query(key=...)`` with a JAX key carried over by ``key_from_numpy``
    plans as the reference's ``query(key=...)`` does, and leaves the
    session's own key where it was."""
    jdb, tdb, _, metas = pair
    w = _workload(metas, seed=9)
    jkey = jax.random.key(123)
    before = tdb._key
    jres, jinfo = jdb.query(jds.make_pred(**w), key=jkey)
    tres, tinfo = tdb.query(tds.make_pred(**w, device="cpu"),
                            key=convert.key_from_numpy(jax.random.key_data(jkey)))
    assert tdb._key == before
    _compare(jres, jinfo, tres, tinfo, ~_query_near_ties(jdb, jkey, w))


def test_facade_owns_key_custody(pair):
    """As the reference's test of the same name: a random-planner session
    built over an existing state with its own key answers the same on
    fresh splits, every retained tuple counted."""
    _, tdb, payloads, _ = pair
    db = AerialDB(dataclasses.replace(tdb.cfg, planner="random"), tdb.state,
                  tdb.alive, threefry.key(42), device="cpu")
    city = CityConfig()
    q = Query().bbox(city.lat_min, city.lat_max, city.lon_min,
                     city.lon_max).time(0.0, 1e9).agg("count")
    r1, i1 = db.query(q.build("cpu"))
    r2, i2 = db.query(q.build("cpu"))
    assert int(r1.count[0]) == int(r2.count[0]) == payloads.shape[0] * DRONES * R
    assert db._key == threefry.split(threefry.split(threefry.key(42))[0])[0]


def test_refused_query_takes_no_key(pair):
    """A query whose spec is refused consumes no key, as the reference
    validates before it splits."""
    _, tdb, _, metas = pair
    before = tdb._key
    with pytest.raises(ValueError, match="out of range"):
        tdb.query(tds.make_pred(**_workload(metas), device="cpu"),
                  agg=tds.AggSpec(channel=9))
    assert tdb._key == before
