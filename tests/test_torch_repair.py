"""Incremental anti-entropy repair of ``repro_torch`` held against the JAX
package: the port of ``tests/test_repair_incremental.py``, case by case,
with one JAX session and one port session on the CPU taking the same
numpy-seeded stream and the same fail/recover schedule.

Policy: every StoreState / IndexState leaf bitwise, the repair telemetry
(``_swept_keys`` included, from ``repair_state``) and ``ledger()`` equal,
QueryResult count/min/max and QueryInfo bitwise, vsum/vmean to rtol 1e-5.
The port's repair updates the state in place (ROADMAP, "State updates"), so
a full sweep from the same pre-state runs on ``clone_state`` of it.

The reference's sweep calls ``place_replicas`` and ``_index_edge_mask``
eagerly on the swept subset, and JAX compiles every eager op anew for each
subset size (several seconds a size). The module fixture
``bucketed_reference_placement`` runs those two calls under ``jax.jit``, as
the reference's insert runs them, on the subset padded to a power-of-two
bucket and cut back: both are row-independent (``repro/core/repair.py``),
and ``test_bucketed_reference_placement_equals_its_jitted_call`` holds the
bucketed rows bitwise to the unpadded jitted call's. Jitted and eager JAX
differ at exact slice-cell boundaries (XLA multiplies by the cell width's
float32 reciprocal where the eager op divides); the port follows the
jitted reference, which its insert and query are held to
(``test_reference_jit_and_eager_cells_split_and_the_port_follows_jit``),
so on a stream with a boundary shard the port's repair differs from the
reference's as shipped. On a stream without one the shipped reference's
repair equals the port's
(``test_unpatched_reference_repair_equals_the_port_without_boundary_shards``).

``test_incremental_repair_differential_mesh`` runs the reference's mesh
case on both of its layouts, the ``(4,) ("edge",)`` mesh and the ``(2, 2)
("fleet", "edge")`` mesh: the JAX package's 4-device mesh, the port's
one-process mesh (``Pair(mesh="edge4")`` / ``Pair(mesh="fleet2x2")``) and
the port's single store.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.api import AerialDB as JaxDB
from repro.core import datastore as jds
from repro.core import placement as jplace
from repro.core import repair as jrepair
from repro.launch.mesh import make_edge_mesh as j_make_edge_mesh
from repro.launch.mesh import make_fleet_mesh as j_make_fleet_mesh
from repro_torch import convert
from repro_torch.api.session import AerialDB
from repro_torch.core import datastore as tds
from repro_torch.core import repair as trepair
from repro_torch.data.synthetic import CityConfig, DroneFleet, make_sites
from repro_torch.launch.mesh import make_edge_mesh, make_fleet_mesh

E = 8
N_DEV = 4          # the edge mesh's blocks (the reference's forced devices)
CAP = 256          # small ring: sustained ingest wraps it mid-outage
SITES = tuple(map(tuple, make_sites(E, CityConfig(), seed=3).tolist()))
CFG_KW = dict(n_edges=E, sites=SITES, tuple_capacity=CAP, index_capacity=512,
              max_shards_per_query=64, records_per_shard=8,
              retention_every=2, n_failure_domains=4)
CATCH_ALL = dict(q=1, t0=0.0, t1=1e9, has_temporal=True, is_and=True)


_JIT_PLACE = jax.jit(jplace.place_replicas, static_argnums=(3, 4))
_JIT_MASK = jax.jit(jds._index_edge_mask, static_argnums=0)
# The reference's repair placement calls as shipped (eager), before the
# module fixture replaces them.
_EAGER_PLACE, _EAGER_MASK = jrepair.place_replicas, jrepair._index_edge_mask


def _padded(x, b):
    """``x`` with rows repeated from its first up to ``b`` rows."""
    return jnp.concatenate([x, jnp.broadcast_to(x[:1], (b - x.shape[0],)
                                                + x.shape[1:])])


def _bucket(n: int) -> int:
    return max(16, 1 << (n - 1).bit_length())


def _place_bucketed(meta, sites, alive, tau, n_domains=1):
    n = meta.sid_hi.shape[0]
    meta = type(meta)(*(_padded(f, _bucket(n)) for f in meta))
    return _JIT_PLACE(meta, sites, alive, tau, n_domains)[:n]


def _mask_bucketed(cfg, meta, replicas, sites, alive):
    n = meta.sid_hi.shape[0]
    meta = type(meta)(*(_padded(f, _bucket(n)) for f in meta))
    return _JIT_MASK(cfg, meta, _padded(replicas, _bucket(n)), sites, alive)[:n]


@pytest.fixture(scope="module", autouse=True)
def bucketed_reference_placement():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrepair, "place_replicas", _place_bucketed)
        mp.setattr(jrepair, "_index_edge_mask", _mask_bucketed)
        yield


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _leaves(state):
    """(name, numpy array) of every StoreState and IndexState leaf, of
    either package's state."""
    for f in jds.StoreState._fields:
        if f == "index":
            for g in jds.IndexState._fields:
                yield f"index.{g}", np.asarray(getattr(state.index, g))
        else:
            yield f, np.asarray(getattr(state, f))


def _assert_states_identical(got, want, msg=""):
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype, f"{msg}{name}"
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{msg}{name}")


def _assert_query_equal(tres, tinfo, jres, jinfo):
    for f in jds.QueryResult._fields:
        a, b = getattr(tres, f).numpy(), np.asarray(getattr(jres, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f in ("vsum", "vmean"):
            np.testing.assert_allclose(a, b, rtol=1e-5, equal_nan=True, err_msg=f)
        else:
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f)
    for f in jds.QueryInfo._fields:
        np.testing.assert_array_equal(_bits(getattr(tinfo, f).numpy()),
                                      _bits(getattr(jinfo, f)), err_msg=f)


def mesh_pair(name: str):
    """The JAX package's and the port's (CPU) mesh of one layout:
    ``"edge4"``, the ``(4,) ("edge",)`` mesh, or ``"fleet2x2"``, the
    ``(2, 2) ("fleet", "edge")`` mesh."""
    if jax.device_count() < N_DEV:
        pytest.skip(f"needs {N_DEV} host devices")
    if name == "edge4":
        return j_make_edge_mesh(N_DEV), make_edge_mesh(N_DEV, device="cpu")
    assert name == "fleet2x2", name
    return (j_make_fleet_mesh(2, N_DEV // 2),
            make_fleet_mesh(2, N_DEV // 2, device="cpu"))


class Pair:
    """A JAX session and a port session (CPU) driven in lockstep; with
    ``mesh`` (a ``mesh_pair`` layout name, True for ``"edge4"``), each on
    its package's mesh of that layout."""

    def __init__(self, mesh=False, **overrides):
        kw = dict(CFG_KW, **overrides)
        self.jcfg, self.tcfg = jds.StoreConfig(**kw), tds.StoreConfig(**kw)
        if mesh:
            jmesh, tmesh = mesh_pair("edge4" if mesh is True else mesh)
            self.j = JaxDB.open(self.jcfg, mesh=jmesh, seed=0)
            self.t = AerialDB.open(self.tcfg, tmesh, seed=0)
        else:
            self.j = JaxDB.open(self.jcfg, seed=0)
            self.t = AerialDB.open(self.tcfg, seed=0, device="cpu")

    def both(self, name, *args, **kw):
        jout = getattr(self.j, name)(*args, **kw)
        tout = getattr(self.t, name)(*args, **kw)
        return jout, tout

    def ingest(self, fleet, rounds=1):
        for _ in range(rounds):
            p, m = fleet.next_shards()
            self.both("insert", p, m)
        return p, m

    def check(self, msg=""):
        _assert_states_identical(self.t.state, self.j.state, msg)
        assert self.t.ledger() == self.j.ledger(), msg
        np.testing.assert_array_equal(self.t.alive.numpy(), np.asarray(self.j.alive))

    def full_sweeps(self):
        """Both packages' full sweep from the current pre-state (the port's on
        a clone); returns ((jax state, info), (port state, info))."""
        jfull = jrepair.repair_state(self.jcfg, self.j.state, self.j.alive,
                                     outage=None)
        tfull = trepair.repair_state(self.tcfg, tds.clone_state(self.t.state),
                                     self.t.alive, outage=None)
        assert tfull[1] == jfull[1]
        _assert_states_identical(tfull[0], jfull[0], "full sweep: ")
        return jfull, tfull

    def repair_against_full(self, msg=""):
        """Full sweeps, then each session's incremental repair: the port equal
        to JAX, and each incremental repair equal to its full sweep."""
        jfull, tfull = self.full_sweeps()
        jinfo, tinfo = self.both("repair")
        assert tinfo == jinfo, msg
        assert tinfo["mode"] == "incremental"
        assert tinfo["shards_swept"] <= tfull[1]["shards_swept"]
        _assert_states_identical(self.t.state, tfull[0], msg + "port inc vs full: ")
        self.check(msg)
        return tinfo

    def total_count(self):
        jres, jinfo = self.j.query(jds.make_pred(**CATCH_ALL),
                                   key=jax.random.key(0))
        tres, tinfo = self.t.query(tds.make_pred(**CATCH_ALL, device="cpu"),
                                   key=convert.key_from_numpy(
                                       jax.random.key_data(jax.random.key(0))))
        _assert_query_equal(tres, tinfo, jres, jinfo)
        return int(tres.count[0])


def _fleet(seed):
    return DroneFleet(12, records_per_shard=8, seed=seed)


@pytest.mark.parametrize("n", [1, 37, 100])
def test_bucketed_reference_placement_equals_its_jitted_call(n):
    """The fixture's bucketed calls give the rows of the same jitted calls
    on the unpadded subset, bitwise, with a dead edge and failure domains."""
    fleet = _fleet(59)
    rows = [fleet.next_shards()[1] for _ in range(-(-n // 12))]
    meta = jplace.ShardMeta(*(jnp.asarray(np.concatenate(f)[:n])
                              for f in zip(*rows)))
    cfg = jds.StoreConfig(**CFG_KW)
    alive = jnp.asarray(np.arange(E) != 5)
    args = (meta, cfg.sites_array(), alive, cfg.tau, cfg.n_failure_domains)
    want = _JIT_PLACE(*args)
    np.testing.assert_array_equal(_place_bucketed(*args), want)
    np.testing.assert_array_equal(
        _mask_bucketed(cfg, meta, want, cfg.sites_array(), alive),
        _JIT_MASK(cfg, meta, want, cfg.sites_array(), alive))


def test_reference_jit_and_eager_cells_split_and_the_port_follows_jit():
    """A shard whose west edge is the city's (lon 77.45, where drones
    clamp): the reference's jitted index mask (its insert's) names a cell
    and an edge that its eager mask (its repair's) does not; the port's
    equals the jitted one."""
    cfg = jds.StoreConfig(**CFG_KW)
    f32 = np.float32
    meta = dict(sid_hi=np.int32([3]), sid_lo=np.int32([4]),
                lat0=f32([13.024896]), lat1=f32([13.024961]), lon0=f32([77.45]),
                lon1=f32([77.45049]), t0=f32([120.0]), t1=f32([155.0]))
    jmeta = jplace.ShardMeta(**{k: jnp.asarray(v) for k, v in meta.items()})
    reps = jnp.full((1, 3), -1, jnp.int32)
    alive = jnp.ones(E, bool)
    jit = np.asarray(_JIT_MASK(cfg, jmeta, reps, cfg.sites_array(), alive))
    eager = np.asarray(jds._index_edge_mask(cfg, jmeta, reps, cfg.sites_array(),
                                            alive))
    tcfg = tds.StoreConfig(**CFG_KW)
    port = tds._index_edge_mask(
        tcfg, tds.ShardMeta(**{k: torch.from_numpy(v) for k, v in meta.items()}),
        torch.from_numpy(np.asarray(reps)), tcfg.sites_array(),
        torch.ones(E, dtype=torch.bool)).numpy()
    assert (jit & ~eager).any()
    np.testing.assert_array_equal(port, jit)


def test_unpatched_reference_repair_equals_the_port_without_boundary_shards(
        monkeypatch):
    """The reference's repair as shipped, its placement calls eager, equals
    the port's on a stream in which no shard's eager and jitted placement
    or index mask part (checked first): the fixture changes nothing but
    the boundary shards."""
    pair = Pair()
    fleet = _fleet(61)
    metas = [pair.ingest(fleet)[1]]
    pair.both("fail_device", 1)
    metas += [pair.ingest(fleet)[1] for _ in range(2)]
    pair.both("recover_device", 1, repair=False)
    cfg, sites = pair.jcfg, pair.jcfg.sites_array()
    meta = jplace.ShardMeta(*(jnp.asarray(np.concatenate(f)) for f in zip(*metas)))
    alive = jnp.asarray(pair.j.alive)
    args = (meta, sites, alive, cfg.tau, cfg.n_failure_domains)
    reps = _JIT_PLACE(*args)
    np.testing.assert_array_equal(_EAGER_PLACE(*args), reps)
    np.testing.assert_array_equal(_EAGER_MASK(cfg, meta, reps, sites, alive),
                                  _JIT_MASK(cfg, meta, reps, sites, alive))
    monkeypatch.setattr(jrepair, "place_replicas", _EAGER_PLACE)
    monkeypatch.setattr(jrepair, "_index_edge_mask", _EAGER_MASK)
    info = pair.repair_against_full()
    assert info["shards_replaced"] > 0


# ---------------------------------------------------------------------------
# incremental sweep == full sweep, bitwise, on both packages
# ---------------------------------------------------------------------------


@given(st.integers(0, 1 << 30))
@settings(deadline=None, max_examples=8)
def test_incremental_repair_matches_full_sweep_property(seed):
    """Random fail/ingest/recover interleavings (small rings wrap retention
    mid-outage; partial recoveries exercise the pending set): at every
    repair point the port's incremental sweep equals its full sweep from a
    clone of the pre-state, and both equal the JAX package's."""
    rng = np.random.default_rng(seed)
    pair = Pair()
    fleet = _fleet(int(rng.integers(1 << 20)))
    dead = set()
    pair.ingest(fleet, 2)
    for _ in range(int(rng.integers(8, 14))):
        op = rng.choice(["ingest", "fail", "recover"], p=[0.5, 0.25, 0.25])
        if op == "ingest":
            pair.ingest(fleet, int(rng.integers(1, 3)))
        elif op == "fail":
            candidates = sorted(set(range(E)) - dead)
            if len(candidates) <= 3:
                continue
            k = min(int(rng.integers(1, 3)), len(candidates) - 3)
            edges = [int(e) for e in rng.choice(candidates, size=k,
                                                replace=False)]
            pair.both("fail_edges", edges)
            dead |= set(edges)
        else:
            if not dead:
                continue
            k = int(rng.integers(1, len(dead) + 1))
            edges = [int(e) for e in rng.choice(sorted(dead), size=k,
                                                replace=False)]
            pair.both("recover_edges", edges, repair=False)
            dead -= set(edges)
            pair.check(f"seed={seed} before repair: ")
            pair.repair_against_full(f"seed={seed}: ")
    if dead:
        pair.both("recover_edges", sorted(dead), repair=False)
        pair.repair_against_full(f"seed={seed} drain: ")


def test_incremental_repair_reattempts_ingest_time_index_drops():
    """Entries dropped at ingest by a full index table ride the pending set
    through the drop watch, so ``repair()`` with no outage equals
    ``repair(full=True)``; the port's watch holds the drop counts unread
    until the repair drains it."""
    kw = dict(index_capacity=32, retention_every=1 << 20)
    inc, full = Pair(**kw), Pair(**kw)
    for pair in (inc, full):
        pair.ingest(DroneFleet(12, records_per_shard=8, seed=23), 6)
    assert int(inc.t.state.index.dropped.sum()) > 0
    assert len(inc.t._drop_watch) == 6 and not inc.t._dropped_sids
    jinc, tinc = inc.both("repair")
    jfull, tfull = full.both("repair", full=True)
    assert tinc == jinc and tfull == jfull
    assert tinc["mode"] == "incremental" and tfull["mode"] == "full"
    assert 0 < tinc["shards_swept"] <= tfull["shards_swept"]
    _assert_states_identical(inc.t.state, full.t.state)
    inc.check()
    full.check()


def test_incremental_repair_retention_wrap_during_outage():
    """Sustained ingest wraps rings during a domain outage: incremental equals
    full, both packages agree, and the freshest shards answer completely with
    the degradation keys in the result view."""
    pair = Pair()
    fleet = _fleet(7)
    pair.ingest(fleet, 2)
    pair.both("fail_device", 1)
    _, m_last = pair.ingest(fleet, 8)
    assert int(pair.t.state.tup_count.max()) > CAP        # wrapped
    pair.both("recover_device", 1, repair=False)
    info = pair.repair_against_full()
    assert info["shards_replaced"] > 0
    hi = np.asarray(m_last.sid_hi).reshape(-1)
    lo = np.asarray(m_last.sid_lo).reshape(-1)
    w = dict(q=hi.size, sid_hi=hi, sid_lo=lo, has_sid=True)
    jres, jinfo = pair.j.query(jds.make_pred(**w), key=jax.random.key(1))
    tres, tinfo = pair.t.query(tds.make_pred(**w, device="cpu"),
                               key=convert.key_from_numpy(
                                   jax.random.key_data(jax.random.key(1))))
    _assert_query_equal(tres, tinfo, jres, jinfo)
    np.testing.assert_array_equal(tres.count.numpy(), 8)
    view = tres.view(tds.AggSpec())
    np.testing.assert_array_equal(view["completeness_bound"].numpy(), 1.0)
    np.testing.assert_array_equal(view["replicas_lost"].numpy(), 0)


def test_incremental_repair_overlapping_outages_pending_set():
    """The reference's differential schedule on one device: a domain outage,
    then overlapping edge outages with a partial recovery (the pending-sweep
    path), each repair against the full sweep and JAX."""
    pair = Pair()
    fleet = _fleet(11)
    pair.ingest(fleet, 2)
    pair.both("fail_device", 1)
    pair.ingest(fleet, 2)
    pair.both("recover_device", 1, repair=False)
    pair.repair_against_full("domain: ")
    pair.both("fail_edges", 0)
    pair.ingest(fleet, 1)
    pair.both("fail_edges", 5)
    pair.ingest(fleet, 1)
    pair.both("recover_edges", 0, repair=False)
    pair.repair_against_full("edge 5 still dead: ")
    assert pair.t.ledger()["pending_sids"] > 0
    pair.ingest(fleet, 1)
    pair.both("recover_edges", 5, repair=False)
    pair.repair_against_full("all back: ")
    assert pair.t.ledger()["pending_sids"] == 0
    pair.total_count()


@pytest.mark.parametrize("mesh", ["edge4", "fleet2x2"])
def test_incremental_repair_differential_mesh(mesh):
    """The reference's mesh case with churn, on both mesh layouts: the same
    fail/ingest/recover/repair script through the JAX mesh session, the
    port mesh session and the port single-device session keeps every state
    bitwise identical and the (incremental) repair telemetry equal, and
    each incremental repair equals its full sweep (a domain loss, then
    overlapping outages with a partial recovery: the pending-sweep path)."""
    pair = Pair(mesh=mesh)
    single = AerialDB.open(pair.tcfg, seed=0, device="cpu")
    fleet = _fleet(11)

    def step(name, *args, **kw):
        pair.both(name, *args, **kw)
        return getattr(single, name)(*args, **kw)

    def ingest(rounds):
        for _ in range(rounds):
            step("insert", *fleet.next_shards())

    def repair_and_check(msg):
        info = pair.repair_against_full(msg)
        assert single.repair() == info, msg
        _assert_states_identical(single.state, pair.j.state, msg)
        assert single.ledger() == pair.j.ledger(), msg

    ingest(2)
    step("fail_device", 1)
    ingest(2)
    step("recover_device", 1, repair=False)
    repair_and_check("domain loss: ")
    step("fail_edges", 0)
    ingest(1)
    step("fail_edges", 5)
    ingest(1)
    step("recover_edges", 0, repair=False)
    repair_and_check("edge 5 still dead: ")
    assert pair.t.ledger()["pending_sids"] > 0
    ingest(1)
    step("recover_edges", 5, repair=False)
    repair_and_check("all recovered: ")
    total = pair.total_count()
    res, _ = single.query(tds.make_pred(**CATCH_ALL, device="cpu"),
                          key=convert.key_from_numpy(
                              jax.random.key_data(jax.random.key(0))))
    assert int(res.count[0]) == total


# ---------------------------------------------------------------------------
# O(outage) scaling + ring reclamation
# ---------------------------------------------------------------------------


def test_sweep_scales_with_outage_not_store():
    pair = Pair()
    fleet = _fleet(13)
    pair.ingest(fleet, 8)                    # long history, all alive
    pair.both("fail_edges", 1)
    pair.ingest(fleet, 1)                    # one round during the outage
    pair.both("recover_edges", 1)            # incremental repair
    rep = pair.t.last_repair
    assert rep == pair.j.last_repair
    assert rep["shards_swept"] > 0
    assert rep["shards_tracked"] >= 3 * rep["shards_swept"], rep
    pair.check()


def _holders_match_replicas(state):
    ent_i = state.index.ent_i.numpy()
    valid = state.index.valid.numpy()
    tup_sid = state.tup_sid.numpy()
    windows = np.minimum(state.tup_count.numpy(), CAP)
    shard_reps = {}
    for v, c in zip(*np.nonzero(valid)):
        k = trepair.sid_key(ent_i[v, c, 0], ent_i[v, c, 1])
        shard_reps[k] = {int(r) for r in ent_i[v, c, 2:5] if r >= 0}
    for k, reps in shard_reps.items():
        hi, lo = np.int32(k >> 32), np.int32(k & 0xFFFFFFFF)
        holders = {int(e) for e in range(E)
                   if np.any((tup_sid[e, 0, :windows[e]] == hi)
                             & (tup_sid[e, 1, :windows[e]] == lo))}
        assert holders == reps, (k, holders, reps)


def test_repair_reclaims_stale_copies_on_dropped_edges():
    """Edges dropped by re-placement have their stale slots retired: every
    shard's tuple holders equal its index replica set, no count lost."""
    pair = Pair()
    fleet = _fleet(17)
    pair.ingest(fleet, 1)
    pair.both("fail_device", 1)
    pair.ingest(fleet, 2)
    before = pair.total_count()
    pair.both("recover_device", 1)
    rep = pair.t.last_repair
    assert rep == pair.j.last_repair
    assert rep["shards_replaced"] > 0 and rep["slots_reclaimed"] > 0, rep
    assert pair.total_count() == before
    pair.check()
    _holders_match_replicas(pair.t.state)


def test_reclaimed_ring_slots_are_reset():
    """Freed slots read as never-written through the padded capacity, the
    cursor and count rewind consistently, and ingest answers exactly after."""
    pair = Pair()
    fleet = _fleet(19)
    pair.both("fail_device", 1)
    pair.ingest(fleet, 2)
    pair.both("recover_device", 1)
    assert pair.t.last_repair["slots_reclaimed"] > 0
    pair.check()
    st_ = pair.t.state
    tup_sid, tup_f = st_.tup_sid.numpy(), st_.tup_f.numpy()
    count, pos = st_.tup_count.numpy(), st_.tup_pos.numpy()
    for e in range(E):
        w = min(int(count[e]), CAP)
        assert (tup_sid[e, 0, w:] == -1).all(), e
        assert (tup_f[e, :, w:] == 0).all(), e
        if int(count[e]) <= CAP:
            assert int(pos[e]) == int(count[e]) % CAP, e
    before = pair.total_count()
    pair.ingest(fleet, 1)
    assert pair.total_count() == before + 12 * 8
    pair.check()


# ---------------------------------------------------------------------------
# backfill clamp corners and chronological order, against the reference
# ---------------------------------------------------------------------------


def _ring_fixture(cap, width=4, n_edges=2):
    tup_f = np.zeros((n_edges, width, cap * 2), np.float32)
    tup_sid = np.full((n_edges, 2, cap * 2), -1, np.int32)
    tup_count = np.zeros(n_edges, np.int64)
    tup_pos = np.zeros(n_edges, np.int64)
    tup_over = np.zeros(n_edges, np.int64)
    return tup_f, tup_sid, tup_count, tup_pos, tup_over


def _backfill_both(ring, *args):
    """The port's ``_backfill_copy`` and the reference's on copies of one
    ring: the same count and every array equal. Returns the port's ring."""
    mine = [a.copy() for a in ring]
    ref = [a.copy() for a in ring]
    n = trepair._backfill_copy(*mine, *args)
    assert n == jrepair._backfill_copy(*ref, *args)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    return n, mine


def test_backfill_full_ring_hit_exact_telemetry():
    cap = 8
    ring = _ring_fixture(cap)
    tup_f, tup_sid, tup_count, tup_pos, _ = ring
    src, dst, hi, lo = 0, 1, 7, 1
    tup_f[src, :, :cap] = np.arange(cap, dtype=np.float32)[None, :]
    tup_sid[src, 0, :cap] = hi
    tup_sid[src, 1, :cap] = lo
    tup_count[src] = cap
    tup_count[dst], tup_pos[dst] = 3, 3
    n, (tup_f, tup_sid, tup_count, tup_pos, tup_over) = _backfill_both(
        ring, src, dst, np.arange(cap, dtype=np.int64), hi, lo, cap)
    assert n == cap
    assert int(tup_count[dst]) == 3 + cap
    assert int(tup_over[dst]) == 3
    assert int(tup_pos[dst]) == (3 + cap) % cap
    np.testing.assert_array_equal(tup_f[dst, 0, :cap],
                                  np.roll(np.arange(cap, dtype=np.float32), 3))
    assert (tup_sid[dst, 0, :cap] == hi).all()


def test_backfill_oversized_hit_clamps_to_newest():
    cap, n_hit = 8, 12
    ring = _ring_fixture(cap)
    tup_f, tup_sid, tup_count, _, _ = ring
    src, dst, hi, lo = 0, 1, 9, 2
    tup_f[src, :, :n_hit] = np.arange(n_hit, dtype=np.float32)[None, :]
    tup_sid[src, 0, :n_hit] = hi
    tup_sid[src, 1, :n_hit] = lo
    tup_count[src] = n_hit
    n, (tup_f, _, tup_count, tup_pos, tup_over) = _backfill_both(
        ring, src, dst, np.arange(n_hit, dtype=np.int64), hi, lo, cap)
    assert n == cap
    assert int(tup_count[dst]) == cap
    assert int(tup_over[dst]) == 0
    assert int(tup_pos[dst]) == 0
    np.testing.assert_array_equal(tup_f[dst, 0, :cap],
                                  np.arange(n_hit - cap, n_hit, dtype=np.float32))


@pytest.mark.parametrize("count,pos,want", [(6, 6, [0, 1, 5, 7]),
                                            (20, 6, [7, 0, 1, 5]),
                                            (8, 0, [0, 1, 5, 7]),
                                            (9, 1, [1, 5, 7, 0])])
def test_chrono_order_wrapped_ring(count, pos, want):
    slots = np.array([0, 1, 5, 7], np.int64)
    got = trepair._chrono_order(slots, count, pos, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jrepair._chrono_order(slots, count, pos, 8))


# ---------------------------------------------------------------------------
# no-op repairs, the multi-process guard, ledger honesty
# ---------------------------------------------------------------------------


def test_empty_ledger_repair_is_telemetry_only_noop():
    pair = Pair()
    pair.ingest(_fleet(23), 2)
    before = tds.clone_state(pair.t.state)
    jinfo, info = pair.both("repair")
    assert info == jinfo
    assert info["mode"] == "incremental"
    assert info["shards_tracked"] > 0 and info["shards_swept"] == 0
    for k in ("shards_replaced", "shards_unrepairable", "tuples_copied",
              "slots_reclaimed", "entries_rewritten", "entries_backfilled",
              "entries_dropped"):
        assert info[k] == 0, k
    assert pair.t.last_repair == info
    assert "_swept_keys" not in info
    _assert_states_identical(pair.t.state, before)
    pair.check()


def test_fail_recover_without_ingest_repairs_nothing():
    pair = Pair()
    pair.ingest(_fleet(29), 2)
    before = tds.clone_state(pair.t.state)
    pair.both("fail_edges", 2, 6)
    pair.both("recover_edges", 2, 6)
    info = pair.t.last_repair
    assert info == pair.j.last_repair
    assert info["shards_swept"] == 0 and info["shards_tracked"] > 0
    for k in ("shards_replaced", "tuples_copied", "slots_reclaimed",
              "entries_rewritten", "entries_backfilled"):
        assert info[k] == 0, k
    _assert_states_identical(pair.t.state, before)
    full, _ = trepair.repair_state(pair.tcfg, tds.clone_state(before),
                                   pair.t.alive, outage=None)
    _assert_states_identical(full, pair.t.state)
    pair.check()


def test_repair_full_flag_sweeps_everything():
    pair = Pair()
    pair.ingest(_fleet(31), 2)
    jinfo, info = pair.both("repair", full=True)
    assert info == jinfo
    assert info["mode"] == "full"
    assert info["shards_swept"] == info["shards_tracked"] > 0
    pair.check()


def test_repair_multiprocess_guard(monkeypatch):
    """repair() gathers the whole store to one host: under a
    ``torch.distributed`` world of more than one process it refuses, on
    the explicit call and on recovery's default repair; recovery with
    ``repair=False`` stays available."""
    db = AerialDB.open(tds.StoreConfig(**CFG_KW), device="cpu")
    p, m = _fleet(37).next_shards()
    db.insert(p, m)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="single-process"):
        db.repair()
    db.fail_edges(1)
    with pytest.raises(NotImplementedError, match="single-process"):
        db.recover_edges(1)
    db.recover_edges(1, repair=False)
    assert bool(db.alive.all())
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 1)
    assert db.repair()["mode"] == "incremental"     # a world of one repairs


def test_adopted_degraded_state_gets_conservative_ledger():
    """A session adopting a state with dead edges opens a ``[dead, -1]``
    record: its first repair after recovery covers every entry."""
    pair = Pair()
    pair.both("fail_edges", 3)
    pair.ingest(_fleet(41), 2)
    jdb2 = JaxDB(pair.jcfg, pair.j.state, pair.j.alive, jax.random.key(0))
    tdb2 = AerialDB(pair.tcfg, pair.t.state, pair.t.alive, device="cpu")
    assert tdb2.ledger() == jdb2.ledger()
    assert tdb2.ledger()["open_outages"] == [([3], -1)]
    pair.j, pair.t = jdb2, tdb2
    pair.both("recover_edges", 3, repair=False)
    info = pair.repair_against_full()
    assert info["shards_swept"] > 0


def test_ledger_merges_double_fails_and_skips_alive_recovers():
    """Failing a dead edge keeps its first record and opens none; recovering
    an alive edge closes nothing and runs no repair; the ledgers and key
    sequences stay the reference's through fail, recover and repair."""
    pair = Pair()
    fleet = _fleet(43)
    pair.ingest(fleet, 1)
    pair.both("fail_edges", [2, 4])
    pair.ingest(fleet, 1)
    snap = pair.t.ledger()
    pair.both("fail_edges", 2)                     # already dead: no-op
    pair.both("fail_edges", [4, 2])
    assert pair.t.ledger() == snap == pair.j.ledger()
    pair.both("fail_edges", [2, 6])                # only 6 is new
    assert pair.t.ledger()["open_outages"] == [([2, 4], 1), ([6], 2)]
    pair.both("recover_edges", 0)                  # alive: nothing at all
    assert pair.t.last_repair is None and pair.j.last_repair is None
    assert pair.t.ledger() == pair.j.ledger()
    pair.both("recover_edges", [2, 6], repair=False)
    assert pair.t.ledger()["closed_windows"] == [([2], 1, 2), ([6], 2, 2)]
    pair.check()
    pair.both("recover_edges", 4)
    assert pair.t.last_repair == pair.j.last_repair
    pair.check()
    np.testing.assert_array_equal(convert.key_to_numpy(pair.t._key),
                                  np.asarray(jax.random.key_data(pair.j._key)))


def test_drop_watch_reads_nothing_until_it_drains():
    """Each insert's drop counts stay on the watch unread; the backlog
    drains past ``_DROP_WATCH_MAX`` records, at ``ledger()`` and at repair,
    and the dropped sids then equal the reference's."""
    kw = dict(index_capacity=24, retention_every=1 << 20)
    pair = Pair(**kw)
    fleet = DroneFleet(12, records_per_shard=8, seed=47)
    payloads, metas = fleet.next_rounds(3)
    pair.both("ingest_rounds", payloads, metas)
    assert len(pair.t._drop_watch) == 1 and not pair.t._dropped_sids
    assert pair.t._drop_watch[0][2].shape == (3, E)
    limit = AerialDB._DROP_WATCH_MAX
    pair.ingest(fleet, limit)                       # one past the bound
    assert len(pair.t._drop_watch) == 0
    assert pair.t._dropped_sids == pair.j._dropped_sids != set()
    pair.ingest(fleet, 2)
    assert len(pair.t._drop_watch) == 2
    assert pair.t.ledger() == pair.j.ledger() and not pair.t._drop_watch
    pair.both("repair")
    pair.check()


def test_drop_watch_keeps_its_own_copy_of_tensor_sids():
    """Sids passed as tensors are copied onto the watch: a caller that
    refills its meta buffers in place before the watch drains does not
    change the dropped sids, which equal the reference's."""
    kw = dict(index_capacity=24, retention_every=1 << 20)
    pair = Pair(**kw)
    payloads, metas = DroneFleet(12, records_per_shard=8, seed=67).next_rounds(6)
    pair.j.ingest_rounds(payloads, metas)
    buf = type(metas)(*(torch.from_numpy(np.array(f)) for f in metas))
    pair.t.ingest_rounds(payloads, buf)
    for f in buf:
        f.fill_(-7)
    assert pair.t.ledger() == pair.j.ledger()
    assert pair.t._dropped_sids == pair.j._dropped_sids != set()


def test_repair_state_updates_in_place_and_clone_keeps_the_pre_state():
    pair = Pair()
    fleet = _fleet(53)
    pair.ingest(fleet, 1)
    pair.both("fail_device", 2)
    pair.ingest(fleet, 2)
    pair.both("recover_device", 2, repair=False)
    state = pair.t.state
    pre = tds.clone_state(state)
    out, info = trepair.repair_state(pair.tcfg, state, pair.t.alive,
                                     outage=pair.t._outage_log())
    assert out is state and info["shards_replaced"] > 0
    assert out.tup_f.data_ptr() != pre.tup_f.data_ptr()
    assert not torch.equal(state.tup_sid, pre.tup_sid)
    jout, jinfo = jrepair.repair_state(pair.jcfg, pair.j.state, pair.j.alive,
                                       outage=pair.j._outage_log())
    assert info == jinfo
    _assert_states_identical(state, jout)
    timings = {}
    again, _ = trepair.repair_state(pair.tcfg, pre, pair.t.alive,
                                    outage=pair.t._outage_log(), timings=timings)
    _assert_states_identical(again, state)
    assert set(timings) == {"d2h_s", "placement_s", "sweep_s", "h2d_s", "swept"}
    assert timings["swept"] == info["shards_swept"]
