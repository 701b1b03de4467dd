"""The federated runtime of ``repro_torch`` on a one-process mesh, held
against the JAX package: the port of ``tests/test_federation.py``, case by
case, on the CPU, every mesh case on both of its layouts (the ``mesh_name``
fixture): the 1-D ``(4,) ("edge",)`` mesh and the 2-D ``(2, 2) ("fleet",
"edge")`` mesh, whose candidate merge is hierarchical and whose query
batch runs in two tiles.

Three sides take the same inserts and queries: the JAX package's
shard_map runtime on its forced 4-device CPU mesh of the layout, the
port's runtime on ``make_edge_mesh(4, device="cpu")`` or
``make_fleet_mesh(2, 2, device="cpu")`` (four blocks of two edges,
collectives in process) and the port's single store. Policy: every StoreState /
IndexState leaf (the mesh's gathered) and the insert info bitwise,
QueryResult count/min/max/overflow and every QueryInfo field bitwise,
vsum/vmean to rtol 1e-5 with NaN equal, ``latest()``, ``ledger()`` and the
repair telemetry equal. The reference's repair placement runs jitted
(``test_torch_repair``'s module fixture), as in the port's other repair
tests.

Beyond the reference's cases: the two-level candidate merge held at the
``MatchedShards`` level to the JAX package's ``_merge_matched`` on its
``(2, 2)`` mesh, and the tiled shard-local query's per-edge partials to its
``query_local(overlap_tiles=2)``. The two-process path is
``tests/test_torch_multihost.py``.

Not ported here: the Pallas kernel case (the JAX package's ``slow`` test;
the port's kernels run on the card, ``-k "federation or fleet"`` in
``tests/test_torch_kernels_cuda.py``) and ``test_store_sharding_layout``,
which reads jax shardings (its port is
``test_shard_store_blocks_own_their_storage``).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.api import AerialDB as JaxDB
from repro.api import AggSpec as JAggSpec
from repro.api import Query as JQuery
from repro.core import datastore as jds
from repro.core.placement import ShardMeta as JMeta
from repro.distributed import federation as jfed
from repro.launch.mesh import make_edge_mesh as j_make_edge_mesh
from repro.launch.mesh import make_fleet_mesh as j_make_fleet_mesh
from repro_torch import convert
from repro_torch.api import AerialDB, AggSpec, Query
from repro_torch.core import datastore as tds
from repro_torch.core.placement import ShardMeta
from repro_torch.data.synthetic import CityConfig, DroneFleet, make_sites
from repro_torch.distributed import federation as tfed
from repro_torch.distributed.sharding import (gather_store, shard_store,
                                              store_partition_specs)
from repro_torch.launch.mesh import make_edge_mesh, make_fleet_mesh
from test_torch_repair import (_assert_query_equal, _assert_states_identical,
                               _bits,
                               bucketed_reference_placement,  # noqa: F401
                               mesh_pair)

N_DEV = 4
E = 8
ROUNDS = 6
SITES = tuple(map(tuple, make_sites(E, CityConfig(), seed=3).tolist()))

pytestmark = pytest.mark.skipif(
    jax.device_count() < N_DEV,
    reason=f"needs {N_DEV} host devices (conftest forces them via XLA_FLAGS)")


def _kw(**overrides):
    kw = dict(n_edges=E, sites=SITES, tuple_capacity=2048, index_capacity=512,
              max_shards_per_query=64, records_per_shard=12,
              retention_every=2, max_drones=16)
    kw.update(overrides)
    return kw


def _cfgs(**overrides):
    kw = _kw(**overrides)
    return jds.StoreConfig(**kw), tds.StoreConfig(**kw)


def _fleet_rounds(n_drones=12, rounds=ROUNDS, seed=1):
    return DroneFleet(n_drones, records_per_shard=12, seed=seed).next_rounds(rounds)


def _tkey(seed):
    return convert.key_from_numpy(jax.random.key_data(jax.random.key(seed)))


def _tpred(**w):
    return tds.make_pred(**w, device="cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _tmeta(metas, i=None):
    return ShardMeta(*(_t(f if i is None else np.asarray(f)[i]) for f in metas))


@pytest.fixture(scope="module", params=["edge4", "fleet2x2"])
def mesh_name(request):
    """Every mesh-driven case runs on both of the reference's layouts: the
    same 4 devices (blocks), two mesh contracts, one single-store oracle."""
    return request.param


@pytest.fixture(scope="module")
def meshes(mesh_name):
    return mesh_pair(mesh_name)


@pytest.fixture(scope="module")
def jmesh(meshes):
    return meshes[0]


@pytest.fixture(scope="module")
def tmesh(meshes):
    return meshes[1]


class Sides:
    """The JAX mesh state, the port mesh's blocks and the port's single
    store, loaded with the same rounds."""

    def __init__(self, jmesh, tmesh, rounds, alive, **overrides):
        self.jcfg, self.tcfg = _cfgs(**overrides)
        self.jmesh, self.tmesh = jmesh, tmesh
        payloads, metas = rounds
        self.alive = np.asarray(alive, bool)
        ta = torch.from_numpy(self.alive)
        self.j, _ = jfed.ingest_rounds(
            self.jcfg, jfed.shard_store(jds.init_store(self.jcfg), jmesh),
            payloads, metas, jnp.asarray(self.alive), mesh=jmesh)
        self.blocks, self.binfo = tfed.ingest_rounds(
            self.tcfg, shard_store(tds.init_store(self.tcfg, "cpu"), tmesh),
            _t(payloads), _tmeta(metas), ta, tmesh, host_step=0)
        self.single, self.sinfo = tfed.ingest_rounds(
            self.tcfg, tds.init_store(self.tcfg, "cpu"), _t(payloads),
            _tmeta(metas), ta, host_step=0)

    def check_states(self):
        fed = gather_store(self.blocks)
        _assert_states_identical(fed, self.j, "port mesh vs jax mesh: ")
        _assert_states_identical(self.single, self.j, "port single vs jax mesh: ")

    def query(self, w, seed, alive=None, **cfg_overrides):
        """Every side's answer to ``make_pred(**w)`` under ``alive``, with
        the planner key made from ``seed``, held equal."""
        alive = self.alive if alive is None else np.asarray(alive, bool)
        jcfg = dataclasses.replace(self.jcfg, **cfg_overrides)
        tcfg = dataclasses.replace(self.tcfg, **cfg_overrides)
        jres, jinfo = jfed.federated_query_step(
            jcfg, self.j, jds.make_pred(**w), jnp.asarray(alive),
            jax.random.key(seed), self.jmesh)
        ta = torch.from_numpy(alive)
        mres, minfo = tfed.federated_query_step(
            tcfg, self.blocks, _tpred(**w), ta, _tkey(seed), self.tmesh)
        sres, sinfo = tds.run_query(tcfg, self.single, _tpred(**w), ta,
                                    key=_tkey(seed))
        _assert_query_equal(mres, minfo, jres, jinfo)
        _assert_query_equal(sres, sinfo, jres, jinfo)
        return mres, minfo


@pytest.fixture(scope="module")
def loaded(jmesh, tmesh):
    """One store, loaded through the three sides (queries below only read
    it)."""
    return Sides(jmesh, tmesh, _fleet_rounds(), np.ones(E, bool))


QUERY_PREDS = {
    "and_spatiotemporal": dict(
        q=3, lat0=[12.85, 12.90, 12.95], lat1=[13.10, 13.00, 13.05],
        lon0=[77.45, 77.50, 77.55], lon1=[77.75, 77.60, 77.65],
        t0=[0.0, 0.0, 60.0], t1=[1e9, 120.0, 180.0],
        has_spatial=True, has_temporal=True, is_and=True),
    "or": dict(q=2, lat0=12.9, lat1=12.95, lon0=77.5, lon1=77.6,
               t0=[0.0, 30.0], t1=[60.0, 90.0],
               has_spatial=True, has_temporal=True, is_and=False),
    "sid_point": dict(q=2, sid_hi=[3, 7], sid_lo=[1, 4], has_sid=True,
                      is_and=True),
    "catch_all_temporal": dict(q=1, t0=0.0, t1=1e9, has_temporal=True,
                               is_and=True),
}


# ---------------------------------------------------------------------------
# the step functions
# ---------------------------------------------------------------------------


def test_insert_state_identical(loaded):
    """After N rounds (retention sweeps included: retention_every=2), every
    leaf of the port mesh's gathered store and of the port's single store
    equals the JAX mesh's, bitwise; the ingest infos equal each other."""
    assert int(np.asarray(loaded.j.steps)) == ROUNDS
    assert [int(b.steps) for b in loaded.blocks] == [ROUNDS] * N_DEV
    loaded.check_states()
    for k in loaded.sinfo:
        assert torch.equal(loaded.binfo[k], loaded.sinfo[k]), k
    assert loaded.binfo["intake_per_edge"].shape == (ROUNDS, E)


def test_insert_info_identical(jmesh, tmesh):
    """Per-step info (per-edge telemetry, replicas, retention watermark) is
    identical round by round on the three sides, sweep rounds included."""
    jcfg, tcfg = _cfgs()
    payloads, metas = _fleet_rounds(rounds=4)
    alive = np.ones(E, bool)
    jstate = jfed.shard_store(jds.init_store(jcfg), jmesh)
    blocks = shard_store(tds.init_store(tcfg, "cpu"), tmesh)
    single = tds.init_store(tcfg, "cpu")
    for i in range(payloads.shape[0]):
        jmeta = JMeta(*(jnp.asarray(np.asarray(f)[i]) for f in metas))
        jstate, ji = jfed.federated_insert_step(
            jcfg, jstate, jnp.asarray(payloads[i]), jmeta, jnp.asarray(alive),
            jmesh)
        blocks, mi = tfed.federated_insert_step(
            tcfg, blocks, _t(payloads[i]), _tmeta(metas, i),
            torch.from_numpy(alive), tmesh, i)
        single, si = tds.insert_local(tcfg, single, _t(payloads[i]),
                                      _tmeta(metas, i),
                                      torch.from_numpy(alive), i)
        assert set(mi) == set(ji) == set(si)
        for k in ji:
            for got in (mi, si):
                np.testing.assert_array_equal(_bits(got[k]), _bits(ji[k]),
                                              err_msg=f"round {i}: {k}")
    _assert_states_identical(gather_store(blocks), jstate)
    _assert_states_identical(single, jstate)


@pytest.mark.parametrize("pred_name", sorted(QUERY_PREDS))
def test_query_identical(loaded, pred_name):
    loaded.query(QUERY_PREDS[pred_name], 0)


@pytest.mark.parametrize("planner", ["random", "min_edges", "min_shards"])
def test_query_identical_across_planners(loaded, planner):
    """Planning runs on every block from the global inputs: same key, same
    assignment, identical QueryInfo."""
    loaded.query(QUERY_PREDS["and_spatiotemporal"], 7, planner=planner)


def test_query_identical_with_failures(loaded):
    """Edges die after insertion: lookup fallback, planner re-routing and
    the scan stay equal on the three sides."""
    alive = np.ones(E, bool)
    alive[[1, 5]] = False
    for w in QUERY_PREDS.values():
        loaded.query(w, 11, alive=alive)


def test_query_identical_whole_device_dead(loaded):
    """A whole block's edges (block 2) die: its index matches, candidates
    and partials mask out identically, for every predicate shape."""
    alive = np.ones(E, bool)
    alive[2 * (E // N_DEV):3 * (E // N_DEV)] = False
    for w in QUERY_PREDS.values():
        loaded.query(w, 17, alive=alive)


def test_query_identical_under_overflow(loaded):
    """max_shards_per_query below the matched set: the blocks' top-S merge
    clips to exactly the single store's shard set and overflow flags."""
    res, _ = loaded.query(QUERY_PREDS["catch_all_temporal"], 3,
                          max_shards_per_query=4)
    assert bool(res.overflow.all())


def test_broadcast_baseline_identical(jmesh, tmesh):
    """No index and replication 1: the scan-all path, no candidate merge."""
    sides = Sides(jmesh, tmesh, _fleet_rounds(seed=2, rounds=3),
                  np.ones(E, bool), use_index=False, replication=1)
    sides.check_states()
    res, info = sides.query(dict(q=1, lat0=12.9, lat1=13.0, lon0=77.5,
                                 lon1=77.65, t0=0.0, t1=200.0,
                                 has_spatial=True, has_temporal=True), 4)
    assert bool(info.broadcast.all()) and int(res.count[0]) > 0


def test_fused_ingest_matches_python_loop():
    """``ingest_rounds`` (one store and the mesh) equals the loop of
    ``insert_local`` it runs, and the JAX package's fused ingest."""
    jcfg, tcfg = _cfgs()
    payloads, metas = _fleet_rounds(seed=13)
    alive = np.ones(E, bool)
    jstate, _ = jfed.ingest_rounds(jcfg, jds.init_store(jcfg), payloads, metas,
                                   jnp.asarray(alive))
    loop = tds.init_store(tcfg, "cpu")
    for i in range(ROUNDS):
        loop, _ = tds.insert_local(tcfg, loop, _t(payloads[i]),
                                   _tmeta(metas, i), torch.from_numpy(alive), i)
    fused, info = tfed.ingest_rounds(tcfg, tds.init_store(tcfg, "cpu"),
                                     _t(payloads), _tmeta(metas),
                                     torch.from_numpy(alive), host_step=0)
    _assert_states_identical(loop, jstate)
    _assert_states_identical(fused, jstate)
    assert info["intake_per_edge"].shape == (ROUNDS, E)


# ---------------------------------------------------------------------------
# the facade on a mesh
# ---------------------------------------------------------------------------

AGG_SPECS = {
    "default": {},
    "ch2_all": dict(channel=2),
    "ch1_mean": dict(channel=1, ops=("mean",)),
    "ch3_minmax": dict(channel=3, ops=("min", "max")),
    "multi_ch": dict(channels=(0, 2, 3)),
}


@pytest.fixture(scope="module")
def facades(loaded):
    """Sessions adopting the loaded stores: the JAX mesh's, the port mesh's
    blocks and the port's single store."""
    alive = loaded.alive
    return (JaxDB(loaded.jcfg, loaded.j, jnp.asarray(alive), jax.random.key(0),
                  mesh=loaded.jmesh),
            AerialDB(loaded.tcfg, loaded.blocks, alive, mesh=loaded.tmesh),
            AerialDB(loaded.tcfg, loaded.single, alive, device="cpu"))


@pytest.mark.parametrize("spec_name", sorted(AGG_SPECS))
@pytest.mark.parametrize("pred_name", sorted(QUERY_PREDS))
def test_facade_query_identical_per_aggspec(facades, spec_name, pred_name):
    jdb, mdb, sdb = facades
    w, spec = QUERY_PREDS[pred_name], AGG_SPECS[spec_name]
    jres, jinfo = jdb.query(jds.make_pred(**w), agg=JAggSpec(**spec),
                            key=jax.random.key(13))
    for db in (mdb, sdb):
        res, info = db.query(_tpred(**w), agg=AggSpec(**spec), key=_tkey(13))
        _assert_query_equal(res, info, jres, jinfo)


def test_facade_builder_query_identical(facades):
    """Builder-composed queries (AND/OR combinators, an agg channel) through
    the three sessions: one batch, identical answers."""
    jdb, mdb, sdb = facades

    def batch(q_cls, **kw):
        return q_cls.batch(
            q_cls().bbox(12.85, 13.10, 77.45, 77.75) & q_cls().time(0.0, 1e9),
            q_cls().bbox(12.9, 12.95, 77.5, 77.6) | q_cls().time(0.0, 60.0),
            q_cls().shard(3, 1).time(0.0, 1e9), **kw)
    jpred, _ = batch(JQuery)
    jres, jinfo = jdb.query((jpred, JAggSpec(channel=2, ops=("count", "mean"))),
                            key=jax.random.key(29))
    spec = AggSpec(channel=2, ops=("count", "mean"))
    for db in (mdb, sdb):
        tpred, _ = batch(Query, device="cpu")
        res, info = db.query((tpred, spec), key=_tkey(29))
        _assert_query_equal(res, info, jres, jinfo)
        assert set(res.view(spec)) == {"count", "mean", "completeness_bound",
                                       "replicas_lost"}


def test_facade_answers_equal_the_step_functions(facades, loaded):
    """The sessions' default-AggSpec answers equal ``run_query`` and
    ``federated_query_step`` on the same stores (the reference pins its
    deprecated shims the same way)."""
    _, mdb, sdb = facades
    w = QUERY_PREDS["and_spatiotemporal"]
    want = loaded.query(w, 0)
    for db in (mdb, sdb):
        res, info = db.query(_tpred(**w), key=_tkey(0))
        _assert_query_equal(res, info, *want)


class Trio:
    """A JAX mesh session, a port mesh session and a port single-device
    session, driven in lockstep."""

    def __init__(self, jmesh, tmesh, **overrides):
        self.jcfg, self.tcfg = _cfgs(**overrides)
        self.j = JaxDB.open(self.jcfg, mesh=jmesh, seed=0)
        self.m = AerialDB.open(self.tcfg, tmesh, seed=0)
        self.s = AerialDB.open(self.tcfg, device="cpu", seed=0)

    def all(self, name, *args, **kw):
        return [getattr(db, name)(*args, **kw) for db in (self.j, self.m, self.s)]

    def check(self, msg=""):
        for db in (self.m, self.s):
            _assert_states_identical(db.state, self.j.state, msg)
            assert db.ledger() == self.j.ledger(), msg
            np.testing.assert_array_equal(db.alive.numpy(),
                                          np.asarray(self.j.alive))

    def query(self, seed):
        """A catch-all count + channel-1 mean through the three sessions."""
        jres, jinfo = self.j.query(
            JQuery().time(0.0, 1e9).agg("count", "mean", channel=1),
            key=jax.random.key(seed))
        for db in (self.m, self.s):
            res, info = db.query(Query().time(0.0, 1e9).agg(
                "count", "mean", channel=1), key=_tkey(seed))
            _assert_query_equal(res, info, jres, jinfo)
        return jres, jinfo


def test_facade_ingest_and_failures_identical(jmesh, tmesh):
    """Fused ingest, edge failures, a query mid-failure, an insert while
    edges are down and the recovery's repair: states bitwise identical and
    every answer equal."""
    trio = Trio(jmesh, tmesh)
    pay, met = _fleet_rounds(seed=31, rounds=4)
    infos = trio.all("ingest_rounds", pay, met)
    for info in infos[1:]:
        for k in infos[0]:
            np.testing.assert_array_equal(_bits(info[k]), _bits(infos[0][k]),
                                          err_msg=k)
    trio.check("ingest: ")
    trio.all("fail_edges", 1, 5)
    trio.query(7)
    p, m = DroneFleet(6, records_per_shard=12, seed=8).next_shards()
    trio.all("insert", p, m)
    trio.all("recover_edges", 1, 5)
    assert trio.m.last_repair == trio.s.last_repair == trio.j.last_repair
    trio.check("recovered: ")
    trio.query(7)


def test_facade_device_failure_and_repair_identical(jmesh, tmesh):
    """A whole block fails (``fail_device``), rounds are ingested around
    it, then it returns with the incremental repair, which the mesh runs on
    the gathered store and writes back into its blocks: states bitwise
    identical, answers equal, the window complete again."""
    trio = Trio(jmesh, tmesh, n_failure_domains=N_DEV)
    fleet = DroneFleet(10, records_per_shard=12, seed=41)
    pay, met = fleet.next_rounds(2)
    trio.all("ingest_rounds", pay, met)
    trio.all("fail_device", 1)
    assert int(trio.m.alive.sum()) == E - E // N_DEV
    pay2, met2 = fleet.next_rounds(2)
    trio.all("ingest_rounds", pay2, met2)
    trio.check("outage: ")
    trio.query(19)
    trio.all("recover_device", 1)
    assert trio.m.last_repair == trio.s.last_repair == trio.j.last_repair
    assert trio.m.last_repair["shards_replaced"] > 0
    trio.check("repaired: ")
    # the replicated leaves were written back into every block
    for blk in trio.m.blocks:
        assert int(blk.steps) == 4
        assert torch.equal(blk.latest_f, trio.s.state.latest_f)
    jres, jinfo = trio.query(19)
    total = int(np.prod(pay.shape[:3])) + int(np.prod(pay2.shape[:3]))
    assert int(np.asarray(jres.count)[0]) == total
    assert float(np.asarray(jinfo.completeness_bound)[0]) == 1.0


def test_device_failure_defaults_to_the_mesh_blocks(jmesh, tmesh):
    """With ``n_failure_domains == 1`` a mesh session's failure domains are
    its blocks, as the reference's; a single store has none to address."""
    trio = Trio(jmesh, tmesh)
    trio.j.fail_device(3)
    trio.m.fail_device(3)
    np.testing.assert_array_equal(trio.m.alive.numpy(), np.asarray(trio.j.alive))
    np.testing.assert_array_equal(trio.m.alive.numpy(), np.arange(E) < 6)
    with pytest.raises(ValueError, match="no failure domains"):
        trio.s.fail_device(0)


def test_facade_latest_identical(facades, loaded):
    """``latest()`` and ``query(Query().latest())``: the replicated cache
    answers bitwise alike on the three sessions and equals a max-t oracle
    over everything inserted."""
    jdb, mdb, sdb = facades
    want = jdb.latest()
    for db in (mdb, sdb):
        for got in (db.latest(), db.query(Query().latest())):
            for f in want._fields:
                np.testing.assert_array_equal(_bits(getattr(got, f)),
                                              _bits(getattr(want, f)), err_msg=f)
    payloads, metas = _fleet_rounds()
    p = np.asarray(payloads).reshape(-1, *payloads.shape[2:])
    hi = np.asarray(metas.sid_hi).reshape(-1)
    rec, seen = mdb.latest().record.numpy(), mdb.latest().valid.numpy()
    for d in range(loaded.tcfg.max_drones):
        rows = p[hi == d].reshape(-1, p.shape[-1])
        assert seen[d] == bool(rows.size)
        if rows.size:
            np.testing.assert_array_equal(rec[d], rows[np.argmax(rows[:, 0])])


def test_facade_latest_disabled_raises(tmesh):
    for db in (AerialDB.open(tds.StoreConfig(**_kw(max_drones=0)), tmesh),
               AerialDB.open(tds.StoreConfig(**_kw(max_drones=0)),
                             device="cpu")):
        with pytest.raises(ValueError, match="max_drones"):
            db.latest()
        with pytest.raises(ValueError, match="max_drones"):
            db.query(Query().latest())


# ---------------------------------------------------------------------------
# the layout contract and the mesh's validation
# ---------------------------------------------------------------------------


def test_partition_specs_congruent_with_state():
    """``store_partition_specs`` has StoreState's structure (the nested
    IndexState included); every leaf with a leading E axis is ``"edge"``
    and the rest (the step counter, the latest cache) are replicated, as
    the reference's specs say."""
    jspecs = jfed.store_partition_specs(("edge",))
    specs = store_partition_specs()
    state = tds.init_store(tds.StoreConfig(**_kw()), "cpu")
    leaves = list(state.index) + [getattr(state, f) for f in state._fields[1:]]
    flat = list(specs.index) + [getattr(specs, f) for f in specs._fields[1:]]
    jflat = list(jspecs.index) + [getattr(jspecs, f)
                                  for f in jspecs._fields[1:]]
    names = ([f"index.{f}" for f in state.index._fields]
             + list(state._fields[1:]))
    assert len(flat) == len(leaves) == len(jflat)
    for name, spec, jspec, leaf in zip(names, flat, jflat, leaves):
        if spec == "edge":
            assert leaf.shape[0] == E and jspec == P(("edge",)), name
        else:
            assert spec is None and jspec == P(), name
            assert leaf.ndim == 0 or leaf.shape[0] == 16, name


def test_shard_store_blocks_own_their_storage(tmesh):
    """Each block holds its contiguous rows of every per-edge leaf and its
    own copy of the replicated ones, in storage no other store shares: a
    write into a block shows nowhere else, and ``gather_store`` puts the
    logical store back together (a copy too)."""
    tcfg = tds.StoreConfig(**_kw())
    pay, met = _fleet_rounds(rounds=2)
    state, _ = tfed.ingest_rounds(tcfg, tds.init_store(tcfg, "cpu"), _t(pay),
                                  _tmeta(met), torch.ones(E, dtype=torch.bool),
                                  host_step=0)
    blocks = shard_store(state, tmesh)
    assert len(blocks) == N_DEV
    for d, blk in enumerate(blocks):
        assert blk.tup_f.shape == (E // N_DEV,) + state.tup_f.shape[1:]
        assert torch.equal(blk.tup_f, state.tup_f[2 * d:2 * d + 2])
        assert torch.equal(blk.latest_f, state.latest_f)
    ptrs = [t.untyped_storage().data_ptr() for blk in blocks
            for t in list(blk.index) + list(blk[1:])]
    ptrs += [t.untyped_storage().data_ptr()
             for t in list(state.index) + list(state[1:])]
    assert len(set(ptrs)) == len(ptrs)
    back = gather_store(blocks)
    _assert_states_identical(back, state)
    before = state.tup_f.clone()
    blocks[1].tup_f.add_(1.0)
    blocks[2].steps.add_(1)
    assert torch.equal(state.tup_f, before) and torch.equal(back.tup_f, before)
    assert int(blocks[0].steps) == int(state.steps) == 2


def test_mesh_divisibility_rejected(jmesh, tmesh):
    """A mesh whose block count does not divide the edges is refused with
    the reference's message, by the step functions and the session."""
    w = QUERY_PREDS["catch_all_temporal"]
    jcfg, tcfg = _cfgs(n_edges=6, sites=())
    with pytest.raises(ValueError, match="not divisible") as jerr:
        jfed.federated_query_step(jcfg, jds.init_store(jcfg), jds.make_pred(**w),
                                  jnp.ones(6, bool), jax.random.key(0), jmesh)
    with pytest.raises(ValueError, match="not divisible") as terr:
        tfed.federated_query_step(tcfg, (tds.init_store(tcfg, "cpu"),),
                                  _tpred(**w), torch.ones(6, dtype=torch.bool),
                                  None, tmesh)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="not divisible"):
        AerialDB.open(tcfg, tmesh)


def test_mesh_factories_validate_at_construction():
    """``make_edge_mesh`` raises the shared divisibility error at
    construction, as the reference's."""
    with pytest.raises(ValueError, match="not divisible") as jerr:
        j_make_edge_mesh(N_DEV, n_edges=6)
    with pytest.raises(ValueError, match="not divisible") as terr:
        make_edge_mesh(N_DEV, n_edges=6, device="cpu")
    assert str(terr.value) == str(jerr.value)
    mesh = make_edge_mesh(N_DEV, n_edges=E, device="cpu")
    assert mesh.shape == j_make_edge_mesh(N_DEV, n_edges=E).shape == {"edge": N_DEV}
    assert mesh.axis_names == ("edge",)
    assert mesh.blocks(E) == (range(0, 2), range(2, 4), range(4, 6), range(6, 8))
    assert mesh.devices == (torch.device("cpu"),) * N_DEV
    with pytest.raises(ValueError, match="one a block"):
        make_edge_mesh(N_DEV, device=["cpu"] * 3)


def test_edge_mesh_runs_on_the_card_unless_the_cpu_is_asked():
    """The mesh and a session on it default to the card and raise without
    CUDA (no fallback to the CPU); a device that disagrees with the mesh is
    refused."""
    cfg = tds.StoreConfig(**_kw())
    if torch.cuda.is_available():
        assert make_edge_mesh(N_DEV).devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_edge_mesh(N_DEV)
        with pytest.raises(RuntimeError, match="CUDA"):
            AerialDB.open(cfg, make_edge_mesh(N_DEV, device="cpu"),
                          device="cuda")
    with pytest.raises(ValueError, match="disagrees"):
        AerialDB.open(cfg, make_edge_mesh(N_DEV, device="cpu"),
                      device=torch.device("meta"))
    db = AerialDB.open(cfg, make_edge_mesh(N_DEV, device="cpu"), device="cpu")
    assert db.device == torch.device("cpu") and len(db.blocks) == N_DEV


def test_federation_imports_neither_jax_nor_the_reference():
    """``repro_torch.distributed.federation`` and ``repro_torch.launch.mesh``,
    imported in a fresh interpreter, bring in no module of JAX or of the
    JAX package."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "src")
    code = ("import sys; import repro_torch.distributed.federation, "
            "repro_torch.launch.mesh; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(repr(bad))")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


# ---------------------------------------------------------------------------
# the 2-D fleet mesh: factory, layout, the two-level merge and the tiles
# ---------------------------------------------------------------------------


def test_fleet_mesh_factory_validates_at_construction():
    """``make_fleet_mesh`` raises the reference's errors at construction
    (divisibility of the edges by the axis product; a fleet count that does
    not divide the devices given, as three fleets over 4 devices do), and
    its shape, axes and fleet-major blocks are the reference's."""
    with pytest.raises(ValueError, match="not divisible") as jerr:
        j_make_fleet_mesh(2, N_DEV // 2, n_edges=6)
    with pytest.raises(ValueError, match="not divisible") as terr:
        make_fleet_mesh(2, N_DEV // 2, n_edges=6, device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="does not divide") as jerr:
        j_make_fleet_mesh(3)
    with pytest.raises(ValueError, match="does not divide") as terr:
        make_fleet_mesh(3, device=["cpu"] * N_DEV)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="n_edge_per_fleet is required"):
        make_fleet_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="must be >= 1"):
        make_fleet_mesh(0, 2, device="cpu")
    jm = j_make_fleet_mesh(2, n_edges=E)
    tm = make_fleet_mesh(2, n_edges=E, device=["cpu"] * N_DEV)
    assert tm.shape == dict(jm.shape) == {"fleet": 2, "edge": 2}
    assert tm.axis_names == tuple(jm.axis_names) == ("fleet", "edge")
    assert tm.size == N_DEV and not tm.multi_process
    assert tm.blocks(E) == make_edge_mesh(N_DEV, device="cpu").blocks(E)
    assert tm == make_fleet_mesh(2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_fleet_mesh(2, 2)


def test_fleet_mesh_layout_is_the_edge_mesh_of_the_axis_product():
    """The layout contract over the axis product: ``mesh_edge_axes`` names
    both axes, as the reference's does, and a store split over
    the (2, 2) mesh gives the blocks of the (4,) mesh, leaf by leaf. A
    process of a two-process world holds its fleet's blocks only, and its
    session refuses to gather a partial store."""
    from repro_torch.distributed.sharding import (mesh_edge_axes,
                                                  mesh_edge_devices)
    from repro_torch.launch.mesh import EdgeMesh
    fleet, edge = make_fleet_mesh(2, 2, device="cpu"), make_edge_mesh(
        N_DEV, device="cpu")
    jfleet = j_make_fleet_mesh(2, 2)
    assert mesh_edge_axes(fleet) == jfed.mesh_edge_axes(jfleet) == (
        "fleet", "edge")
    assert mesh_edge_devices(fleet) == jfed.mesh_edge_devices(jfleet) == 4
    tcfg = tds.StoreConfig(**_kw())
    pay, met = _fleet_rounds(rounds=2)
    state, _ = tfed.ingest_rounds(tcfg, tds.init_store(tcfg, "cpu"), _t(pay),
                                  _tmeta(met), torch.ones(E, dtype=torch.bool),
                                  host_step=0)
    for a, b in zip(shard_store(state, fleet), shard_store(state, edge)):
        _assert_states_identical(a, b)
    half = EdgeMesh(fleet.devices[:2], ("fleet", "edge"), 2, 1)
    assert half.multi_process and half.size == N_DEV
    assert half.blocks(E) == (range(4, 6), range(6, 8))
    blocks = shard_store(state, half)
    assert len(blocks) == 2 and torch.equal(blocks[1].tup_f, state.tup_f[6:8])
    db = AerialDB(tcfg, state, mesh=half)
    assert len(db.blocks) == 2
    with pytest.raises(ValueError, match="blocks"):
        db.state


def _jax_fleet_run(jcfg, jstate, jmesh, body, out_specs, *args):
    """``body(state, *args, edge_ids)`` under ``shard_map`` on the JAX mesh,
    every argument but the state replicated."""
    from jax.experimental.shard_map import shard_map
    axes = jfed.mesh_edge_axes(jmesh)
    fn = shard_map(body, mesh=jmesh,
                   in_specs=(jfed.store_partition_specs(axes),)
                   + (P(),) * len(args) + (P(axes),),
                   out_specs=out_specs, check_rep=False)
    return jax.jit(fn)(jstate, *args,
                       jnp.arange(jcfg.n_edges, dtype=jnp.int32))


@pytest.mark.parametrize("max_shards", [64, 4])
def test_candidate_merge_matches_the_reference(loaded, tmesh, max_shards):
    """The merge itself, at the ``MatchedShards`` level: each block's top-S
    candidate list and the merged lists every block plans against equal
    the JAX package's ``lookup`` and ``_merge_matched`` on its mesh of the
    same layout (on the fleet mesh: each fleet's blocks first, then the
    fleets), bitwise, replicas and overflow included; ``max_shards=4``
    clips at both levels."""
    from repro.core import index as jindex
    from repro_torch.core import index as tindex
    jcfg, tcfg, s = loaded.jcfg, loaded.tcfg, max_shards
    axes = jfed.mesh_edge_axes(loaded.jmesh)
    per_dev = jindex.MatchedShards(sid_hi=P(None, axes), sid_lo=P(None, axes),
                                   replicas=P(None, axes), valid=P(None, axes),
                                   overflow=P(axes))
    replicated = jindex.MatchedShards(*(P(),) * 5)
    alive = np.ones(E, bool)
    alive[5] = False
    # every predicate of QUERY_PREDS in one batch (queries are independent)
    names = sorted(QUERY_PREDS)
    jpreds = [jds.make_pred(**QUERY_PREDS[n]) for n in names]
    tpreds = [_tpred(**QUERY_PREDS[n]) for n in names]
    jpred = jax.tree.map(lambda *x: jnp.concatenate(x), *jpreds)
    pred = tds.QueryPred(*(torch.cat(f) for f in zip(*tpreds)))

    def body(state, pred, alive_, edge_ids):
        mask, _ = jds._lookup_sets(jcfg, pred, jcfg.sites_array(), alive_)
        local = jindex.lookup(state.index, pred,
                              jnp.take(mask, edge_ids, axis=1), s)
        return local, jfed._merge_matched(local, s, axes)
    jlocal, jmerged = _jax_fleet_run(jcfg, loaded.j, loaded.jmesh, body,
                                     (per_dev, replicated), jpred,
                                     jnp.asarray(alive))
    ta = torch.from_numpy(alive)
    mask, _ = tds._lookup_sets(tcfg, pred, tcfg.sites_array("cpu"), ta)
    parts = [tindex.lookup(blk.index, pred, mask[:, r.start:r.stop], s)
             for blk, r in zip(loaded.blocks, tmesh.blocks(E))]
    merged = tfed.make_collectives(tmesh).combine_matched(parts, s)
    for f in tindex.MatchedShards._fields:
        got = torch.cat([getattr(p, f) for p in parts],
                        dim=0 if f == "overflow" else 1)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jlocal, f)),
                                      err_msg=f"local {f}")
        np.testing.assert_array_equal(getattr(merged, f).numpy(),
                                      np.asarray(getattr(jmerged, f)),
                                      err_msg=f"merged {f}")
    assert int(merged.valid.sum()) > 0
    if s == 4:
        assert bool(merged.overflow.any())


@pytest.mark.parametrize("planner", ["random", "min_shards"])
def test_tiled_query_partials_match_the_reference(loaded, tmesh, planner):
    """The shard-local query in two tiles (3 queries: tiles of 2 and 1)
    gives, block by block, the JAX package's ``query_local(...,
    overlap_tiles=2)`` per-edge partials, OR-list lengths and metadata on
    its mesh of the same layout, and the untiled batch's: under ``random``
    the key is folded with the global query index before the tiles are
    cut."""
    jcfg = dataclasses.replace(loaded.jcfg, planner=planner)
    tcfg = dataclasses.replace(loaded.tcfg, planner=planner)
    axes = jfed.mesh_edge_axes(loaded.jmesh)
    w = QUERY_PREDS["and_spatiotemporal"]
    alive = np.ones(E, bool)
    alive[1] = False

    def body(state, pred, alive_, key_data, edge_ids):
        return jds.query_local(
            jcfg, state, pred, alive_, jax.random.wrap_key_data(key_data),
            edge_ids, collectives=jfed.make_collectives(axes),
            agg=jds.AggSpec(channels=(0, 2)), overlap_tiles=2)
    out_specs = (((P(None, axes),) + (P(None, None, axes),) * 3),
                 P(None, axes), (P(),) * 6)
    jparts, jlen, jmeta = _jax_fleet_run(
        jcfg, loaded.j, loaded.jmesh, body, out_specs, jds.make_pred(**w),
        jnp.asarray(alive), jax.random.key_data(jax.random.key(7)))
    got = {}
    for tiles in (2, 1):
        outs = tds.lockstep(
            [tds.query_body(tcfg, blk, _tpred(**w), torch.from_numpy(alive),
                            tds.AggSpec(channels=(0, 2)), _tkey(7), r, tiles)
             for blk, r in zip(loaded.blocks, tmesh.blocks(E))],
            tds.merge_tiles(tfed.make_collectives(tmesh),
                            tcfg.max_shards_per_query))
        got[tiles] = ([torch.cat([o[0][i] for o in outs], dim=-1)
                       for i in range(4)]
                      + [torch.cat([o[1] for o in outs], dim=-1)]
                      + list(outs[0][2]))
    want = list(jparts) + [jlen] + list(jmeta)
    for i, (a, b, c) in enumerate(zip(got[2], got[1], want)):
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg=f"tiled vs untiled: output {i}")
        if i == 1:      # vsum: the accumulation order differs by an ulp
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5,
                                       equal_nan=True, err_msg="vsum")
        else:
            np.testing.assert_array_equal(_bits(a), _bits(c),
                                          err_msg=f"vs the JAX mesh: output {i}")
    assert int(got[2][0].sum()) > 0


def test_fleet_mesh_equals_edge_mesh():
    """The cross-mesh differential, stated directly: the same lifecycle
    (ingest, a domain loss, ingest and a query during it, the return with
    the incremental repair, a query) on the port's (2, 2) fleet mesh and
    (4,) edge mesh gives bitwise identical states and answers, both equal
    to the JAX package's fleet mesh: the hierarchical merge and the tiles
    change the schedule, never the result."""
    jcfg, tcfg = _cfgs(n_failure_domains=N_DEV)
    jdb = JaxDB.open(jcfg, mesh=j_make_fleet_mesh(2, N_DEV // 2), seed=0)
    dbs = [AerialDB.open(tcfg, make_fleet_mesh(2, N_DEV // 2, device="cpu"),
                         seed=0),
           AerialDB.open(tcfg, make_edge_mesh(N_DEV, device="cpu"), seed=0)]
    fleet = DroneFleet(10, records_per_shard=12, seed=43)
    pay, met = fleet.next_rounds(3)
    for db in [jdb] + dbs:
        db.ingest_rounds(pay, met)
    _assert_states_identical(dbs[0].state, dbs[1].state)
    _assert_states_identical(dbs[0].state, jdb.state)

    def query(seed):
        jres, jinfo = jdb.query(
            JQuery().time(0.0, 1e9).agg("count", "mean", channel=1),
            key=jax.random.key(seed))
        for db in dbs:
            res, info = db.query(Query().time(0.0, 1e9).agg(
                "count", "mean", channel=1), key=_tkey(seed))
            _assert_query_equal(res, info, jres, jinfo)
        return jres
    for db in [jdb] + dbs:
        db.fail_device(1)
    pay2, met2 = fleet.next_rounds(1)
    for db in [jdb] + dbs:
        db.ingest_rounds(pay2, met2)
    query(23)
    for db in [jdb] + dbs:
        db.recover_device(1)
    assert dbs[0].last_repair == dbs[1].last_repair == jdb.last_repair
    _assert_states_identical(dbs[0].state, dbs[1].state)
    _assert_states_identical(dbs[0].state, jdb.state)
    res = query(23)
    assert int(np.asarray(res.count)[0]) == int(np.prod(pay.shape[:3])) \
        + int(np.prod(pay2.shape[:3]))
