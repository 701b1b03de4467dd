"""Fleet partitions of ``repro_torch`` held against the JAX package: the port
of ``tests/test_partition.py``, case by case, with one JAX session and one
port session on the CPU driven in lockstep (``test_torch_repair``'s ``Pair``
and its bucketed reference placement, since a heal repairs).

Policy as ``tests/test_torch_repair.py``: every StoreState / IndexState leaf
bitwise, QueryResult count/min/max and QueryInfo bitwise (vsum/vmean to rtol
1e-5), ``ledger()``, the repair telemetry, the masks and
``canonical_content`` equal.

Ported: the seven single-device cases, the ledger semantics of the two
mesh-parametrised cases (double fail merges into its first epoch, a
recovery of an alive edge is a no-op) on one device and on both of the
reference's mesh layouts, and ``test_partition_differential_mesh`` on both
beside the port's single store: ``Pair(mesh="edge4")``, the JAX package's
4-device ``(4,) ("edge",)`` mesh and the port's one-process mesh, and
``Pair(mesh="fleet2x2")``, both packages' ``(2, 2) ("fleet", "edge")``
mesh.
"""

import jax
import numpy as np
import pytest
import torch

from repro.chaos import audit as jaudit
from repro.core import datastore as jds
from repro.core import repair as jrepair
from repro_torch import convert
from repro_torch.chaos import audit as taudit
from repro_torch.core import datastore as tds
from repro_torch.core import repair as trepair
from repro_torch.core.placement import ShardMeta
from repro_torch.data.synthetic import DroneFleet
from repro_torch.api.session import AerialDB
from test_torch_repair import (E, Pair, _assert_query_equal,
                               _assert_states_identical,
                               bucketed_reference_placement)  # noqa: F401


def _fleet(seed):
    return DroneFleet(12, records_per_shard=8, seed=seed)


def _tkey(k):
    return convert.key_from_numpy(jax.random.key_data(k))


def _check_masks(pair):
    for name in ("alive", "reachable", "effective_alive"):
        np.testing.assert_array_equal(getattr(pair.t, name).numpy(),
                                      np.asarray(getattr(pair.j, name)),
                                      err_msg=name)


def _edge_rows(state, edges):
    """Every per-edge leaf's rows for ``edges`` (copies)."""
    out = {f"index.{f}": getattr(state.index, f)[edges].clone()
           for f in state.index._fields}
    for f in ("tup_f", "tup_sid", "tup_count", "tup_pos", "tup_overwritten",
              "tup_dropped"):
        out[f] = getattr(state, f)[edges].clone()
    return out


def _assert_rows_equal(got, want):
    for name, w in want.items():
        g = got[name]
        if w.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), name


def _query_both(pair, key, **pred):
    jres, jinfo = pair.j.query(jds.make_pred(**pred), key=jax.random.key(key))
    tres, tinfo = pair.t.query(tds.make_pred(**pred, device="cpu"),
                               key=_tkey(jax.random.key(key)))
    _assert_query_equal(tres, tinfo, jres, jinfo)
    return tres, tinfo


def _repair_against_full_effective(pair, msg=""):
    """Each package's full sweep from its current pre-state under the
    EFFECTIVE mask (the port's on a clone), then each session's incremental
    repair: the port equal to JAX, and the incremental equal to the full."""
    jfull = jrepair.repair_state(pair.jcfg, pair.j.state,
                                 pair.j.effective_alive, outage=None)
    tfull = trepair.repair_state(pair.tcfg, tds.clone_state(pair.t.state),
                                 pair.t.effective_alive, outage=None)
    assert tfull[1] == jfull[1], msg
    _assert_states_identical(tfull[0], jfull[0], msg + "full sweep: ")
    jinfo, tinfo = pair.both("repair")
    assert tinfo == jinfo, msg
    assert tinfo["mode"] == "incremental"
    assert tinfo["shards_swept"] <= tfull[1]["shards_swept"]
    _assert_states_identical(pair.t.state, tfull[0], msg + "inc vs full: ")
    pair.check(msg)
    _check_masks(pair)
    return tinfo


# ---------------------------------------------------------------------------
# partition semantics: re-route, degrade, frozen far side
# ---------------------------------------------------------------------------


def test_partition_reroutes_inserts_and_freezes_far_side():
    """Inserts during a split land only on reachable edges; every per-edge
    leaf of the far side is bitwise frozen (retention sweeps included:
    ``retention_every`` is 2 and two rounds are ingested)."""
    pair = Pair()
    fleet = _fleet(5)
    pair.ingest(fleet, 2)
    far = [4, 5, 6, 7]
    frozen = _edge_rows(pair.t.state, far)
    pair.both("partition", [[0, 1, 2, 3], far])
    np.testing.assert_array_equal(pair.t.effective_alive.numpy(),
                                  [1, 1, 1, 1, 0, 0, 0, 0])
    np.testing.assert_array_equal(pair.t.alive.numpy(), True)     # not dead
    _check_masks(pair)
    pair.ingest(fleet, 2)
    _assert_rows_equal(_edge_rows(pair.t.state, far), frozen)
    ent_i = pair.t.state.index.ent_i.numpy()
    valid = pair.t.state.index.valid.numpy()
    ent_step = pair.t.state.index.ent_step.numpy()
    mid_split = 0
    for v, c in zip(*np.nonzero(valid)):
        if ent_step[v, c] > 2:                         # written mid-split
            reps = {int(r) for r in ent_i[v, c, 2:5] if r >= 0}
            assert reps <= {0, 1, 2, 3}, (v, c, reps)
            mid_split += 1
    assert mid_split > 0
    pair.check()


def test_partition_degrades_queries_and_heal_restores():
    """A shard whose whole replica set is cut off (its index entry on a
    reachable slice owner): its sid query reports the loss through the
    degraded accounting — count 0, bound 0, three replicas lost — and the
    heal restores it with no repair work (the far side never died)."""
    pair = Pair(records_per_shard=12)
    rng = np.random.default_rng(24)
    r = 12
    t = np.linspace(0.0, 1100.0, r, dtype=np.float32)
    lat = np.linspace(12.90, 13.00, r, dtype=np.float32)
    lon = np.linspace(77.50, 77.62, r, dtype=np.float32)
    payload = np.concatenate(
        [t[:, None], lat[:, None], lon[:, None],
         rng.normal(size=(r, 4)).astype(np.float32)], axis=1)[None]
    meta = ShardMeta(
        sid_hi=np.asarray([77], np.int32), sid_lo=np.asarray([9], np.int32),
        lat0=lat.min(keepdims=True), lat1=lat.max(keepdims=True),
        lon0=lon.min(keepdims=True), lon1=lon.max(keepdims=True),
        t0=t.min(keepdims=True), t1=t.max(keepdims=True))
    jinfo, tinfo = pair.both("insert", payload, meta)
    reps = sorted({int(x) for x in tinfo["replicas"].numpy()[0]})
    assert reps == sorted({int(x) for x in np.asarray(jinfo["replicas"])[0]})
    holders = set(np.nonzero(
        tinfo["index_writes_per_edge"].numpy() > 0)[0].tolist())
    assert holders - set(reps), (holders, reps)
    keep = [e for e in range(E) if e not in reps]
    pair.both("partition", [keep, reps])
    sid = dict(q=1, sid_hi=77, sid_lo=9, has_sid=True)
    res, qi = _query_both(pair, 1, **sid)
    assert int(res.count[0]) == 0
    assert float(qi.completeness_bound[0]) == 0.0
    assert int(qi.replicas_lost[0]) == 3
    pair.both("heal")
    assert pair.t.last_repair == pair.j.last_repair
    assert pair.t.last_repair["shards_replaced"] == 0
    res, qi = _query_both(pair, 2, **sid)
    assert int(res.count[0]) == r
    assert float(qi.completeness_bound[0]) == 1.0
    assert int(qi.replicas_lost[0]) == 0
    pair.check()


def _raise_both(pair, name, *args):
    """Both packages raise the same ValueError message; returns it."""
    msgs = []
    for db in (pair.j, pair.t):
        with pytest.raises(ValueError) as err:
            getattr(db, name)(*args)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    return msgs[1]


def test_partition_validation_and_ledger():
    pair = Pair()
    assert "separates nothing" in _raise_both(pair, "partition", [list(range(E))])
    assert "no reachable" in _raise_both(pair, "partition",
                                         [[], [0, 1, 2, 3, 4, 5, 6, 7]])
    assert "disjoint" in _raise_both(pair, "partition", [[0, 1], [1, 2]])
    assert "at least one edge group" in _raise_both(pair, "partition", [])
    with pytest.raises(ValueError, match="out of range"):
        pair.t.partition([[0], [E]])
    pair.both("partition", [0, 1, 2])          # flat list = coordinator group
    np.testing.assert_array_equal(pair.t.reachable.numpy(),
                                  [1, 1, 1, 0, 0, 0, 0, 0])
    _check_masks(pair)
    assert pair.t.ledger()["partition"] == {"unreachable": [3, 4, 5, 6, 7],
                                            "step": 0}
    pair.check()
    assert "already open" in _raise_both(pair, "partition", [[0], [1]])
    pair.both("heal", repair=False)
    assert pair.t.ledger()["partition"] is None
    assert pair.t.ledger()["closed_windows"] == [([3, 4, 5, 6, 7], 0, 0)]
    assert bool(pair.t.reachable.all())
    assert pair.t.effective_alive is pair.t.alive
    pair.check()
    before = pair.t.ledger()
    pair.both("heal")                          # double heal: no-op, no repair
    assert pair.t.last_repair is None and pair.j.last_repair is None
    assert pair.t.ledger() == before
    pair.check()


def test_heal_without_ingest_is_bitwise_noop():
    """Nothing ingested while split: the heal's incremental repair sweeps
    nothing and the state is bitwise unchanged."""
    pair = Pair()
    pair.ingest(_fleet(11), 2)
    before = tds.clone_state(pair.t.state)
    pair.both("partition", [[0, 1], [2, 3], [4, 5, 6, 7]])
    assert pair.t.ledger()["partition"]["unreachable"] == [2, 3, 4, 5, 6, 7]
    pair.both("heal")
    assert pair.t.last_repair == pair.j.last_repair
    assert pair.t.last_repair["shards_swept"] == 0
    _assert_states_identical(pair.t.state, before)
    pair.check()


# ---------------------------------------------------------------------------
# the heal's incremental repair == full sweep, O(partition), convergence
# ---------------------------------------------------------------------------


def test_heal_incremental_repair_matches_full_sweep():
    """Both repair points — mid-split (degraded mask) and after the heal —
    land bitwise on the full sweep's state from the same pre-state under
    the same effective mask, on both packages."""
    pair = Pair()
    fleet = _fleet(13)
    pair.ingest(fleet, 2)
    pair.both("partition", [[0, 1, 2, 3, 4], [5, 6, 7]])
    pair.ingest(fleet, 2)
    _repair_against_full_effective(pair, "mid-partition: ")
    assert pair.t.ledger()["pending_sids"] > 0
    pair.ingest(fleet, 1)
    pair.both("heal", repair=False)
    pair.check("healed, deferred: ")
    _repair_against_full_effective(pair, "post-heal: ")
    assert pair.t.ledger()["pending_sids"] == 0


def test_heal_sweeps_partition_not_store():
    """A brief split in a long-lived store: the heal sweeps the shards
    ingested during the split, not everything tracked."""
    pair = Pair()
    fleet = _fleet(17)
    pair.ingest(fleet, 8)
    pair.both("partition", [[0, 1, 2, 3], [4, 5, 6, 7]])
    pair.ingest(fleet, 1)
    pair.both("heal")
    rep = pair.t.last_repair
    assert rep == pair.j.last_repair
    assert rep["shards_swept"] == 12                    # one round of 12
    assert rep["shards_tracked"] >= 3 * rep["shards_swept"], rep
    assert rep["entries_reclaimed"] > 0
    pair.check()


def test_partition_heal_converges_to_never_faulted_content():
    """After the heal and the final recovery the store holds the canonical
    content of a never-split twin fed the same stream, with a death
    composed on the reachable side mid-split (a pending re-sweep debt in
    between), on both packages; rings large enough that nothing wraps."""
    split, ref = Pair(tuple_capacity=2048), Pair(tuple_capacity=2048)
    fleets = [_fleet(19) for _ in range(2)]
    for pair, f in zip((split, ref), fleets):
        pair.ingest(f, 2)
    split.both("partition", [[0, 1, 2, 3], [4, 5, 6, 7]])
    split.ingest(fleets[0], 1)
    ref.ingest(fleets[1], 1)
    split.both("fail_edges", 1)
    split.ingest(fleets[0], 1)
    ref.ingest(fleets[1], 1)
    split.both("heal")                         # edge 1 still dead: degraded
    assert split.t.last_repair == split.j.last_repair
    assert split.t.ledger()["pending_sids"] > 0
    split.check()
    split.both("recover_edges", 1)             # final repair: all effective
    assert split.t.ledger()["pending_sids"] == 0
    split.check()
    got, want = taudit.canonical_content(split.t), jaudit.canonical_content(split.j)
    taudit.assert_content_equal(got, want)
    assert got["index"] == want["index"]
    taudit.assert_content_equal(got, taudit.canonical_content(ref.t))
    assert split.total_count() == ref.total_count()


def test_mid_partition_repair_leaves_swept_sids_pending():
    """``repair()`` clears the pending set only when every edge is alive AND
    reachable: a repair mid-split (no edge dead) keeps its swept sids
    pending, and a heal without repair leaves them on the ledger, as JAX
    does."""
    pair = Pair()
    fleet = _fleet(43)
    pair.ingest(fleet, 2)
    pair.both("partition", [[0, 1, 2, 3, 4, 5], [6, 7]])
    pair.ingest(fleet, 2)
    jinfo, tinfo = pair.both("repair")
    assert tinfo == jinfo and tinfo["shards_swept"] > 0
    assert bool(pair.t.alive.all())
    pair.both("heal", repair=False)
    led = pair.t.ledger()
    assert led == pair.j.ledger()
    assert led["pending_sids"] == pair.j.ledger()["pending_sids"] > 0
    _repair_against_full_effective(pair, "after the deferred heal: ")
    assert pair.t.ledger()["pending_sids"] == 0


def test_mid_partition_outage_log_names_unreachable_edges():
    """An open split's unreachable edges ride ``affected_edges`` beside the
    still-dead ones, and its window closes onto the ledger at the heal."""
    pair = Pair()
    pair.ingest(_fleet(47), 1)
    pair.both("fail_edges", 1)
    pair.both("partition", [[0, 1, 2, 3, 4, 5], [6, 7]])
    pair.ingest(_fleet(48), 1)
    assert pair.t._outage_log() == pair.j._outage_log()
    assert pair.t._outage_log().affected_edges == (1, 6, 7)
    pair.both("heal", repair=False)
    assert pair.t._outage_log() == pair.j._outage_log()
    assert pair.t._outage_log().affected_edges == (1,)
    assert pair.t.ledger()["closed_windows"] == [([6, 7], 1, 2)]
    pair.check()


# ---------------------------------------------------------------------------
# ledger edge cases (the reference runs them on meshes; here on one device)
# ---------------------------------------------------------------------------


def test_double_fail_merges_into_original_epoch():
    """Failing a dead edge keeps it under the record its first failure
    opened; a call whose every id is dead is a no-op; both recover with a
    repair whose content is self-consistent."""
    _double_fail_case(Pair())


@pytest.mark.parametrize("mesh", ["edge4", "fleet2x2"])
def test_double_fail_merges_into_original_epoch_mesh(mesh):
    """The same ledger case on both mesh layouts, as the reference runs
    it."""
    _double_fail_case(Pair(mesh=mesh))


def _double_fail_case(pair):
    fleet = _fleet(29)
    pair.both("fail_edges", 2)
    step0 = pair.t.ledger()["open_outages"][0][1]
    pair.ingest(fleet, 1)
    pair.both("fail_edges", 2, 5)
    led = pair.t.ledger()
    assert led["open_outages"] == [([2], step0), ([5], 1)]
    pair.check()
    before = tds.clone_state(pair.t.state)
    pair.both("fail_edges", 2, 5)
    assert pair.t.ledger() == led
    _assert_states_identical(pair.t.state, before)
    pair.both("recover_edges", 2, 5)
    assert pair.t.last_repair == pair.j.last_repair
    assert pair.t.ledger()["open_outages"] == []
    pair.check()
    taudit.assert_content_equal(taudit.canonical_content(pair.t),
                                jaudit.canonical_content(pair.j))


def test_recover_alive_edge_is_bitwise_noop():
    """Recovering an alive edge closes nothing and repairs nothing, and
    leaves a window deferred by an earlier ``repair=False`` recovery for the
    explicit repair."""
    _recover_alive_case(Pair())


@pytest.mark.parametrize("mesh", ["edge4", "fleet2x2"])
def test_recover_alive_edge_is_bitwise_noop_mesh(mesh):
    """The same ledger case on both mesh layouts, as the reference runs
    it."""
    _recover_alive_case(Pair(mesh=mesh))


def _recover_alive_case(pair):
    fleet = _fleet(31)
    pair.ingest(fleet, 1)
    pair.both("fail_edges", 3)
    pair.ingest(fleet, 1)
    pair.both("recover_edges", 3, repair=False)
    led = pair.t.ledger()
    assert led["closed_windows"] == [([3], 1, 2)]
    before = tds.clone_state(pair.t.state)
    pair.both("recover_edges", 0)
    assert pair.t.last_repair is None and pair.j.last_repair is None
    assert pair.t.ledger() == led
    _assert_states_identical(pair.t.state, before)
    jinfo, info = pair.both("repair")
    assert info == jinfo and info["shards_swept"] > 0
    assert pair.t.ledger()["closed_windows"] == []
    pair.check()


# ---------------------------------------------------------------------------
# the partition script on both mesh layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["edge4", "fleet2x2"])
def test_partition_differential_mesh(mesh):
    """The reference's partition/heal script through the JAX mesh session,
    the port mesh session and the port single-device session: a split
    across the blocks (and, on the fleet mesh, across the fleets), rounds
    on either side of it, a query mid-split and the heal's repair keep
    every state bitwise identical, the repair telemetry and the ledgers
    equal."""
    pair = Pair(mesh=mesh)
    single = AerialDB.open(pair.tcfg, seed=0, device="cpu")
    fleet = _fleet(23)

    def step(name, *args, **kw):
        pair.both(name, *args, **kw)
        return getattr(single, name)(*args, **kw)

    for _ in range(2):
        step("insert", *fleet.next_shards())
    step("partition", [[0, 1, 2, 5], [3, 4, 6, 7]])
    for _ in range(2):
        step("insert", *fleet.next_shards())
    w = dict(q=1, t0=0.0, t1=1e9, has_temporal=True, is_and=True)
    res, qi = _query_both(pair, 3, **w)
    sres, sinfo = single.query(tds.make_pred(**w, device="cpu"),
                               key=_tkey(jax.random.key(3)))
    _assert_query_equal(sres, sinfo, res, qi)
    _check_masks(pair)
    step("heal")
    assert single.last_repair == pair.t.last_repair == pair.j.last_repair
    assert pair.t.last_repair["shards_swept"] > 0
    pair.check("post-heal: ")
    _assert_states_identical(single.state, pair.j.state, "post-heal single: ")
    assert single.ledger() == pair.j.ledger()
    total = pair.total_count()
    res, _ = single.query(tds.make_pred(**w, device="cpu"),
                          key=_tkey(jax.random.key(0)))
    assert int(res.count[0]) == total
