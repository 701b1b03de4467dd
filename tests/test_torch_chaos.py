"""The chaos engine of ``repro_torch`` held against the JAX package: the port
of ``tests/test_chaos.py``, case by case, plus the plans of both packages
compared over generated parameters and random plans applied in lockstep to
a JAX session + pipeline and a port session + pipeline on the CPU.

Policy as ``tests/test_torch_ingest_pipeline.py``: every StoreState /
IndexState leaf bitwise, the pipeline counters and every flush summary
equal (``latency_s`` by its length only: it is a wall clock), and the
runners' ``to_json()`` logs byte-identical (which also holds every logged
value to a plain Python int, str, list or None). Every heal and recovery
repairs, so the module runs the reference's repair placement jitted
(``test_torch_repair.bucketed_reference_placement``).
"""

import json

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.chaos as jchaos
from repro.api import AerialDB as JaxDB
from repro.core import datastore as jds
from repro.ingest import IngestPipeline as JaxPipeline
from repro.ingest import PipelineCrash as JaxCrash
from repro.ingest import TransientDispatchError as JaxTransient
from repro_torch import convert
from repro_torch.api.session import AerialDB
from repro_torch.chaos import (EVENT_KINDS, ChaosRunner, FaultEvent, FaultPlan,
                               assert_content_equal, canonical_content)
from repro_torch.core import datastore as tds
from repro_torch.data.synthetic import CityConfig, make_sites
from repro_torch.ingest import (IngestPipeline, PipelineCrash,
                                TransientDispatchError)
from test_torch_ingest_pipeline import _assert_summaries_equal
from test_torch_repair import (_assert_states_identical,
                               bucketed_reference_placement)  # noqa: F401

E = 8
SITES = tuple(map(tuple, make_sites(E, CityConfig(), seed=3).tolist()))
CFG_KW = dict(n_edges=E, sites=SITES, tuple_capacity=2048, index_capacity=512,
              max_shards_per_query=64, records_per_shard=8, retention_every=2,
              n_failure_domains=4)
CFG = tds.StoreConfig(**CFG_KW)
CATCH_ALL = dict(q=1, t0=0.0, t1=1e9, has_temporal=True, is_and=True)
_NOSLEEP = lambda s: None     # noqa: E731 — deterministic, instant backoff
_REPAIR_EVENTS = ("recover_edges", "recover_device", "heal")
SMOKE_PLAN = ((0, "fail_edges", ((6,),)),
              (1, "partition", (((0, 1, 2, 3, 6), (4, 5, 7)),)),
              (1, "flush_fail", (2,)),
              (2, "heal", ()),
              (3, "recover_edges", ((6,),)))


def _open(device="cpu"):
    return AerialDB.open(CFG, seed=0, device=device)


def _pipe(db, **kw):
    kw.setdefault("sleep", _NOSLEEP)
    return IngestPipeline(db, **kw)


def _tick_records(step, n_drones=12, per_drone=8, seed=0):
    """Deterministic telemetry for one tick, as the reference test makes
    it: every drone contributes one full shard of in-order records."""
    rng = np.random.default_rng((seed, step))
    n = n_drones * per_drone
    drone = np.repeat(np.arange(n_drones, dtype=np.int64), per_drone)
    seq = np.tile(np.arange(per_drone, dtype=np.int64), n_drones) \
        + step * per_drone
    t = seq.astype(np.float64) + step * 0.25
    lat = rng.uniform(12.90, 13.00, n)
    lon = rng.uniform(77.50, 77.62, n)
    vals = rng.normal(size=(n, 4))
    return drone, seq, t, lat, lon, vals


def _feed(pipe, step, seed=0):
    pipe.submit_arrays(*_tick_records(step, seed=seed))
    return pipe.flush()


def _total_count(db):
    res, _ = db.query(tds.make_pred(**CATCH_ALL, device="cpu"))
    return int(res.count[0])


class ChaosPair:
    """A reference session + pipeline + runner and the port's, on the CPU,
    driven in lockstep; ``plan_rows`` are ``(step, kind, args)`` triples
    that build each package's own ``FaultPlan``."""

    def __init__(self, plan_rows=(), n_steps=0, pipe_kw=None, plans=None):
        pipe_kw = dict(pipe_kw or {}, sleep=_NOSLEEP)
        if plans is None:
            plans = (jchaos.FaultPlan(events=tuple(plan_rows), n_steps=n_steps),
                     FaultPlan(events=tuple(plan_rows), n_steps=n_steps))
        self.jplan, self.tplan = plans
        assert self.tplan.to_rows() == self.jplan.to_rows()
        self.jdb = JaxDB.open(jds.StoreConfig(**CFG_KW), seed=0)
        self.tdb = _open()
        self.jpipe = JaxPipeline(self.jdb, **pipe_kw)
        self.tpipe = IngestPipeline(self.tdb, **pipe_kw)
        self.jrun = jchaos.ChaosRunner(self.jplan, self.jdb, self.jpipe)
        self.trun = ChaosRunner(self.tplan, self.tdb, self.tpipe)

    def advance(self, step):
        jout, tout = self.jrun.advance(step), self.trun.advance(step)
        assert json.dumps(tout) == json.dumps(jout), step
        return tout

    def feed(self, step, seed=0):
        cols = _tick_records(step, seed=seed)
        assert self.tpipe.submit_arrays(*cols) == self.jpipe.submit_arrays(*cols)
        jout, tout = self.jpipe.flush(), self.tpipe.flush()
        _assert_summaries_equal(tout, jout)
        return tout

    def check(self, msg=""):
        _assert_states_identical(self.tdb.state, self.jdb.state, msg)
        assert self.tpipe.counters == self.jpipe.counters, msg
        assert self.tpipe.pending == self.jpipe.pending, msg
        assert self.trun.to_json() == self.jrun.to_json(), msg
        assert self.tdb.ledger() == self.jdb.ledger(), msg
        for name in ("alive", "reachable", "effective_alive"):
            np.testing.assert_array_equal(getattr(self.tdb, name).numpy(),
                                          np.asarray(getattr(self.jdb, name)),
                                          err_msg=f"{msg}{name}")

    def run(self, seed=0):
        """The whole plan as ``ChaosRunner.run`` drives it, checked after
        each step's events and after each tick."""
        for step in range(self.tplan.n_steps):
            self.advance(step)
            self.check(f"step {step} events: ")
            self.feed(step, seed)
            self.check(f"step {step} tick: ")
            assert self.tpipe.reconcile()["counters_ok"], step
        self.advance(self.tplan.n_steps)
        self.check("closing events: ")
        assert self.trun.done and self.jrun.done


def _twin(n_steps, seed=0):
    """A never-faulted port session fed the same ticks."""
    db = _open()
    pipe = _pipe(db)
    for step in range(n_steps):
        _feed(pipe, step, seed=seed)
    return db


# ---------------------------------------------------------------------------
# FaultPlan: the reference's plans, seeded determinism, well-formedness
# ---------------------------------------------------------------------------


@given(st.integers(0, 1 << 30), st.integers(4, 24), st.sampled_from([0, 2, 4]),
       st.integers(3, 8), st.integers(1, 4), st.sampled_from([False, True]),
       st.sampled_from([(), ("partition",), ("partition", "flush_fail"),
                        ("fail_edges", "heal")]),
       st.integers(2, 16))
@settings(deadline=None, max_examples=60)
def test_fault_plan_random_equals_reference(seed, n_edges, n_domains,
                                            min_alive, max_concurrent,
                                            allow_crash, require, n_steps):
    """``FaultPlan.random`` gives the reference's plan for every seed and
    parameter set (its rows, horizon and seed), or raises as it does."""
    kw = dict(n_edges=n_edges, n_steps=n_steps, n_domains=n_domains,
              min_alive=min(min_alive, n_edges - 1),
              max_concurrent=max_concurrent, allow_crash=allow_crash,
              require=require)
    try:
        want = jchaos.FaultPlan.random(seed, **kw)
    except ValueError as err:
        with pytest.raises(ValueError, match="could not generate") as got:
            FaultPlan.random(seed, **kw)
        assert str(got.value) == str(err)
        return
    got = FaultPlan.random(seed, **kw)
    assert got.to_rows() == want.to_rows()
    assert (got.n_steps, got.seed) == (want.n_steps, want.seed)
    assert got.kinds() == want.kinds()
    assert tuple(got.events) == tuple(tuple(e) for e in want.events)


def test_fault_plan_replays_from_seed():
    kw = dict(n_edges=E, n_steps=10, n_domains=4, min_alive=4,
              require=("partition", "flush_fail"))
    a = FaultPlan.random(7, **kw)
    assert a == FaultPlan.random(7, **kw)            # pure in the seed
    assert a.seed == 7
    assert {"partition", "flush_fail"} <= set(a.kinds())
    assert a != FaultPlan.random(8, **kw)
    rows = a.to_rows()
    assert json.loads(json.dumps(rows)) == rows      # machine-readable
    assert rows == jchaos.FaultPlan.random(7, **kw).to_rows()


@given(st.integers(0, 1 << 30))
@settings(deadline=None, max_examples=20)
def test_fault_plan_is_well_formed(seed):
    """Every generated plan keeps >= min_alive edges alive AND reachable at
    every point, nests no partitions, and closes every fault by the
    horizon."""
    plan = FaultPlan.random(seed, n_edges=E, n_steps=10, n_domains=4,
                            min_alive=4, allow_crash=True)
    dead, unreachable = set(), set()
    block = E // 4
    for ev in plan.events:
        assert ev.kind in EVENT_KINDS
        if ev.kind == "fail_edges":
            assert not (set(ev.args[0]) & dead)
            dead |= set(ev.args[0])
        elif ev.kind == "recover_edges":
            assert set(ev.args[0]) <= dead
            dead -= set(ev.args[0])
        elif ev.kind == "fail_device":
            dead |= set(range(ev.args[0] * block, (ev.args[0] + 1) * block))
        elif ev.kind == "recover_device":
            dead -= set(range(ev.args[0] * block, (ev.args[0] + 1) * block))
        elif ev.kind == "partition":
            assert not unreachable                   # one split at a time
            keep, cut = ev.args[0]
            assert not (set(keep) & set(cut))
            assert set(keep) | set(cut) == set(range(E))
            assert not (set(cut) & dead)             # cut from effective
            unreachable = set(cut)
        elif ev.kind == "heal":
            unreachable = set()
        elif ev.kind == "flush_fail":
            assert 1 <= ev.args[0] <= 2              # default max_transient
        assert len(set(range(E)) - dead - unreachable) >= 4, ev
    assert not dead and not unreachable              # closed by the horizon


def test_fault_plan_validation():
    with pytest.raises(ValueError, match="step-sorted"):
        FaultPlan(events=(FaultEvent(3, "heal"), FaultEvent(1, "heal")),
                  n_steps=4)
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan(events=(FaultEvent(0, "meteor_strike"),), n_steps=4)
    with pytest.raises(ValueError, match="could not generate"):
        FaultPlan.random(0, n_edges=E, n_steps=2, p_fault=0.0,
                         require=("partition",))
    assert EVENT_KINDS == jchaos.EVENT_KINDS


# ---------------------------------------------------------------------------
# ChaosRunner: deterministic application, machine-readable log
# ---------------------------------------------------------------------------


def _run_once(plan, seed=0):
    db = _open()
    pipe = _pipe(db)
    runner = ChaosRunner(plan, db, pipe)
    runner.run(lambda step: _feed(pipe, step, seed=seed))
    return db, pipe, runner


def test_runner_is_deterministic():
    """Same plan + same seeds + same workload: the two port runs' stores are
    bitwise identical and their event logs byte-identical, and both equal
    the reference's run of the same plan."""
    kw = dict(n_edges=E, n_steps=6, n_domains=4, min_alive=4,
              require=("partition", "flush_fail"))
    plan = FaultPlan.random(11, **kw)
    (db1, p1, r1), (db2, p2, r2) = _run_once(plan), _run_once(plan)
    assert r1.to_json() == r2.to_json()
    assert p1.counters == p2.counters
    _assert_states_identical(db1.state, db2.state)
    pair = ChaosPair(plans=(jchaos.FaultPlan.random(11, **kw), plan))
    pair.run()
    assert pair.trun.to_json() == r1.to_json()
    _assert_states_identical(pair.tdb.state, db1.state)


def test_runner_log_is_machine_readable():
    plan = FaultPlan.random(11, n_edges=E, n_steps=6, n_domains=4,
                            min_alive=4, require=("partition", "flush_fail"))
    _db, _pipe_, runner = _run_once(plan)
    assert runner.done
    log = json.loads(runner.to_json())
    assert [(ev["step"], ev["kind"]) for ev in log] == \
        [(e.step, e.kind) for e in plan.events]
    for ev in log:
        if ev["kind"] in _REPAIR_EVENTS:
            assert ev["repair"]["mode"] == "incremental"
            assert "ledger" in ev
        if ev["kind"] in ("fail_edges", "fail_device", "partition"):
            assert "ledger" in ev


def test_runner_log_plain_values_from_numpy_args():
    """A hand-built plan with numpy integer ids logs them as Python ints,
    and the session's ledger and repair telemetry hold only plain values:
    the log survives a JSON round trip unchanged."""
    plan = FaultPlan(events=(
        FaultEvent(np.int64(0), "fail_edges", ((np.int64(2), np.int32(5)),)),
        FaultEvent(1, "fail_device", (np.int64(3),)),
        FaultEvent(2, "recover_edges", ([np.int32(2), np.int64(5)],)),
        FaultEvent(2, "recover_device", (np.int16(3),)),
    ), n_steps=3)
    db = _open()
    pipe = _pipe(db)
    runner = ChaosRunner(plan, db, pipe)
    runner.run(lambda step: _feed(pipe, step))
    log = json.loads(runner.to_json())
    assert [ev["args"] for ev in log] == [[[2, 5]], [3], [[2, 5]], [3]]
    assert [ev["repair"]["mode"] for ev in log[2:]] == ["incremental"] * 2
    _assert_plain(runner.log)


def _assert_plain(x, path="log"):
    """Every leaf of ``x`` a Python int, str, bool or None (no numpy
    scalar, no tensor), in dicts, lists and tuples."""
    if isinstance(x, dict):
        for k, v in x.items():
            assert type(k) is str, path
            _assert_plain(v, f"{path}.{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _assert_plain(v, f"{path}[{i}]")
    else:
        assert x is None or type(x) in (int, str, bool), (path, type(x))


def test_runner_without_pipeline_rejects_ingest_faults():
    for kind, args in (("flush_fail", (1,)), ("pipeline_crash", ())):
        runner = ChaosRunner(FaultPlan(events=(FaultEvent(0, kind, args),),
                                       n_steps=2), _open())     # no pipeline
        with pytest.raises(ValueError, match="no pipeline"):
            runner.advance(0)


# ---------------------------------------------------------------------------
# Transient flush failure: retry absorbs, give-up returns to pending
# ---------------------------------------------------------------------------


def test_transient_burst_within_budget_is_bitwise_invisible():
    """A burst <= max_retries is fully absorbed by the port's retry loop
    (the runner raises the port's ``TransientDispatchError``): same
    dispatches, same sids, bitwise-identical store to a never-faulted run
    — only the retries counter differs — and equal to the reference's
    faulted run."""
    pair = ChaosPair(((1, "flush_fail", (2,)),), 3, pipe_kw={"max_retries": 4})
    db_r = _open()
    pipe_r = _pipe(db_r)
    for step in range(3):
        pair.advance(step)
        pair.feed(step)
        _feed(pipe_r, step)
        pair.check(f"step {step}: ")
    pipe_f = pair.tpipe
    assert pipe_f.counters["retries"] == 2
    assert pipe_f.counters["gave_up"] == 0
    c_f = {k: v for k, v in pipe_f.counters.items() if k != "retries"}
    c_r = {k: v for k, v in pipe_r.counters.items() if k != "retries"}
    assert c_f == c_r
    _assert_states_identical(pair.tdb.state, db_r.state)


def test_burst_hook_raises_the_ports_transient_error():
    runner = ChaosRunner(FaultPlan(events=(FaultEvent(0, "flush_fail", (1,)),),
                                   n_steps=1), _open(), _pipe(_open()))
    runner.advance(0)
    with pytest.raises(TransientDispatchError, match="0 left in burst"):
        runner.pipeline.fault_hook(runner.pipeline, 0)
    runner.pipeline.fault_hook(runner.pipeline, 1)   # the burst is spent


def test_exhausted_retry_budget_returns_chunk_to_pending():
    """Past the budget the chunk gives up: its records return to pending
    (``accepted == flushed + pending`` still holds), nothing half-lands,
    and the next healthy flush delivers them; as the reference does."""
    outs = {}
    for name, db in (("port", _open()),
                     ("jax", JaxDB.open(jds.StoreConfig(**CFG_KW), seed=0))):
        make = IngestPipeline if name == "port" else JaxPipeline
        err = TransientDispatchError if name == "port" else JaxTransient
        pipe = make(db, max_retries=1, sleep=_NOSLEEP)

        def always_fail(pipeline, attempt, err=err):
            raise err("link down")
        pipe.fault_hook = always_fail
        pipe.submit_arrays(*_tick_records(0))
        out = pipe.flush()
        assert out["flushed_records"] == 0
        # 12 full shards -> plan_chunks gives an [8, 4] split: two
        # dispatches, each burning its 1-retry budget then giving up.
        assert out["gave_up"] == 2 and out["retries"] == 2
        assert out["returned_records"] == 96 == pipe.pending
        assert int(np.asarray(db.state.tup_count).sum()) == 0   # none landed
        rec = pipe.reconcile()
        assert rec["counters_ok"], rec                   # invariant survives
        pipe.fault_hook = None                           # link back up
        out2 = pipe.flush()
        assert out2["flushed_records"] == 96
        rec = pipe.reconcile()
        assert rec["ok"], rec
        outs[name] = (db, pipe, out, out2)
    for i in (2, 3):
        _assert_summaries_equal(outs["port"][i], outs["jax"][i])
    assert outs["port"][1].counters == outs["jax"][1].counters
    _assert_states_identical(outs["port"][0].state, outs["jax"][0].state)
    assert _total_count(outs["port"][0]) == 96


# ---------------------------------------------------------------------------
# Mid-flush crash + journal replay: zero acknowledged records lost
# ---------------------------------------------------------------------------


def test_pipeline_crash_recovery_via_journal(tmp_path):
    """The chaos crash tears a flush mid-flight; a fresh session + fresh
    pipeline + ``replay_journal`` recovers every acknowledged record — the
    rebuilt store's canonical content equals the never-crashed
    reference's — and the port's torn and rebuilt stores and journal equal
    the reference package's."""
    runs = {}
    for name in ("port", "jax"):
        path = tmp_path / f"{name}.bin"
        port = name == "port"
        opener = (_open if port else
                  lambda: JaxDB.open(jds.StoreConfig(**CFG_KW), seed=0))
        make = IngestPipeline if port else JaxPipeline
        crash = PipelineCrash if port else JaxCrash
        plan = (FaultPlan if port else jchaos.FaultPlan)(
            events=((1, "pipeline_crash", ()),), n_steps=3)
        db = opener()
        pipe = make(db, journal=path, sleep=_NOSLEEP)
        runner = (ChaosRunner if port else jchaos.ChaosRunner)(plan, db, pipe)
        runner.advance(0)
        _feed(pipe, 0)
        runner.advance(1)                            # arms the crash
        accepted_pre = None
        with pytest.raises(crash):
            pipe.submit_arrays(*_tick_records(1))
            accepted_pre = pipe.counters["accepted"]
            pipe.flush()
        assert accepted_pre == 192                   # both ticks acked
        assert pipe.fault_hook is None               # one-shot
        pipe.close()

        # Process death: session + pipeline state gone. Rebuild and replay.
        db2 = opener()
        pipe2 = make(db2, journal=path, sleep=_NOSLEEP)
        rep = pipe2.replay_journal()
        assert rep["journal_records"] == rep["accepted"] == 192
        pipe2.flush(drain=True)
        rec = pipe2.reconcile()
        assert rec["ok"], rec
        assert rec["flushed_records"] == 192         # zero lost
        runs[name] = (db, pipe, db2, pipe2, runner, rep)
    port, ref = runs["port"], runs["jax"]
    _assert_states_identical(port[0].state, ref[0].state, "torn: ")
    _assert_states_identical(port[2].state, ref[2].state, "replayed: ")
    assert port[1].counters == ref[1].counters
    assert port[3].counters == ref[3].counters
    assert port[5] == ref[5]
    assert port[4].to_json() == ref[4].to_json()
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    assert_content_equal(canonical_content(port[2]),
                         canonical_content(_twin(2)),
                         msg="crash-recovered vs reference: ")


# ---------------------------------------------------------------------------
# The property: random plans converge to the never-faulted reference
# ---------------------------------------------------------------------------


@given(st.integers(0, 1 << 30))
@settings(deadline=None, max_examples=5)
def test_chaos_plan_converges_to_reference_property(seed):
    """For random seeded plans mixing edge/device loss, partitions, and
    transient flush failures: ``accepted == flushed + pending`` holds at
    every step; after the plan's closing heal/recover (+ inline repairs)
    the port store's canonical content is bit-identical to the
    never-faulted port store fed the same stream, and the full reconcile
    passes."""
    plan = FaultPlan.random(seed, n_edges=E, n_steps=6, n_domains=4,
                            min_alive=4, max_transient=2)
    db = _open()
    pipe = _pipe(db, max_retries=4)
    runner = ChaosRunner(plan, db, pipe)
    db_ref = _open()
    pipe_ref = _pipe(db_ref)

    def tick(step):
        _feed(pipe, step, seed=seed)
        _feed(pipe_ref, step, seed=seed)
        assert pipe.reconcile()["counters_ok"], (seed, step)

    runner.run(tick)
    assert pipe.counters["gave_up"] == 0             # bursts <= budget
    # wrap-free precondition for content equality (audit module docstring)
    assert int(db.state.tup_count.max()) <= CFG.tuple_capacity
    rec = pipe.reconcile()
    assert rec["ok"], (seed, rec)
    assert_content_equal(canonical_content(db), canonical_content(db_ref),
                         msg=f"seed={seed}: ")
    assert _total_count(db) == _total_count(db_ref)


@pytest.mark.parametrize("seed", [3, 11, 42, 1001, 77777])
def test_random_plan_lockstep_with_reference(seed):
    """A random plan (a partition and a flush burst required, domains on)
    applied to a JAX session + pipeline and a port session + pipeline in
    lockstep: byte-identical logs and equal counters and flush summaries,
    every state leaf bitwise after each step's events and each tick, equal
    ``canonical_content`` at the end, and that content equal to a
    never-faulted port twin's."""
    kw = dict(n_edges=E, n_steps=6, n_domains=4, min_alive=4,
              max_transient=2, require=("partition", "flush_fail"))
    pair = ChaosPair(plans=(jchaos.FaultPlan.random(seed, **kw),
                            FaultPlan.random(seed, **kw)),
                     pipe_kw={"max_retries": 4})
    pair.run(seed)
    assert pair.tpipe.counters["gave_up"] == 0
    assert pair.tpipe.reconcile()["ok"]
    got = canonical_content(pair.tdb)
    assert_content_equal(got, jchaos.canonical_content(pair.jdb),
                         msg=f"seed={seed} port vs JAX: ")
    assert_content_equal(got, canonical_content(_twin(6, seed)),
                         msg=f"seed={seed} vs twin: ")


def test_overlapping_faults_across_domain_blocks_lockstep():
    """Faults the random plans compose, placed by hand: domain 0 lost, a
    cut across the domain blocks (edges 3, 4, 6) while it is down, domain 0
    recovered inside the split (a repair under the effective mask whose
    swept shards stay pending), an edge lost and recovered inside the split,
    then the heal (which sweeps them again). Lockstep with the reference,
    and content equal to the never-faulted twin."""
    rows = ((0, "fail_device", (0,)),
            (1, "partition", (((0, 1, 2, 5, 7), (3, 4, 6)),)),
            (2, "recover_device", (0,)),
            (2, "fail_edges", ((7,),)),
            (3, "recover_edges", ((7,),)),
            (4, "heal", ()))
    pair = ChaosPair(rows, 5)
    for step in range(5):
        pair.advance(step)
        pair.check(f"step {step} events: ")
        if step == 2:
            assert pair.tdb.ledger()["pending_sids"] > 0
        pair.feed(step)
        pair.check(f"step {step} tick: ")
    pair.advance(5)
    pair.check("closing: ")
    log = json.loads(pair.trun.to_json())
    assert [e["repair"]["mode"] for e in log if e["kind"] in _REPAIR_EVENTS] \
        == ["incremental"] * 3
    assert pair.tdb.ledger()["pending_sids"] == 0
    assert_content_equal(canonical_content(pair.tdb),
                         canonical_content(_twin(5)))


def test_chaos_smoke():
    """One fixed mixed plan, end to end — deterministic log, full recovery,
    reference-equal content — in lockstep with the reference's runner."""
    pair = ChaosPair(SMOKE_PLAN, 4, pipe_kw={"max_retries": 4})
    pair.run()
    runner, pipe = pair.trun, pair.tpipe
    assert runner.done and len(runner.log) == len(pair.tplan.events)
    assert pipe.counters["retries"] == 2 and pipe.counters["gave_up"] == 0
    assert pipe.reconcile()["ok"]
    assert_content_equal(canonical_content(pair.tdb),
                         canonical_content(_twin(4)))
    assert _total_count(pair.tdb) == 4 * 96
    jres, _ = pair.jdb.query(jds.make_pred(**CATCH_ALL), key=jax.random.key(0))
    tres, _ = pair.tdb.query(tds.make_pred(**CATCH_ALL, device="cpu"),
                             key=convert.key_from_numpy(
                                 jax.random.key_data(jax.random.key(0))))
    assert int(tres.count[0]) == int(np.asarray(jres.count)[0])
