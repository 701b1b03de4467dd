"""The port's two-process fleet runtime held against the JAX package: the
port of ``benchmarks/multihost_smoke.py``'s check, on the CPU.

``python -m repro_torch.launch.multihost_smoke --device cpu --out DIR``
runs two real ``torch.distributed`` processes over gloo, one a fleet of the
``(2, 2) ("fleet", "edge")`` mesh, at the reference smoke's size (8 edges,
10 drones, 3 rounds); each worker checks itself against a process-local
single store and writes its answers and its blocks' leaves. Here, in the
test's own process, the same scenario runs through the JAX package's
``(2, 2)`` fleet mesh on its forced 4-device CPU platform, and every
worker's blocks are held bitwise to the JAX state's rows, its answers field
by field (vsum and vmean to rtol 1e-5). Every run has a time limit: a
worker that cannot reach its peer fails within its rendezvous timeout, and
the parent kills its workers at its own.
"""

import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from repro.api import AerialDB as JaxDB
from repro.api import AggSpec as JAggSpec
from repro.api import Query as JQuery
from repro.core.datastore import StoreConfig as JConfig
from repro.core.datastore import make_pred as j_make_pred
from repro.data.synthetic import CityConfig, DroneFleet, make_sites
from repro.launch.mesh import make_fleet_mesh as j_make_fleet_mesh
from repro_torch.distributed.sharding import _flat, store_partition_specs
from repro_torch.launch.multihost_smoke import (BATCH, BATCH_CHANNELS,
                                                EDGE_PER_FLEET, FAIL_EDGES,
                                                WIDTHS)
from test_torch_repair import _bits, _leaves

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")
LIMIT_S = 120
W = WIDTHS["reference"]

pytestmark = pytest.mark.skipif(
    jax.device_count() < 4,
    reason="needs 4 host devices (conftest forces them via XLA_FLAGS)")


def _smoke(*args, timeout=LIMIT_S):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multihost_smoke", *args],
        env=env, capture_output=True, text=True, timeout=timeout)
    return proc, time.perf_counter() - t0


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    out = tmp_path_factory.mktemp("multihost")
    proc, wall = _smoke("--device", "cpu", "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    return report, out, wall


@pytest.fixture(scope="module")
def reference():
    """The smoke's scenario through the JAX package's (2, 2) fleet mesh:
    its answers by name and its (global) state at the end."""
    e = W["edges"]
    sites = make_sites(e, CityConfig(), seed=3)
    cfg = JConfig(n_edges=e, sites=tuple(map(tuple, sites.tolist())),
                  **W["cfg"])
    db = JaxDB.open(cfg, mesh=j_make_fleet_mesh(2, EDGE_PER_FLEET,
                                                n_edges=e))
    rps = cfg.records_per_shard
    answers = {}
    pay, met = DroneFleet(W["drones"], records_per_shard=rps,
                          seed=43).next_rounds(W["rounds"])
    db.ingest_rounds(pay, met)
    q = JQuery().time(0.0, 1e9).agg("count", "mean", channel=1)
    qbox = (JQuery().bbox(12.85, 13.10, 77.45, 77.75)
            & JQuery().time(0.0, 1e9)).agg("count", "min", "max", channel=2)
    answers["healthy"] = db.query(q, key=jax.random.key(7))
    answers["healthy-bbox"] = db.query(qbox, key=jax.random.key(9))
    answers["healthy-batch"] = db.query(
        (j_make_pred(**BATCH), JAggSpec(channels=BATCH_CHANNELS)),
        key=jax.random.key(17))
    db.fail_edges(*FAIL_EDGES)
    answers["degraded"] = db.query(q, key=jax.random.key(11))
    db.insert(*DroneFleet(6, records_per_shard=rps, seed=8).next_shards())
    db.recover_edges(*FAIL_EDGES, repair=False)
    answers["recovered"] = db.query(q, key=jax.random.key(13))
    return answers, dict(_leaves(db.state))


def test_two_gloo_processes_equal_the_jax_fleet_mesh(smoke, reference):
    """Each worker's blocks equal the JAX fleet mesh's rows of those
    blocks, leaf by leaf and bitwise (replicated leaves whole), and every
    answer it gave equals the JAX mesh's, field by field."""
    report, out, _ = smoke
    answers, state = reference
    per_edge = dict(zip(state, _flat(store_partition_specs())))
    e, n_blocks = W["edges"], 2 * EDGE_PER_FLEET
    seen = set()
    for p in range(2):
        got = np.load(out / f"worker{p}.npz")
        ranges = [range(a, b) for a, b in got["edge_ranges"]]
        assert ranges == [range(b * e // n_blocks, (b + 1) * e // n_blocks)
                          for b in range(2 * p, 2 * p + 2)]
        for ids in ranges:
            b = ids.start // len(ids)
            seen.add(b)
            for name, want in state.items():
                if per_edge[name]:
                    want = want[ids.start:ids.stop]
                leaf = got[f"block{b}/{name}"]
                assert leaf.shape == want.shape and leaf.dtype == want.dtype
                np.testing.assert_array_equal(
                    _bits(leaf), _bits(want), err_msg=f"worker {p} {name}")
        for what, (res, info) in answers.items():
            for f in res._fields:
                a, b = got[f"answer/{what}/{f}"], np.asarray(getattr(res, f))
                if f in ("vsum", "vmean"):
                    np.testing.assert_allclose(a, b, rtol=1e-5, equal_nan=True,
                                               err_msg=f"{what}: {f}")
                else:
                    np.testing.assert_array_equal(_bits(a), _bits(b),
                                                  err_msg=f"{what}: {f}")
            for f in info._fields:
                np.testing.assert_array_equal(
                    got[f"answer/{what}/info.{f}"],
                    np.asarray(getattr(info, f)), err_msg=f"{what}: info.{f}")
    assert seen == set(range(n_blocks))
    assert int(np.asarray(answers["recovered"][0].count)[0]) > 0


def test_two_gloo_processes_report(smoke):
    """Both workers exited 0 inside the limit, one a fleet, each checked
    its own blocks and answers against its single store, exchanged over
    gloo (the watermark on the two sweep steps, a merge a tile and one
    final combine a query: four of one tile, one of two) and imported no
    JAX."""
    report, _, wall = smoke
    assert report["multihost_smoke"] == "ok" and wall < LIMIT_S
    workers = report["workers"]
    assert [w["fleet"] for w in workers] == [0, 1]
    for w in workers:
        assert w["mesh"] == {"fleet": 2, "edge": 2}
        assert w["leaves_checked"] == 2 * 2 * 16
        assert w["answers_checked"] == 5
        assert w["gloo_exchanges"] == 2 + 4 * 2 + 3 and w["host_syncs"] == 0
    assert workers[0]["counts"] == workers[1]["counts"]


def test_two_gloo_processes_under_overflow():
    """Forty drones put more shards in the catch-all queries than
    ``max_shards_per_query`` (64) holds: both workers' answers, overflow
    flags and NaN completeness bounds included, equal their single
    stores'."""
    proc, wall = _smoke("--device", "cpu", "--drones", "40")
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert wall < LIMIT_S and report["drones"] == 40
    for w in report["workers"]:
        assert w["answers_checked"] == 5
        assert w["counts"]["healthy"] == [64 * 12]     # clipped to S shards


def test_lone_worker_fails_within_its_timeout():
    """A worker whose peer never arrives raises at its rendezvous timeout
    and exits non-zero, instead of waiting forever."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc, wall = _smoke("--child", "--device", "cpu", "--coordinator",
                        f"127.0.0.1:{port}", "--process-id", "0",
                        "--init-timeout", "5", timeout=60)
    assert proc.returncode != 0 and wall < 60
    assert "clients joined" in proc.stderr or "timed out" in proc.stderr.lower()


def test_parent_kills_its_workers_at_its_timeout():
    """The parent stops both workers at ``--timeout`` and exits non-zero."""
    proc, wall = _smoke("--device", "cpu", "--timeout", "0.5", timeout=60)
    assert proc.returncode == 1 and wall < 60
    assert "worker exit codes" in proc.stderr
