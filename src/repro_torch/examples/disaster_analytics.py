"""End-to-end scenario (port of ``examples/disaster_analytics.py``; the
paper's kind is a datastore, so the end-to-end scenario is serving
spatio-temporal analytics under failures):

50 drones stream sensor shards into 20 edges while analyst clients issue
batches of 8 box-and-window queries; midway through, edges start failing.
The script reports per-round latency, completeness, and planner telemetry —
Fig 9 + Fig 14 as one live scenario.

    python -m repro_torch.examples.disaster_analytics [--device cuda|cpu]

Each round also opens an audit session over the same state with the
``random`` planner; its catch-all query reads the state and writes nothing
(the port updates state in place, so a query that wrote would show in the
next round). Times are taken after the card's queue has drained.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.api import AerialDB
from repro_torch.core import threefry
from repro_torch.core.datastore import StoreConfig, make_pred
from repro_torch.data.synthetic import CityConfig, DroneFleet, make_sites
from repro_torch.device import resolve_device
from repro_torch.examples._common import (launch_counts, launches_since,
                                          run_cli, sync)

N_EDGES, N_DRONES, ROUNDS = 20, 50, 5


def analyst_queries(anchors, rng, q=8, km=1.0, secs=1800.0, device="cuda"):
    pick = anchors[rng.integers(0, len(anchors), q)]
    deg = km / 111.0
    return make_pred(
        q=q, lat0=pick[:, 1] - deg / 2, lat1=pick[:, 1] + deg / 2,
        lon0=pick[:, 2] - deg / 2, lon1=pick[:, 2] + deg / 2,
        t0=pick[:, 0] - secs / 2, t1=pick[:, 0] + secs / 2,
        has_spatial=True, has_temporal=True, is_and=True, device=device)


def main(device="cuda", log=print) -> dict:
    """Run the mission; returns each round's printed values (rows and
    edges a query on average, completeness, edges down) and the kernels'
    launches."""
    dev = resolve_device(device)
    before = launch_counts()
    rng = np.random.default_rng(0)
    sites = make_sites(N_EDGES, CityConfig(), seed=3)
    cfg = StoreConfig(n_edges=N_EDGES, sites=tuple(map(tuple, sites.tolist())),
                      tuple_capacity=1 << 15, index_capacity=4096,
                      max_shards_per_query=256, records_per_shard=30,
                      planner="min_shards")
    db = AerialDB.open(cfg, device=dev)
    fleet = DroneFleet(N_DRONES, records_per_shard=30)

    anchors = []
    rounds = []
    total_expected = 0
    for r in range(ROUNDS):
        payload, meta = fleet.next_shards()
        sync(dev)
        t0 = time.perf_counter()
        db.insert(payload, meta)
        sync(dev)
        anchors.append(payload.reshape(-1, payload.shape[-1])[:, :3])
        total_expected += payload.shape[0] * payload.shape[1]

        # mid-mission failures: one edge dies at rounds 3 and 4 (§3.5.3)
        phase = "all-up"
        if r == 2:
            db.fail_edges(int(rng.integers(N_EDGES)))
            phase = "1 edge down"
        if r == 3:
            db.fail_edges(int(rng.integers(N_EDGES)))
            phase = "2 edges down"

        pred = analyst_queries(np.concatenate(anchors), rng, device=db.device)
        tq = time.perf_counter()
        result, qinfo = db.query(pred, key=threefry.key(r))
        sync(dev)
        tq_end = time.perf_counter()
        catch_all = make_pred(q=1, t0=0.0, t1=1e9, has_temporal=True,
                              device=db.device)
        # audit query touches every shard: use the vectorized random planner
        # (MinShards' greedy loop is for normal-sized result sets)
        audit_db = AerialDB(dataclasses.replace(cfg, planner="random"),
                            db.state, db.alive, threefry.key(100 + r),
                            device=db.device)
        full, _ = audit_db.query(catch_all)
        assert not bool(full.overflow.cpu().numpy()[0]), \
            "shard budget overflow — raise max_shards_per_query"
        completeness = int(full.count.cpu().numpy()[0]) / total_expected
        rows = float(result.count.cpu().numpy().mean())
        edges = float(qinfo.subquery_edges.cpu().numpy().mean())
        log(f"round {r} [{phase:13s}] insert={(tq - t0) * 1e3:7.1f}ms "
            f"query(8)={(tq_end - tq) * 1e3:7.1f}ms "
            f"rows={rows:7.1f} "
            f"edges/query={edges:4.1f} "
            f"completeness={completeness:.4f}")
        rounds.append({"phase": phase, "rows": rows, "edges_per_query": edges,
                       "completeness": completeness,
                       "edges_down": int(N_EDGES - db.alive.sum())})

    assert completeness == 1.0, "<=2 failures must stay exact"
    log("mission complete: exact results under 2 edge failures")
    return {"rounds": rounds, "launches": launches_since(before)}


if __name__ == "__main__":
    run_cli(main, __doc__)
