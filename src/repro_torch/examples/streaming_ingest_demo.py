"""Streaming ingest demo: ragged drone telemetry through ``IngestPipeline``
(port of ``examples/streaming_ingest_demo.py``).

A fleet of drones reports position + sensor records as they arrive — out of
order, with duplicate re-sends, seq gaps, and partial payloads. The pipeline
dedups and coalesces them into the store's shard batches, and the
O(drones) latest-per-drone hot cache answers "where is every drone right
now" without touching the log scan — including records still in flight,
via the pending overlay. The store runs on a 4-block edge mesh
(``make_edge_mesh(4)``, every block on the one device).

    python -m repro_torch.examples.streaming_ingest_demo [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.api import AerialDB, Query, StoreConfig
from repro_torch.data.synthetic import CityConfig, make_sites
from repro_torch.device import resolve_device
from repro_torch.examples._common import launch_counts, launches_since, run_cli
from repro_torch.ingest import IngestPipeline
from repro_torch.launch.mesh import make_edge_mesh

D, R, ROUNDS = 24, 4, 3       # drones, records per shard, telemetry rounds


def main(device="cuda", log=print) -> dict:
    """Run the stream; returns each round's printed counters, the latest
    reads, the reconcile audit and the kernels' launches."""
    dev = resolve_device(device)
    before = launch_counts()
    n_edges = 8
    sites = make_sites(n_edges, CityConfig(), seed=3)
    cfg = StoreConfig(n_edges=n_edges, sites=tuple(map(tuple, sites.tolist())),
                      tuple_capacity=1 << 12, index_capacity=512,
                      records_per_shard=R, max_drones=D)
    db = AerialDB.open(cfg, mesh=make_edge_mesh(4, device=dev))
    pipe = IngestPipeline(db)
    rng = np.random.default_rng(11)
    city = CityConfig()

    rounds = []
    for rnd in range(ROUNDS):
        # Every drone emits R sequenced records...
        drone = np.repeat(np.arange(D), R)
        seq = np.tile(np.arange(rnd * R, (rnd + 1) * R), D)
        n = drone.size
        t = seq + rng.uniform(0, 0.5, n)
        lat = rng.uniform(city.lat_min, city.lat_max, n)
        lon = rng.uniform(city.lon_min, city.lon_max, n)
        vals = rng.normal(size=(n, cfg.n_values))
        vals[rng.random(n) < 0.1, 2:] = np.nan       # partial payloads
        # ...but the uplink drops some, re-sends others, and shuffles all.
        idx = np.nonzero(rng.random(n) >= 0.05)[0]
        idx = np.concatenate([idx, idx[rng.random(idx.size) < 0.08]])
        rng.shuffle(idx)
        pipe.submit_arrays(drone[idx], seq[idx], t[idx], lat[idx], lon[idx],
                           vals[idx])
        fl = pipe.flush()                            # full shards -> device
        c = pipe.counters
        log(f"round {rnd}: submitted={idx.size} accepted={c['accepted']} "
            f"duplicate={c['duplicate']} partial={c['partial']} | "
            f"flushed {fl['flushed_records']} records "
            f"({fl['dispatches']} dispatches), pending={pipe.pending}")
        rounds.append({"submitted": int(idx.size), "accepted": c["accepted"],
                       "duplicate": c["duplicate"], "partial": c["partial"],
                       "flushed_records": fl["flushed_records"],
                       "dispatches": fl["dispatches"], "pending": pipe.pending})

    # Latest-per-drone: store hot cache (flushed) + pending overlay.
    record, valid = pipe.latest()
    log(f"latest(): {int(valid.sum())}/{D} drones tracked; drone 0 at "
        f"t={record[0, 0]:.2f} ({record[0, 1]:.4f}, {record[0, 2]:.4f})")
    # The same hot path through the query builder (flushed records only):
    res = db.query(Query().latest())
    queryable = int(res.valid.cpu().numpy().sum())
    log(f"Query().latest(): {queryable}/{D} drones "
        f"queryable on-device")

    pipe.flush(drain=True)                           # ship sub-shard tails
    audit = pipe.reconcile()
    assert audit["ok"], audit
    log(f"reconcile: accepted={audit['accepted']} == "
        f"flushed={audit['flushed_records']} + pending={audit['pending']}; "
        f"stored={audit['stored_tuples']} == flushed x "
        f"replication={cfg.replication}  -> ok")
    return {"rounds": rounds, "tracked": int(valid.sum()),
            "drone0": record[0, :3].tolist(), "queryable": queryable,
            "reconcile": audit, "launches": launches_since(before)}


if __name__ == "__main__":
    run_cli(main, __doc__)
