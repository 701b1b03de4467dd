"""Quickstart: stand up an AerialDB deployment, ingest a drone fleet, query
it — all through the ``repro_torch.api`` facade (port of
``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cuda|cpu]

On the card every insert runs the hash64 and voronoi_assign kernels and
every query those two and st_scan; ``--device cpu`` runs their plain
versions.
"""

from __future__ import annotations

from repro_torch.api import AerialDB, Query
from repro_torch.data.synthetic import CityConfig, DroneFleet, make_sites
from repro_torch.device import resolve_device
from repro_torch.examples._common import launch_counts, launches_since, run_cli


def main(device="cuda", log=print) -> dict:
    """Run the quickstart; returns what it prints and the kernels'
    launches."""
    dev = resolve_device(device)
    before = launch_counts()
    # --- deployment: 12 edge servers over the city (paper §3.3) ---
    n_edges = 12
    sites = make_sites(n_edges, CityConfig(), seed=3)
    db = AerialDB.open(n_edges=n_edges,
                       sites=tuple(map(tuple, sites.tolist())),
                       tuple_capacity=1 << 14, index_capacity=2048,
                       max_shards_per_query=64, records_per_shard=30,
                       device=dev)

    # --- ingest: 16 drones x 4 collection rounds, one fused dispatch ---
    fleet = DroneFleet(16, records_per_shard=30)
    payloads, metas = fleet.next_rounds(4)
    db.ingest_rounds(payloads, metas)
    per_edge = db.state.tup_count.cpu().numpy()
    log(f"ingested {per_edge.sum()} tuple replicas "
        f"(balance: min={per_edge.min()} max={per_edge.max()})")

    # --- query: spatio-temporal AND predicates, one batch ---
    pred, spec = Query.batch(
        Query().bbox(12.90, 13.00, 77.50, 77.60).time(0.0, 300.0)
               .agg("count", "mean"),
        Query().bbox(12.85, 13.10, 77.45, 77.75).time(0.0, 1e9)
               .agg("count", "mean"),
        device=db.device)
    result, info = db.query((pred, spec))
    count = result.count.cpu().numpy()
    vmean = result.vmean.cpu().numpy()
    edges = info.subquery_edges.cpu().numpy()
    for i in range(2):
        log(f"query {i}: count={int(count[i])} "
            f"mean_v={float(vmean[i]):.2f} "
            f"edges_queried={int(edges[i])}")

    # --- resilience: kill two edges, same query, exact answer (§3.5.3) ---
    db.fail_edges(2, 7)
    result2, _ = db.query((pred, spec))
    count2 = result2.count.cpu().numpy()
    assert int(count2[1]) == int(count[1]), "lost data!"
    db.recover_edges(2, 7)
    log("2 edges down -> identical results (3-replica guarantee holds)")
    return {"replicas": int(per_edge.sum()),
            "balance": (int(per_edge.min()), int(per_edge.max())),
            "count": count.tolist(), "vmean": vmean.tolist(),
            "edges_queried": edges.tolist(),
            "count_2_down": count2.tolist(),
            "launches": launches_since(before)}


if __name__ == "__main__":
    run_cli(main, __doc__)
