"""Federated quickstart: the same AerialDB deployment on a 4-block edge mesh
(port of ``examples/federated_quickstart.py``).

Each block of the one-process edge mesh (``make_edge_mesh(4)``, every block
on the one device) plays two of the eight ground edge servers. Both
deployments are driven through the ``repro_torch.api`` facade —
``AerialDB.open`` with a mesh splits the state into the blocks and routes
every operation through the federated runtime; without one it runs the
single-store path — and, the point of the exercise, the results are
identical.

    python -m repro_torch.examples.federated_quickstart [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.api import AerialDB, Query, StoreConfig
from repro_torch.core import threefry
from repro_torch.data.synthetic import CityConfig, DroneFleet, make_sites
from repro_torch.device import resolve_device
from repro_torch.examples._common import launch_counts, launches_since, run_cli
from repro_torch.launch.mesh import make_edge_mesh
from repro_torch.tree import tree_leaves


def main(device="cuda", log=print) -> dict:
    """Run both deployments; returns what it prints (counts, means, edges
    queried, ``state_equal``) and the kernels' launches."""
    dev = resolve_device(device)
    before = launch_counts()
    n_edges, n_dev = 8, 4
    mesh = make_edge_mesh(n_dev, device=dev)
    log(f"edge mesh: {n_dev} devices x {n_edges // n_dev} edges each "
        f"({mesh.size} blocks on {dev})")

    sites = make_sites(n_edges, CityConfig(), seed=3)
    cfg = StoreConfig(n_edges=n_edges, sites=tuple(map(tuple, sites.tolist())),
                      tuple_capacity=1 << 13, index_capacity=1024,
                      max_shards_per_query=64, records_per_shard=30)

    # --- one facade per runtime: the dispatch is the ONLY difference ---
    fed = AerialDB.open(cfg, mesh=mesh)
    ref = AerialDB.open(cfg, device=dev)

    # --- ingest: 16 drones x 4 rounds, one call each ---
    payloads, metas = DroneFleet(16, records_per_shard=30).next_rounds(4)
    fed.ingest_rounds(payloads, metas)
    ref.ingest_rounds(payloads, metas)
    per_edge = fed.state.tup_count.cpu().numpy()
    log(f"ingested {per_edge.sum()} tuple replicas across the mesh "
        f"(per-edge min={per_edge.min()} max={per_edge.max()})")

    # --- differential check: the same built queries, both runtimes ---
    queries = Query.batch(
        Query().bbox(12.90, 13.00, 77.50, 77.60).time(0.0, 300.0)
               .agg("count", "mean"),
        Query().bbox(12.85, 13.10, 77.45, 77.75).time(0.0, 1e9)
               .agg("count", "mean"),
        device=fed.device)
    key = threefry.key(0)
    fed_res, fed_info = fed.query(queries, key=key)
    ref_res, _ = ref.query(queries, key=key)

    fed_count, ref_count = fed_res.count.cpu().numpy(), ref_res.count.cpu().numpy()
    fed_mean = fed_res.vmean.cpu().numpy()
    edges = fed_info.subquery_edges.cpu().numpy()
    for i in range(2):
        log(f"query {i}: sharded count={int(fed_count[i])} "
            f"mean={float(fed_mean[i]):.2f} "
            f"(single-device {int(ref_count[i])}), "
            f"edges_queried={int(edges[i])}")
    np.testing.assert_array_equal(fed_count, ref_count)
    state_equal = all(
        np.array_equal(a.cpu().numpy(), b.cpu().numpy())
        for a, b in zip(tree_leaves(ref.state), tree_leaves(fed.state)))
    log(f"sharded == single-device: results exact, state identical="
        f"{state_equal}")
    return {"replicas": int(per_edge.sum()),
            "balance": (int(per_edge.min()), int(per_edge.max())),
            "count": fed_count.tolist(), "vmean": fed_mean.tolist(),
            "single_count": ref_count.tolist(), "edges_queried": edges.tolist(),
            "state_equal": state_equal, "launches": launches_since(before)}


if __name__ == "__main__":
    run_cli(main, __doc__)
