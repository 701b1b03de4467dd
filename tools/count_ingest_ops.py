#!/usr/bin/env python3
"""Count the PyTorch operations an ingest round issues, with and without the
latest-per-drone cache.

    python tools/count_ingest_ops.py

Opens two stores of the D400 deployment's width (80 edges, 400 drones a
round, 60-sample shards, 4 channels, replication 3, retention every 4th
insert) on the CPU, one with ``max_drones=0`` and one with
``max_drones=400``, and counts the operations (views excluded, as
``count_planner_ops.py`` counts them) that ``AerialDB.ingest_rounds``
dispatches over a chunk of 24 rounds, and those of one ``_update_latest``
call. On the card each such operation is about one kernel launch, so the
difference predicts the launches the cache adds; the counts are not device
measurements.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from count_planner_ops import count  # noqa: E402
from repro_torch.api.session import AerialDB  # noqa: E402
from repro_torch.core.datastore import StoreConfig, _update_latest  # noqa: E402
from repro_torch.data.synthetic import CityConfig, DroneFleet, make_sites  # noqa: E402

ROUNDS = 24


def main() -> None:
    city = CityConfig()
    sites = make_sites(80, city, seed=3)
    payloads, metas = DroneFleet(400, city, records_per_shard=60, n_values=4,
                                 seed=1).next_rounds(ROUNDS)
    counts = {}
    for d in (0, 400):
        cfg = StoreConfig(n_edges=80, sites=tuple(map(tuple, sites.tolist())),
                          tuple_capacity=1 << 15, index_capacity=1 << 12,
                          max_shards_per_query=128, records_per_shard=60,
                          n_values=4, replication=3, max_drones=d)
        db = AerialDB.open(cfg, device="cpu")
        counts[d] = count(lambda: db.ingest_rounds(payloads, metas))
        print(f"max_drones={d}: {counts[d]} ops a chunk of {ROUNDS} rounds "
              f"({counts[d] / ROUNDS:.2f} a round)")
    print(f"the cache: {counts[400] - counts[0]} ops a chunk "
          f"({(counts[400] - counts[0]) / ROUNDS:.2f} a round)")
    f, seen = torch.zeros((400, 7)), torch.full((400,), -1, dtype=torch.int32)
    one = count(lambda: _update_latest(f, seen, torch.from_numpy(payloads[0]),
                                       torch.from_numpy(metas.sid_hi[0]), 1))
    print(f"_update_latest: {one} ops a call")


if __name__ == "__main__":
    main()
