#!/usr/bin/env python3
"""Count the shards of the D400 edge-server-loss scenario on which the JAX
package's repair placement, as shipped, parts from its insert's.

    python tools/count_repair_split.py

The reference's ``repair_state`` calls ``place_replicas`` and
``_index_edge_mask`` eagerly; its insert runs them under ``jax.jit``, where
XLA multiplies by a constant's float32 reciprocal and the eager op divides
(slice cells, time buckets). On a shard at such a boundary the two name
different edges. The port follows the jitted form in both, so these are the
shards on which the port's repair differs from the reference's as shipped.

The scenario is ``chip_smoke.py``'s ``resilience`` phase: 80 edges (sites
``make_sites(80, CityConfig(), seed=3)``), 4 failure domains, replication 3,
``DroneFleet(400, records_per_shard=60, n_values=4, seed=1)`` for 48 rounds,
every edge alive (the mask of the repair after recovery). Each round's 400
shards go through both forms; the script prints, for all 48 rounds and for
rounds 25-48 (those ingested during the outage, the incremental sweep's
subset), the shards whose replicas differ, whose index masks differ, and
either. Runs on the CPU (about 20 s) and imports only the JAX package.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro.core import datastore as jds  # noqa: E402
from repro.core import placement as jplace  # noqa: E402
from repro.data.synthetic import CityConfig, DroneFleet, make_sites  # noqa: E402

ROUNDS, OUTAGE_FROM = 48, 24


def main() -> None:
    city = CityConfig()
    sites = make_sites(80, city, seed=3)
    cfg = jds.StoreConfig(n_edges=80, sites=tuple(map(tuple, sites.tolist())),
                          tuple_capacity=1 << 19, index_capacity=1 << 15,
                          max_shards_per_query=128, records_per_shard=60,
                          n_values=4, replication=3, planner="min_shards",
                          n_failure_domains=4)
    _, metas = DroneFleet(400, city, records_per_shard=60, n_values=4,
                          seed=1).next_rounds(ROUNDS)
    jit_place = jax.jit(jplace.place_replicas, static_argnums=(3, 4))
    jit_mask = jax.jit(jds._index_edge_mask, static_argnums=0)
    s, alive = cfg.sites_array(), jnp.ones(cfg.n_edges, bool)
    rep_bad, mask_bad = [], []
    for r in range(ROUNDS):
        meta = jplace.ShardMeta(*(jnp.asarray(f[r]) for f in metas))
        args = (meta, s, alive, cfg.tau, cfg.n_failure_domains)
        reps = jit_place(*args)
        rep_bad.append(np.asarray(jplace.place_replicas(*args) != reps).any(1))
        mask_bad.append(np.asarray(jds._index_edge_mask(cfg, meta, reps, s, alive)
                                   != jit_mask(cfg, meta, reps, s, alive)).any(1))
    rep_bad, mask_bad = np.stack(rep_bad), np.stack(mask_bad)

    def counts(sl):
        return {"shards": int(rep_bad[sl].size),
                "replicas_differ": int(rep_bad[sl].sum()),
                "index_mask_differs": int(mask_bad[sl].sum()),
                "either": int((rep_bad[sl] | mask_bad[sl]).sum())}
    print(json.dumps({"all_rounds": counts(slice(None)),
                      "outage_rounds": counts(slice(OUTAGE_FROM, None))}))


if __name__ == "__main__":
    main()
