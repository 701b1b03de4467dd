#!/usr/bin/env python3
"""Count the PyTorch operations a query batch issues under each planner.

    python tools/count_planner_ops.py

Opens a store of the D400 deployment's width (80 edges, 128 shards a query,
4 channels, replication 3) on the CPU with a few rounds of a small fleet,
then counts the operations (views excluded) that one 64-query AND batch at
5 km x 7200 s over 4 channels dispatches through ``AerialDB.query`` under
``min_shards``, ``min_edges`` and ``random``, and those of the random
planner's threefry draw alone (the fold of 64 keys and the (64, 128, 3)
gumbels). On the card each such operation is about one kernel launch, so
the counts predict a batch's launches; they are not device measurements.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.api.session import AerialDB  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.datastore import AggSpec, StoreConfig, make_pred  # noqa: E402
from repro_torch.data.synthetic import (CityConfig, DroneFleet,  # noqa: E402
                                        make_query_workload, make_sites)

VIEWS = ("view", "select", "unsqueeze", "expand", "slice", "squeeze",
         "t.default", "transpose", "permute", "detach", "alias", "as_strided")


class CountOps(TorchDispatchMode):
    """Counts the operations dispatched inside the ``with`` block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not any(v in str(func) for v in VIEWS):
            self.n += 1
        return func(*args, **(kwargs or {}))


def count(fn) -> int:
    with CountOps() as c:
        fn()
    return c.n


def main() -> None:
    city = CityConfig()
    sites = make_sites(80, city, seed=3)
    cfg = StoreConfig(n_edges=80, sites=tuple(map(tuple, sites.tolist())),
                      tuple_capacity=1 << 12, index_capacity=1 << 10,
                      max_shards_per_query=128, records_per_shard=60,
                      n_values=4, replication=3)
    payloads, metas = DroneFleet(40, city, records_per_shard=60, n_values=4,
                                 seed=1).next_rounds(8)
    db = AerialDB.open(cfg, device="cpu")
    db.ingest_rounds(payloads, metas)
    w = make_query_workload(np.random.default_rng(2), 64, city,
                            float(payloads[..., 0].max()), 5.0, 7200.0)
    pred = make_pred(q=64, **w, has_spatial=True, has_temporal=True,
                     is_and=True, device="cpu")
    spec = AggSpec(channels=(0, 1, 2, 3))
    for planner in ("min_shards", "min_edges", "random"):
        sess = AerialDB(dataclasses.replace(cfg, planner=planner), db.state,
                        device="cpu")
        print(f"{planner}: {count(lambda: sess.query(pred, agg=spec))} ops a batch")
    k = threefry.split(threefry.key(1))[1]
    print("threefry draw:", count(lambda: threefry.gumbel(
        threefry.fold_in(k, torch.arange(64)), (128, 3))), "ops, of which the fold:",
        count(lambda: threefry.fold_in(k, torch.arange(64))))


if __name__ == "__main__":
    main()
