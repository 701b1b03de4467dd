"""aeriallint layer 3 of the port: the collective contract.

The counterpart of ``repro.analysis.hlo_contract``. The port has no HLO, so
the contract is checked on what the lockstep hooks of
``distributed.federation`` move between blocks, which the runtime records
in ``federation.traffic`` as (kind, dtype and shape of each tensor) per
exchange. On ``make_edge_mesh(4)`` and ``make_fleet_mesh(2, 2)``, at
``tuple_capacity`` 384 and 1024 of the canonical configuration, a session
takes 4 inserts, one 4-round ingest and a 4-query batch at 1 and at 2
channels, and:

  * **kinds**: inserts and the ingest move only the watermark gather,
    exactly once a sweep step (``retention_every``); a query moves only
    candidate merges (one level a tile on ``(4,)``, two on ``(2, 2)``: each
    fleet's blocks, then the fleets) and one final combine; a
    ``torch.distributed`` world adds ``world`` exchanges;
  * **capacity independence**: the multiset of (kind, dtype, shape) is
    identical at both capacities (the log never crosses a block);
  * **in place** (the counterpart of the reference's donation check):
    across ``ingest_rounds`` every ``StoreState`` leaf of the single store
    and of every block keeps its ``data_ptr``.

    python -m repro_torch.analysis.collective_contract --device cpu
    python -m repro_torch.analysis.collective_contract --json   # the card
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from typing import Optional, Sequence

from repro_torch.analysis.config import AeriallintConfig, load_config
from repro_torch.analysis.retrace import (_FLEET_SEED, _N_DRONES, LEGS,
                                          canonical_config, mesh_for)
from repro_torch.api import AerialDB, AggSpec
from repro_torch.core.datastore import make_pred
from repro_torch.data.synthetic import DroneFleet
from repro_torch.device import resolve_device
from repro_torch.distributed import federation as fed
from repro_torch.distributed.sharding import mesh_edge_axes

N_INSERTS = 4          # single inserts, then one ingest of as many rounds
N_QUERIES = 4          # the batch: two tiles on the fleet mesh


def leaf_ptrs(blocks) -> list:
    """(block, leaf name, data_ptr) of every StoreState leaf of the blocks."""
    out = []
    for b, st in enumerate(blocks):
        for f in st._fields:
            if f == "index":
                out += [(b, f"index.{g}", getattr(st.index, g).data_ptr())
                        for g in st.index._fields]
            else:
                out.append((b, f, getattr(st, f).data_ptr()))
    return out


def _sweeps(first: int, n: int, every: int) -> int:
    """Sweep steps among the inserts that take the store from step ``first``
    to ``first + n``."""
    return sum((s % every) == 0 for s in range(first + 1, first + n + 1))


def contract_workload(db: AerialDB, fleet: DroneFleet, pred, specs,
                      n_inserts: int = N_INSERTS) -> dict:
    """Drive a fresh session: ``n_inserts`` inserts, one ingest of as many
    rounds, then ``pred`` once for each AggSpec of ``specs``; returns each
    part's traffic (Counter), its sweep steps, the query calls and whether
    the ingest left every leaf in place (with the leaves that moved)."""
    every = db.cfg.retention_every
    out = {}
    fed.traffic.clear()
    for _ in range(n_inserts):
        db.insert(*fleet.next_shards())
    out["insert"] = Counter(fed.traffic)
    before = leaf_ptrs(db.blocks)
    fed.traffic.clear()
    db.ingest_rounds(*fleet.next_rounds(n_inserts))
    out["ingest"] = Counter(fed.traffic)
    moved = [f"block {b} {name}" for (b, name, p), (_, _, q)
             in zip(before, leaf_ptrs(db.blocks)) if p != q]
    fed.traffic.clear()
    for spec in specs:
        db.query(pred, agg=spec)
    out["query"] = Counter(fed.traffic)
    fed.traffic.clear()
    return {"traffic": out,
            "sweeps": {"insert": _sweeps(0, n_inserts, every),
                       "ingest": _sweeps(n_inserts, n_inserts, every)},
            "queries": len(specs), "moved": moved}


def _by_kind(traffic: Counter) -> Counter:
    out = Counter()
    for (kind, _), n in traffic.items():
        out[kind] += n
    return out


def check_kinds(run: dict, mesh, n_edges: int, q: int,
                cfg: AeriallintConfig, label: str) -> list:
    """Violations of the contract's kinds and counts in one ``run`` of
    ``contract_workload`` on ``mesh`` (a batch of ``q`` queries)."""
    out = []
    for part in ("insert", "ingest"):
        kinds = _by_kind(run["traffic"][part])
        bad = set(kinds) - set(cfg.insert_collectives)
        if bad:
            out.append(f"[{label}/{part}] moves {sorted(bad)}, contract "
                       f"{sorted(cfg.insert_collectives)}")
        want = run["sweeps"][part]
        if kinds["watermark"] != want:
            out.append(f"[{label}/{part}] {kinds['watermark']} watermark "
                       f"gathers for {want} sweep step(s)")
        shapes = {fields for (kind, fields) in run["traffic"][part]
                  if kind == "watermark"}
        if shapes - {(("float32", (n_edges,)),)}:
            out.append(f"[{label}/{part}] watermark gathers {shapes}, want "
                       f"one float32 ({n_edges},)")
    kinds = _by_kind(run["traffic"]["query"])
    bad = set(kinds) - set(cfg.query_collectives)
    if bad:
        out.append(f"[{label}/query] moves {sorted(bad)}, contract "
                   f"{sorted(cfg.query_collectives)}")
    two_d = len(mesh_edge_axes(mesh)) > 1
    tiles = min(2, q) if two_d else 1
    calls = run["queries"]
    want = {"merge1": calls * tiles * (mesh.n_fleet if two_d else 1),
            "merge2": calls * tiles if two_d else 0, "combine": calls}
    got = {k: kinds[k] for k in want}
    if got != want:
        out.append(f"[{label}/query] exchanges {got}, want {want} ({tiles} "
                   f"tile(s) a batch)")
    return out


def check_capacity_independence(a: dict, b: dict, label: str,
                                capacities: Sequence[int]) -> list:
    """Violations where the two capacities' runs moved different multisets."""
    out = []
    for part in ("insert", "ingest", "query"):
        if a["traffic"][part] != b["traffic"][part]:
            diff = (a["traffic"][part] - b["traffic"][part]) + \
                (b["traffic"][part] - a["traffic"][part])
            out.append(f"[{label}/{part}] traffic depends on tuple_capacity "
                       f"({capacities[0]} vs {capacities[1]}): "
                       f"{sorted(map(str, diff))[:4]}")
    return out


def check_in_place(run: dict, label: str) -> list:
    return ([f"[{label}/ingest] leaves not updated in place: "
             f"{run['moved'][:6]}"] if run["moved"] else [])


def jsonable(traffic: Counter) -> dict:
    return {f"{kind} {list(fields)}": n
            for (kind, fields), n in sorted(traffic.items())}


def run_collective_contract(device="cuda",
                            cfg: Optional[AeriallintConfig] = None) -> dict:
    """Check the contract on both meshes (and in-place ingest on the single
    store too); returns the report."""
    cfg = cfg or load_config()
    dev = resolve_device(device)
    caps = cfg.contract_capacities
    pred = make_pred(q=N_QUERIES, lat0=12.0, lat1=14.0, lon0=77.0, lon1=79.0,
                     t0=0.0, t1=1e5, has_spatial=True, has_temporal=True,
                     device=dev)
    specs = (AggSpec(channel=0), AggSpec(channels=(0, 1)))
    runs, violations = [], []
    for leg in LEGS:
        per_cap = {}
        for cap in caps:
            store_cfg = canonical_config(tuple_capacity=cap)
            mesh = mesh_for(leg, store_cfg.n_edges, dev)
            db = AerialDB.open(store_cfg, mesh=mesh, device=dev, seed=0)
            fleet = DroneFleet(_N_DRONES,
                               records_per_shard=store_cfg.records_per_shard,
                               n_values=store_cfg.n_values, seed=_FLEET_SEED)
            per_cap[cap] = contract_workload(db, fleet, pred, specs)
        base = per_cap[caps[0]]
        v = check_in_place(base, leg)
        if leg != "single":
            v += check_kinds(base, mesh, store_cfg.n_edges, N_QUERIES, cfg, leg)
            v += check_capacity_independence(base, per_cap[caps[1]], leg, caps)
        elif any(r["traffic"][p] for r in per_cap.values()
                 for p in ("insert", "ingest", "query")):
            v.append("[single] the single store recorded a cross-block "
                     "exchange")
        violations += v
        runs.append({"leg": leg, "capacities": list(caps),
                     "traffic": {p: jsonable(t)
                                 for p, t in base["traffic"].items()},
                     "sweeps": base["sweeps"], "violations": len(v)})
    return {"tool": "aeriallint.collective_contract", "device": str(dev),
            "contract": {"insert": list(cfg.insert_collectives),
                         "query": list(cfg.query_collectives)},
            "runs": runs, "violations": violations, "ok": not violations}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.collective_contract",
        description="aeriallint layer 3 of the port: what crosses blocks.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable report")
    ap.add_argument("-o", "--output", default=None,
                    help="also write the JSON report to this file")
    args = ap.parse_args(argv)

    report = run_collective_contract(args.device)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
    if args.json:
        json.dump(report, sys.stdout, indent=2)
        print()
    else:
        for v in report["violations"]:
            print(v)
        print(f"aeriallint.collective_contract: {len(report['runs'])} leg(s) "
              f"on {report['device']}, {len(report['violations'])} "
              "violation(s).")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
