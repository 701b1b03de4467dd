"""Two-process smoke of the port's cross-host fleet runtime (port of
``benchmarks/multihost_smoke.py``).

The real multi-process path that the one-process fleet mesh stands in for:
2 worker processes in a ``torch.distributed`` world over gloo
(``launch.mesh.init_fleet_processes``), one process a fleet of a ``(2, N)
("fleet", "edge")`` mesh. Each worker drives the reference's scenario —
fused ingest, a healthy and a bbox query (and a batch of three, which
the fleet mesh runs in two tiles), ``fail_edges(1, 5)`` and a degraded
query, an insert during the outage, ``recover_edges(1, 5,
repair=False)`` and a recovered query — on the mesh and on a process-local
single store, and holds its own blocks leaf by leaf to the single store's
rows and every answer to the single store's (the cross-process state is
never gathered: every process checks exactly the blocks it holds).

    PYTHONPATH=src python -m repro_torch.launch.multihost_smoke \\
        [--device cuda|cpu] [--width reference|d400] [--edges E] \\
        [--drones D] [--rounds R] [--out DIR] [--timeout S]

The parent picks a free port, spawns the 2 workers (on the card both take
``cuda:0``; the kernels are built before they start), waits at most
``--timeout`` seconds, kills the rest when one fails, and exits non-zero
unless both exit 0. It prints one JSON line: the wall time and each
worker's report (its gloo exchanges, their host seconds and syncs). With
``--out``, each worker writes its answers and its blocks' leaves to
``DIR/worker<p>.npz``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parents[2]
N_PROC = 2
EDGE_PER_FLEET = 2             # blocks a process: a (2, 2) mesh
FAIL_EDGES = (1, 5)
# Three AND queries in one batch (the federation tests' and_spatiotemporal):
# the fleet mesh splits it into tiles of 2 and 1.
BATCH = dict(q=3, lat0=[12.85, 12.90, 12.95], lat1=[13.10, 13.00, 13.05],
             lon0=[77.45, 77.50, 77.55], lon1=[77.75, 77.60, 77.65],
             t0=[0.0, 0.0, 60.0], t1=[1e9, 120.0, 180.0], has_spatial=True,
             has_temporal=True, is_and=True)
BATCH_CHANNELS = (0, 2)

# The reference smoke's widths, and the D400 day's (80 edges, 400 drones,
# 60-record shards, a day's 2^18-slot rings).
WIDTHS = {
    "reference": dict(edges=8, drones=10, rounds=3,
                      cfg=dict(tuple_capacity=2048, index_capacity=512,
                               max_shards_per_query=64, records_per_shard=12,
                               retention_every=2)),
    "d400": dict(edges=80, drones=400, rounds=24,
                 cfg=dict(tuple_capacity=1 << 18, index_capacity=1 << 15,
                          max_shards_per_query=128, records_per_shard=60,
                          n_values=4, replication=3)),
}


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--width", default="reference", choices=sorted(WIDTHS))
    ap.add_argument("--edges", type=int, default=None)
    ap.add_argument("--drones", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="directory for each worker's worker<p>.npz")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds the parent waits for both workers")
    ap.add_argument("--init-timeout", type=float, default=60.0,
                    help="seconds a worker waits for its peer")
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)
    w = WIDTHS[args.width]
    for k in ("edges", "drones", "rounds"):
        if getattr(args, k) is None:
            setattr(args, k, w[k])
    return args


def _bits(t):
    """A tensor's bits: floats as int32 words, so NaNs compare equal."""
    return t.view(torch.int32) if t.is_floating_point() else t


def child(args) -> dict:
    """One worker: its fleet of the mesh and a process-local single store
    through the scenario, every check raising on a difference. Returns the
    report."""
    import numpy as np

    from repro_torch.launch.mesh import init_fleet_processes, make_fleet_mesh
    init_fleet_processes(args.coordinator, N_PROC, args.process_id,
                         timeout_s=args.init_timeout)
    dist = torch.distributed
    assert dist.get_world_size() == N_PROC

    from repro_torch.api import AerialDB, Query
    from repro_torch.core import threefry
    from repro_torch.core.datastore import AggSpec, StoreConfig, make_pred
    from repro_torch.data.synthetic import CityConfig, DroneFleet, make_sites
    from repro_torch.distributed import federation
    from repro_torch.distributed.sharding import (_flat,
                                                  store_partition_specs)
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops

    t_start = time.perf_counter()
    e = args.edges
    mesh = make_fleet_mesh(N_PROC, EDGE_PER_FLEET, n_edges=e,
                           device=args.device)
    assert mesh.fleet == args.process_id
    assert len(mesh.devices) == EDGE_PER_FLEET
    width = WIDTHS[args.width]["cfg"]
    sites = make_sites(e, CityConfig(), seed=3)
    cfg = StoreConfig(n_edges=e, sites=tuple(map(tuple, sites.tolist())),
                      **width)
    rps = cfg.records_per_shard
    db_ref = AerialDB.open(cfg, device=args.device)   # process-local single
    db_fed = AerialDB.open(cfg, mesh)                 # this process's fleet
    ranges = mesh.blocks(e)
    names = ([f"index.{f}" for f in db_ref.state.index._fields]
             + [f for f in db_ref.state._fields if f != "index"])
    leaves_checked = 0

    per_edge = _flat(store_partition_specs())

    def check_states(what):
        nonlocal leaves_checked
        ref = _flat(db_ref.state)
        for ids, blk in zip(ranges, db_fed.blocks):
            for name, r, b, spec in zip(names, ref, _flat(blk), per_edge):
                want = r[ids.start:ids.stop] if spec else r
                if not torch.equal(_bits(b), _bits(want)):
                    raise SystemExit(f"{what}: {name} of block {ids} differs")
                leaves_checked += 1

    answers = {}

    def check_query(what, q, seed):
        r1, i1 = db_ref.query(q, key=threefry.key(seed))
        r2, i2 = db_fed.query(q, key=threefry.key(seed))
        for f in r1._fields:
            a, b = getattr(r1, f), getattr(r2, f)
            if f in ("vsum", "vmean"):
                torch.testing.assert_close(b, a, rtol=1e-5, atol=0,
                                           equal_nan=True,
                                           msg=f"{what}: {f}")
            elif not torch.equal(_bits(a), _bits(b)):
                raise SystemExit(f"{what}: {f} differs")
        for f in i1._fields:
            if not torch.equal(_bits(getattr(i1, f)), _bits(getattr(i2, f))):
                raise SystemExit(f"{what}: info.{f} differs")
        answers[what] = {**{f: getattr(r2, f) for f in r2._fields},
                         **{f"info.{f}": getattr(i2, f) for f in i2._fields}}

    for mod in (hash64_ops, vor_ops, st_ops):
        mod.launches = 0
    federation.exchanges.update(calls=0, syncs=0, seconds=0.0)
    fleet = DroneFleet(args.drones, records_per_shard=rps,
                       n_values=cfg.n_values, seed=43)
    pay, met = fleet.next_rounds(args.rounds)
    db_ref.ingest_rounds(pay, met)
    db_fed.ingest_rounds(pay, met)
    check_states("post-ingest")

    q = Query().time(0.0, 1e9).agg("count", "mean", channel=1)
    qbox = (Query().bbox(12.85, 13.10, 77.45, 77.75)
            & Query().time(0.0, 1e9)).agg("count", "min", "max", channel=2)
    check_query("healthy", q, 7)
    check_query("healthy-bbox", qbox, 9)
    check_query("healthy-batch", (make_pred(**BATCH, device=args.device),
                                  AggSpec(channels=BATCH_CHANNELS)), 17)

    db_ref.fail_edges(*FAIL_EDGES)
    db_fed.fail_edges(*FAIL_EDGES)
    check_query("degraded", q, 11)
    p, m = DroneFleet(6, records_per_shard=rps, n_values=cfg.n_values,
                      seed=8).next_shards()
    db_ref.insert(p, m)
    db_fed.insert(p, m)
    # repair=False: the anti-entropy sweep gathers the whole store to one
    # host, so a multi-process session refuses it (AerialDB.repair).
    db_ref.recover_edges(*FAIL_EDGES, repair=False)
    db_fed.recover_edges(*FAIL_EDGES, repair=False)
    check_states("post-recovery")
    check_query("recovered", q, 13)
    try:
        db_fed.state
    except ValueError:
        pass
    else:
        raise SystemExit("AerialDB.state returned a store on a multi-process "
                         "mesh")
    if args.device == "cuda":
        torch.cuda.synchronize()
    stats = dict(federation.exchanges)
    launches = {"hash64": hash64_ops.launches,
                "voronoi_assign": vor_ops.launches,
                "st_scan": st_ops.launches}
    if args.out:
        out = {f"answer/{w}/{f}": v.cpu().numpy()
               for w, fields in answers.items() for f, v in fields.items()}
        for ids, blk in zip(ranges, db_fed.blocks):
            for name, leaf in zip(names, _flat(blk)):
                out[f"block{ids.start // len(ids)}/{name}"] = \
                    leaf.cpu().numpy()
        out["edge_ranges"] = np.array([[r.start, r.stop] for r in ranges])
        Path(args.out).mkdir(parents=True, exist_ok=True)
        np.savez(Path(args.out) / f"worker{args.process_id}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "repro"))
    if bad:
        raise SystemExit(f"the worker imported {bad[:5]}")
    return {"process": args.process_id, "fleet": mesh.fleet,
            "mesh": mesh.shape, "blocks": [[r.start, r.stop] for r in ranges],
            "device": str(mesh.devices[0]), "leaves_checked": leaves_checked,
            "answers_checked": len(answers),
            "counts": {w: a["count"].tolist() for w, a in answers.items()},
            "gloo_exchanges": stats["calls"], "host_syncs": stats["syncs"],
            "exchange_host_s": stats["seconds"], "launches": launches,
            "worker_s": time.perf_counter() - t_start}


def parent(args) -> int:
    """Spawn the two workers and wait for both; returns the exit code."""
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("multihost_smoke: --device cuda needs CUDA; pass --device "
                  "cpu for the plain versions", file=sys.stderr)
            return 1
        from repro_torch.kernels import build
        build.build_all(("hash64", "voronoi_assign", "st_scan"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(SRC) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    argv = [sys.executable, "-m", "repro_torch.launch.multihost_smoke",
            "--child", "--coordinator", f"127.0.0.1:{port}",
            "--device", args.device, "--width", args.width,
            "--edges", str(args.edges), "--drones", str(args.drones),
            "--rounds", str(args.rounds),
            "--init-timeout", str(args.init_timeout)]
    if args.out:
        argv += ["--out", str(args.out)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv + ["--process-id", str(i)], env=env,
                              stdout=subprocess.PIPE, text=True)
             for i in range(N_PROC)]
    codes = [None] * N_PROC
    while None in codes:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes) or \
                time.perf_counter() - t0 > args.timeout:
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
    codes = [p.wait() for p in procs]
    outs = [p.communicate()[0] for p in procs]
    wall = time.perf_counter() - t0
    if any(codes):
        print(f"multihost_smoke: worker exit codes {codes} after {wall:.1f} "
              "s", file=sys.stderr)
        return 1
    print(json.dumps({"multihost_smoke": "ok", "processes": N_PROC,
                      "device": args.device, "width": args.width,
                      "edges": args.edges, "drones": args.drones,
                      "rounds": args.rounds, "wall_s": wall,
                      "workers": [json.loads(o.splitlines()[-1])
                                  for o in outs]}), flush=True)
    return 0


def main(argv=None) -> int:
    args = _args(argv)
    if args.child:
        print(json.dumps(child(args)), flush=True)
        return 0
    return parent(args)


if __name__ == "__main__":
    sys.exit(main())
