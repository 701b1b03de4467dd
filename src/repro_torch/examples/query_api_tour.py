"""Tour of the composable query/aggregation API (paper §4.5 workload shapes;
port of ``examples/query_api_tour.py``).

Walks every aggregate op (count / sum / min / max / mean), channel selection,
the AND and OR combinators, shard-id point lookups, batching, and the
failure-handling session methods — all through the ``repro_torch.api``
facade, on a small single-device deployment.

    python -m repro_torch.examples.query_api_tour [--device cuda|cpu]
"""

from __future__ import annotations

from repro_torch.api import AGG_OPS, AerialDB, Query
from repro_torch.data.synthetic import DroneFleet
from repro_torch.device import resolve_device
from repro_torch.examples._common import launch_counts, launches_since, run_cli


def show(label, res, spec, log):
    view = {op: float(v.cpu().numpy()[0]) for op, v in res.view(spec).items()}
    cells = "  ".join(f"{op}={val:10.2f}" for op, val in view.items())
    log(f"  {label:<34} {cells}")
    return view


def main(device="cuda", log=print) -> dict:
    """Run the tour; returns what it prints (each shown view, counts,
    the four refusals' messages) and the kernels' launches."""
    dev = resolve_device(device)
    before = launch_counts()
    shown = {}
    # --- open + load: the facade owns state/alive/key plumbing ---
    db = AerialDB.open(n_edges=8, tuple_capacity=1 << 12, index_capacity=1024,
                       max_shards_per_query=64, records_per_shard=20,
                       device=dev)
    fleet = DroneFleet(12, records_per_shard=20, seed=7)
    payloads, metas = fleet.next_rounds(5)
    db.ingest_rounds(payloads, metas)
    t_max = float(payloads[..., 0].max())
    loaded = int(db.state.tup_count.sum())
    log(f"loaded {loaded} tuple replicas "
        f"over {db.cfg.n_edges} edges, t in [0, {t_max:.0f}]s\n")

    # --- every aggregate, one channel at a time ---
    log("aggregates over the whole deployment (per sensor channel):")
    window = Query().bbox(12.85, 13.10, 77.45, 77.75).time(0.0, t_max)
    for ch in range(db.cfg.n_values):
        q = window.agg(*AGG_OPS, channel=ch)
        res, _ = db.query(q)
        shown[f"channel {ch}"] = show(f"channel {ch}: all ops", res, q.spec, log)

    # --- single-op requests: .view projects what was asked for ---
    log("\nsingle-op requests:")
    for op in AGG_OPS:
        q = window.agg(op, channel=2)
        res, _ = db.query(q)
        shown[op] = show(f'.agg("{op}", channel=2)', res, q.spec, log)

    # --- fused multi-channel: every channel's aggregates from ONE scan ---
    log("\nmulti-channel (one scan of the log answers all channels):")
    q_mc = window.agg("count", "mean", "max",
                      channels=tuple(range(db.cfg.n_values)))
    res, _ = db.query(q_mc)
    view = {op: v.cpu().numpy() for op, v in res.view(q_mc.spec).items()}
    for ch in range(db.cfg.n_values):         # count (Q,), others (Q, K)
        log(f"  channel {ch}: count={int(view['count'][0]):6d} "
            f"mean={float(view['mean'][0, ch]):8.2f} "
            f"max={float(view['max'][0, ch]):8.2f}")
    shown["multi-channel"] = {op: view[op][0].tolist()
                              for op in ("count", "mean", "max")}

    # --- AND combinator: tuples must satisfy every clause ---
    log("\ncombinators:")
    left = Query().bbox(12.90, 13.00, 77.50, 77.65)
    right = Query().time(0.0, t_max / 3)
    q_and = (left & right).agg("count", "mean")
    res, _ = db.query(q_and)
    shown["and"] = show("bbox & time  (AND)", res, q_and.spec, log)

    # --- OR combinator: tuples may satisfy any clause ---
    q_or = (left | right).agg("count", "mean")
    res, _ = db.query(q_or)
    shown["or"] = show("bbox | time  (OR)", res, q_or.spec, log)

    # --- shard-id point lookup chained with a time window ---
    q_sid = Query().shard(3, 1).time(0.0, t_max).agg("count", "min", "max")
    res, _ = db.query(q_sid)
    shown["shard"] = show("shard(3,1) & time", res, q_sid.spec, log)

    # --- a batch: one scan answers all three spatial sizes ---
    log("\nbatched queries (one dispatch):")
    deg = 1.0 / 111.0
    # Center the boxes on a really-inserted tuple (analysts query where
    # drones actually flew), so the small windows are non-empty.
    anchor = payloads.reshape(-1, payloads.shape[-1])[100]
    center_lat, center_lon = float(anchor[1]), float(anchor[2])
    sizes = {"200m": 0.2 * deg, "1km": deg, "5km": 5 * deg}
    pred, spec = Query.batch(*[
        Query().bbox(center_lat - d / 2, center_lat + d / 2,
                     center_lon - d / 2, center_lon + d / 2)
               .time(0.0, t_max).agg("count", "mean")
        for d in sizes.values()], device=db.device)
    res, info = db.query((pred, spec))
    count, vmean = res.count.cpu().numpy(), res.vmean.cpu().numpy()
    edges = info.subquery_edges.cpu().numpy()
    for i, name in enumerate(sizes):
        log(f"  {name:>5} box: count={int(count[i]):6d} "
            f"mean={float(vmean[i]):8.2f} "
            f"edges={int(edges[i])}")
    shown["batch"] = {"count": count.tolist(), "mean": vmean.tolist(),
                      "edges": edges.tolist()}

    # --- failures: the session re-plans around dead edges ---
    log("\nresilience:")
    q = window.agg("count", channel=0)
    before_f, _ = db.query(q)
    db.fail_edges(1, 5)
    during, info = db.query(q)
    db.recover_edges(1, 5)
    after, _ = db.query(q)
    counts = [int(r.count.cpu().numpy()[0]) for r in (before_f, during, after)]
    broadcast = bool(info.broadcast.cpu().numpy()[0])
    log(f"  count before/during/after 2 edge failures: "
        f"{counts[0]}/{counts[1]}/{counts[2]} "
        f"(replication covers dead edges; broadcast={broadcast})")

    # --- validation: inverted ranges raise instead of matching nothing ---
    log("\nvalidation:")
    refused = {}
    for label, attempt in (
            ("inverted bbox", lambda: Query().bbox(13.10, 12.85, 77.45, 77.75)),
            ("inverted time", lambda: Query().time(600.0, 0.0)),
            ("channel overflow", lambda: db.query(window.agg("count", channel=99))),
            ("(A&B)|C", lambda: (left & Query().time(0, 1)) | Query().shard(0, 0))):
        try:
            attempt()
        except ValueError as e:
            refused[label] = str(e)[:58]
            log(f"  {label:<18} -> ValueError: {refused[label]}...")
    return {"loaded": loaded, "t_max": t_max, "shown": shown,
            "resilience_counts": counts, "broadcast": broadcast,
            "refused": refused, "launches": launches_since(before)}


if __name__ == "__main__":
    run_cli(main, __doc__)
