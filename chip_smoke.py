#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of AerialDB on one GPU, end to end.

    python3 chip_smoke.py                  # full run (needs one CUDA card)
    python3 chip_smoke.py --rounds 24      # shallower ingest, same widths

Phases, one line each:
  1. environment: card name and power limit (nvidia-smi), torch / CUDA
     versions, kernel build time (one nvcc per csrc/*.cu, all at once);
  2. hash64 and voronoi_assign against their plain PyTorch versions on the
     card (bitwise), and against the pure-Python / float64 oracles;
  3. the main path at full width — the paper's D400 deployment (400 drones,
     80 edges, 60-sample shards every 5 min, 4 channels, replication 3):
     open, fused ingest of one day (288 rounds), then three 64-query AND
     batches at the paper's §4.5.1 sizes, single- and 4-channel. Checks the
     answers on retained windows against a numpy oracle over the generated
     payloads and that every kernel's launch count grew; then, on the same
     store, the planners line: the same batches through a ``random``
     session (key from ``--seed``) and a ``min_edges`` one (batch p50, fig.
     9's mean sub-query edges and shards per edge, launches, the same exact
     checks) and the random planner's threefry draw and plans on the card
     against the CPU (bits and uniforms bitwise, picks away from
     near-ties); then the latest line: the same day into a second store
     with the latest-per-drone cache (``max_drones`` 400), its shards/s
     beside the main path's, the cache against the oracle over every
     record (bitwise), every other state leaf and the 5 km batch against
     the main path's store, the host µs of ``latest()`` and
     ``query(Query().latest())``, a crafted round of edge cases against the
     oracle and the CPU, one cache update's call and host time, and the
     cache's cost on ingest from two fresh stores, with and without it,
     taking the day's first chunks in turns; then the resilience line: the
     paper's edge-server loss at D400 width (4 failure domains, 2^19-slot
     rings, domain 1's
     20 edges down from round 24 to 48, then recovered with the incremental
     repair) against a never-faulted twin: the 1 km x 1800 s batch during
     and after the outage against the twin's, the ledger's no-op flips,
     the incremental repair against a full sweep of a clone, the
     canonical content against the twin's, the kernels at the repair's
     batch against their plain versions, and a small wrapping scenario on
     the card against the CPU; the repair telemetry, its host seconds (D2H,
     placement, sweep, H2D), launches, shards/s and peak memory; its
     partition leg: a third store on the same rounds, split after round
     24 (edges 60-79 unreachable) and healed after round 48, held to the
     same twin (the far side frozen, both batches during and after the
     split, the heal's repair against a full sweep, the swept shards,
     the content, an empty ledger); then the streaming line: 48 rounds of
     a 400-drone fleet sent as an adversarial stream (re-sends, gaps,
     NaN-partial records, shuffled, transient dispatch faults, the
     journal on) through ``IngestPipeline`` into a D400 store with the
     latest cache, its counters, the three batch sizes against a numpy
     oracle (NaN a value), ``latest()`` before the drain against the
     oracle and a journal replay into a fresh store; then the chaos line:
     fig. 19's soak at D400 width (the resilience config) for seeds 3, 11
     and 42, each a ``FaultPlan.random`` over 16 rounds (domain losses,
     edge losses, partitions cut across the domain blocks, flush bursts)
     through ``ChaosRunner`` on a session and pipeline beside a
     never-faulted twin: the plan replayed from its seed, the counters
     every step, a probe batch after every repair (exact against the twin
     with bound 1 at full health), no wrap and the content equal to the
     twin's at the end; a mid-flush crash replayed from the journal; the
     reference tests' smoke plan on the card against the CPU;
  4. st_scan against its plain version on the main path's own scan inputs
     (the three batches, 1 and 4 channels), on a copy of the day's log with
     NaN in a channel of matched slots and on a copy rolled by a third of
     the ring with every count above capacity (count, min, max bitwise with
     NaN equal, sum to rtol 1e-5, a second call bitwise equal); its device
     time at each batch and channel count beside the bytes it must move;
     then per-kernel timings beside their bounds (hash64 at an insert
     round's three shapes, 6,400 slice buckets and 400 midpoint buckets in
     the H_t form and 400 shard ids in the H_i form, each beside an empty
     kernel on its grid; voronoi_assign at the
     slice grid's and the placement's shapes, with the sites it visits a
     point, the instructions that costs by a static count from its SASS,
     and its bound recounted for the sites visited): ``ms`` is the call time,
     wrapper included (CUDA events around back-to-back calls, so a wrapper
     slower than its kernel shows the host), ``device_ms`` the kernel's own
     device time a launch (torch.profiler, summed by kernel name);
  5. flash_attention's three kernels against their plain version (fp32 at
     the JAX package's test shapes, decode rows and ragged sizes, to 2e-5,
     through the mma_sync kernel; bf16 at the serve shapes, decode rows of
     256 and 4096 slots, a GQA group of 5 and a ragged d-128 case, to 1e-2,
     through the sm90, decode and mma_sync kernels, each forced and as the
     wrapper chooses; the decode kernel also bitwise repeatable);
  6. the LM serving path at full width — internlm2-1.8b (24 layers,
     d_model 2048, 16 query heads over 8 KV heads, vocab 92544), random
     weights from a seeded generator on the card, bf16 compute:
     ``prefill_step`` on 8 prompts of 2048 tokens, then ``Engine.generate``
     for 8 requests (128-token prompts, 64 new tokens, max_seq 256), twice
     (identical ids), with the engine's logits after the last prompt token
     held against ``prefill_step``'s on the same prompts; every prefill
     flash call must go to the sm90 kernel and every generate call (Sq 1)
     to the decode kernel;
  7. flash_attention timings at the prefill shape (sm90 and mma_sync, both
     forced) and at two decode shapes, 192 of 256 slots and 4096 of 4096
     (decode and mma_sync, both forced), each beside SDPA and the bytes or
     operations bound, the profiles each device time took, and the six
     kernels' timings printed as one JSON line.
The last line is {"ok": true, "device": {...}}; any failure exits non-zero
before it. Imports only torch, numpy and the port (``src/repro_torch``).
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM data sheet, outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM data sheet, dense tensor cores
QUERY_SIZES = ((0.2, 300.0), (1.0, 1800.0), (5.0, 7200.0))   # paper §4.5.1
RECENT_S = 1800.0              # windows retained on every replica
# The resilience phase's ring: the main path's 2^18 slots wrap on the dead
# domain's successor edge (40 takes the block's spatial and id replicas:
# `resilience.tup_count_max`), and content equality needs no wrap.
RESILIENCE_CAPACITY = 1 << 19
# The resilience phase's partition leg: a cut along the failure-domain
# blocks (domain 3 unreachable), so every shard keeps a reachable replica.
SPLIT_GROUPS = (list(range(60)), list(range(60, 80)))
PER_EDGE_LEAVES = ("tup_f", "tup_sid", "tup_count", "tup_pos",
                   "tup_overwritten", "tup_dropped")
# The streaming phase: 48 rounds of the D400 fleet as a drone stream, made
# adversarial as benchmarks/fig18_streaming_ingest.py makes it.
STREAM_ROUNDS = 48
STREAM_BURSTS = 4
DUP_FRAC, DROP_FRAC, PARTIAL_FRAC = 0.03, 0.02, 0.05
FAULT_FRAC = 0.05              # dispatch attempts that raise a transient fault
# The chaos phase: fig. 19's soak (benchmarks/fig19_chaos_soak.py:100-150)
# at D400 width, FaultPlan.random over the 80 edges and 4 failure domains,
# one D400 round a step; fig. 19's default seeds.
CHAOS_SEEDS = (3, 11, 42)
CHAOS_STEPS = 16
CHAOS_MIN_ALIVE = 30           # alive AND reachable floor (>= replication 3)
CHAOS_REPAIRS = ("heal", "recover_edges", "recover_device")
# The reference chaos tests' smoke plan (tests/test_chaos.py, 8 edges):
# (step, kind, args) rows over 4 steps.
CHAOS_SMOKE = ((0, "fail_edges", ((6,),)),
               (1, "partition", (((0, 1, 2, 3, 6), (4, 5, 7)),)),
               (1, "flush_fail", (2,)),
               (2, "heal", ()),
               (3, "recover_edges", ((6,),)))
SERVE_ARCH = "internlm2-1.8b"
SERVE_BATCH = 8
PREFILL_LEN = 2048
PROMPT_LEN, NEW_TOKENS, MAX_SEQ = 128, 64, 256
LONG_SEQ = 4096                # the long-cache decode row
FLASH_BF16_TOL = 1e-2          # bf16 outputs of order 1: ulp 0.0078
FLASH_F32_TOL = 2e-5           # as the JAX package's kernel tests
# Engine logits after the last prompt token vs prefill_step's, bf16 through
# 24 layers: the two round activations at different matmul shapes, so
# they agree to a fraction of the logits' unit spread, not bitwise.
PREFILL_DECODE_TOL = 0.5
# A voronoi_assign visit as compiled for sm_90a (csrc/voronoi_assign.cu
# `visit`): FMUL, FMUL, FADD, FMUL by 2, FADD, then FSETP, FSEL, SEL. A
# static count, read by hand in the kernel's SASS, not measured in a run.
VISIT_INSTRUCTIONS = 8
VORONOI_SOURCE = Path(__file__).resolve().parent / "src/repro_torch/csrc/voronoi_assign.cu"
# Profiles taken by each device_ms call, in call order (more than one: a
# profile recorded no device time for the kernel and was taken again).
DEVICE_MS_PROFILES: list[int] = []


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def host_us(torch, fns: dict, calls: int = 100, rounds: int = 7) -> dict:
    """The host's time a call of each of ``fns`` (a name -> callable), in
    µs: perf_counter around ``calls`` calls that nothing waits on, the
    median of ``rounds`` rounds taken in turns. While the card keeps up
    with the calls, this is the wrapper's own cost on the host."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times[name].append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return {name: float(np.median(t)) for name, t in times.items()}


def _device_rows(torch, prof):
    """(device µs, calls, name) of each device activity of a profile;
    CUPTI's own buffer markers are not work."""
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or "Buffer" in ev.key:
            continue
        yield (getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0)), ev.count, ev.key)


def device_ms(torch, fn, iters: int, match: str | None = None) -> float:
    """Device time a call of ``fn`` (torch.profiler): the time of the
    device kernels whose name holds ``match`` (of every device activity
    when None) over ``iters`` calls, divided by ``iters``. Exits non-zero
    when no such kernel ran in three profiles; appends the profiles it took
    to DEVICE_MS_PROFILES."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    for taken in range(1, 4):   # now and then a profile records no device activity
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(t for t, _, key in _device_rows(torch, prof)
                 if match is None or match in key)
        if us > 0:
            DEVICE_MS_PROFILES.append(taken)
            return us / 1e3 / iters
    raise SystemExit(f"device_ms: no device time for kernel {match!r}")


def profile(torch, fn, top: int = 12, host_top: int = 0) -> dict:
    """Wall time of one ``fn()`` (synchronised) and its device time by
    kernel name (torch.profiler), with the device's busy share; with
    ``host_top``, also the operators that took the most host time (self
    CPU µs, calls)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side activities only (CPU ops would count their kernels twice).
    rows = sorted(((us / 1e3, n, key[:60])
                   for us, n, key in _device_rows(torch, prof) if us > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
           "device_launches": sum(r[1] for r in rows),
           "top": [{"ms": ms, "calls": n, "name": k} for ms, n, k in rows[:top]]}
    if host_top:
        ops = sorted(((ev.self_cpu_time_total, ev.count, ev.key)
                      for ev in prof.key_averages()
                      if ev.device_type == torch.autograd.DeviceType.CPU),
                     reverse=True)
        out["host_top"] = [{"us": us, "calls": n, "name": k[:60]}
                           for us, n, k in ops[:host_top]]
    return out


def voronoi_visits(torch, vor_ops, lat, lon, sites) -> dict:
    """The sites ``voronoi_assign``'s kernel visits a point, from the packed
    site set and the kernel's source: ``listed``, the mean length of the
    points' cell lists (E outside the grid), what the data needs; and
    ``issued``, the visits a point's warp issues, 32 consecutive points a
    warp as the kernel's grid-stride loop takes them: kAhead predicated
    visits and then the rest of the warp's longest list when a lane is in
    the grid, plus all E sites when a lane is outside it."""
    ahead = int(re.search(r"constexpr int kAhead = (\d+);",
                          VORONOI_SOURCE.read_text()).group(1))
    e = sites.shape[0]
    listed = vor_ops.listed_sites(lat, lon, sites).reshape(-1).long()
    inside = vor_ops.locate(lat, lon, sites)[2].reshape(-1)
    n = listed.numel()
    pad = -n % 32
    real = torch.nn.functional.pad(torch.ones_like(inside), (0, pad)).view(-1, 32)
    inside = torch.nn.functional.pad(inside, (0, pad)).view(-1, 32) & real
    longest = torch.where(inside, torch.nn.functional.pad(listed, (0, pad)).view(-1, 32),
                          0).amax(1)
    warp = (inside.any(1) * longest.clamp(min=ahead)
            + (real & ~inside).any(1) * e)
    return {"listed": float(listed.float().mean()),
            "issued": float((warp * real.sum(1)).sum() / n), "ahead": ahead}


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def exact_checks(results, batches, specs, flat) -> tuple:
    """Every answer of ``results`` ((batch, spec) -> (QueryResult,
    QueryInfo)) has its shape and finite aggregates where it matched; on
    the recent batches (windows retained on every replica) each count
    equals the numpy oracle over ``flat`` (the generated tuples) and each
    sum agrees to rtol 1e-5. Exits non-zero otherwise; returns (queries
    checked, queries skipped for overflow)."""
    checked = overflowed = 0
    for (bi, si), (res, info) in results.items():
        k = specs[si].n_channels
        assert res.count.shape == (64,) and res.vsum.shape == ((64,) if k == 1 else (64, k))
        cnt = res.count.cpu().numpy()
        some = cnt > 0
        for a in (res.vsum, res.vmin, res.vmax, res.vmean):
            a = a.cpu().numpy().reshape(64, -1)
            if not np.isfinite(a[some]).all():
                raise SystemExit("non-finite aggregate on a matching query")
        km, win, recent, w = batches[bi]
        if not recent:
            continue
        ovf = res.overflow.cpu().numpy()
        vs = res.vsum.cpu().numpy().reshape(64, -1)
        for qi in range(64):
            if ovf[qi]:
                overflowed += 1
                continue
            m = ((w["lat0"][qi] <= flat[:, 1]) & (flat[:, 1] <= w["lat1"][qi])
                 & (w["lon0"][qi] <= flat[:, 2]) & (flat[:, 2] <= w["lon1"][qi])
                 & (w["t0"][qi] <= flat[:, 0]) & (flat[:, 0] <= w["t1"][qi]))
            if int(m.sum()) != int(cnt[qi]):
                raise SystemExit(f"batch {bi} query {qi}: count {cnt[qi]} != "
                                 f"oracle {int(m.sum())}")
            want = flat[m][:, 3:3 + k].sum(0)
            np.testing.assert_allclose(vs[qi], want, rtol=1e-5)
            checked += 1
    return checked, overflowed


def planners_phase(torch, dev, cfg, db, batches, specs, flat, seed: int,
                   do_profile: bool, main_results, main_times) -> dict:
    """Fig. 9's planners on the main path's store: one session per planner
    (``random`` with its key from ``seed``, then ``min_edges``) over the
    same state, running the main path's 3 batches x 2 specs three times,
    the first as the warm-up. Per planner: the batch p50, the mean
    ``subquery_edges`` and ``max_shards_per_edge`` of each batch (fig. 9's
    derived axes), each kernel's launches during its run (counts set to 0
    just before it, read just after; every kernel must launch) and the
    exact checks of the main path; ``min_shards`` gives the same axes
    from the main path's own run (``main_results``, ``main_times``). Then
    the random planner on the card
    against the CPU: the threefry bits and uniforms of its first query's
    (Q, S, 3) draw bitwise, and its plan for each batch's MatchedShards
    away from near-ties (top two CPU gumbels of a shard's usable replicas
    under 1e-5 apart, counted). Exits non-zero on any mismatch."""
    import dataclasses
    from repro_torch.api.session import AerialDB
    from repro_torch.core import planner, threefry
    from repro_torch.core.datastore import _lookup_sets, make_pred
    from repro_torch.core.index import MatchedShards, lookup
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops
    mods = {"hash64": hash64_ops, "voronoi_assign": vor_ops, "st_scan": st_ops}
    preds = [make_pred(q=64, **w, has_spatial=True, has_temporal=True,
                       is_and=True, device=dev) for *_, w in batches]
    out, sessions = {"min_shards": {
        "from_main_path": True,
        "query_batch_p50_ms": float(np.median(main_times)),
        "subquery_edges_mean": [float(np.mean([
            main_results[(bi, si)][1].subquery_edges.float().mean().item()
            for si in range(len(specs))])) for bi in range(len(batches))],
        "max_shards_per_edge_mean": [float(np.mean([
            main_results[(bi, si)][1].max_shards_per_edge.float().mean().item()
            for si in range(len(specs))])) for bi in range(len(batches))]}}, {}
    for name in ("random", "min_edges"):
        sess = AerialDB(dataclasses.replace(cfg, planner=name), db.state,
                        device=dev, seed=seed)
        sessions[name] = sess
        results, times = {}, []
        edges, shards = ([[] for _ in batches] for _ in range(2))
        for mod in mods.values():
            mod.launches = 0
        for rep in range(3):
            for bi, pred in enumerate(preds):
                for si, spec in enumerate(specs):
                    torch.cuda.synchronize()
                    q0 = time.perf_counter()
                    res, info = sess.query(pred, agg=spec)
                    torch.cuda.synchronize()
                    if rep > 0:            # repetition 0 is the warm-up
                        times.append((time.perf_counter() - q0) * 1e3)
                        edges[bi].append(float(info.subquery_edges.float().mean()))
                        shards[bi].append(float(info.max_shards_per_edge.float().mean()))
                    results[(bi, si)] = (res, info)
        launches = {k: m.launches for k, m in mods.items()}
        if min(launches.values()) <= 0:
            raise SystemExit(f"planner {name}: a kernel never launched: {launches}")
        checked, overflowed = exact_checks(results, batches, specs, flat)
        out[name] = {"query_batch_p50_ms": float(np.median(times)),
                     "query_batch_ms": times,
                     "subquery_edges_mean": [float(np.mean(e)) for e in edges],
                     "max_shards_per_edge_mean": [float(np.mean(x)) for x in shards],
                     "launches": launches, "queries_checked_exact": checked,
                     "queries_overflowed": overflowed}

    # The random planner on the card against the CPU. Its session's first
    # query took the second half of the first split of key(seed).
    s = cfg.max_shards_per_query
    k1 = threefry.split(threefry.key(seed))[1]
    qkeys = threefry.fold_in(k1, torch.arange(64, device=dev))
    qkeys_cpu = threefry.fold_in(k1, torch.arange(64))
    if not torch.equal(qkeys.cpu(), qkeys_cpu):
        raise SystemExit("threefry: the folded keys differ on the card")
    card_draw, cpu_draw = ((threefry.random_bits(k, (s, 3)).cpu(),
                            threefry.uniform(k, (s, 3), threefry.F32_TINY).cpu()
                            .view(torch.int32)) for k in (qkeys, qkeys_cpu))
    draw_bad = sum(int((a != b).sum()) for a, b in zip(card_draw, cpu_draw))
    if draw_bad:
        raise SystemExit(f"threefry: {draw_bad} bits or uniforms differ on the card")
    g_cpu = threefry.gumbel(qkeys_cpu, (s, 3))
    g_err = float((threefry.gumbel(qkeys, (s, 3)).cpu() - g_cpu).abs().max())
    alive = sessions["random"].alive
    plan_shards = near_ties = plan_bad = 0
    for pred in preds:
        lookup_mask, _ = _lookup_sets(cfg, pred, cfg.sites_array(dev), alive)
        matched = lookup(db.state.index, pred, lookup_mask, s)
        m_cpu = MatchedShards(*(f.cpu() for f in matched))
        card = planner.plan_random(matched, alive, k1).cpu()
        cpu = planner.plan_random(m_cpu, alive.cpu(), k1)
        ok = planner._alive_replica_mask(m_cpu, alive.cpu())
        top = torch.where(ok, g_cpu, -1e30).sort(dim=-1).values
        near = (ok.sum(-1) >= 2) & (top[..., -1] - top[..., -2] < 1e-5)
        plan_shards += int(m_cpu.valid.sum())
        near_ties += int(near.sum())
        plan_bad += int(((card != cpu) & ~near).sum())
    if plan_bad:
        raise SystemExit(f"plan_random: {plan_bad} picks differ on the card")

    # The draw a random-planner batch adds: the fold of 64 query keys and
    # the (64, S, 3) gumbels, as plan_random makes them.
    def draw():
        return threefry.gumbel(threefry.fold_in(k1, torch.arange(64, device=dev)),
                               (s, 3))
    out["random"]["threefry_draw"] = {
        "ms": cuda_ms(torch, draw, 20),
        "host_us": host_us(torch, {"draw": draw}, calls=20)["draw"]}
    if do_profile:
        prof = profile(torch, draw)
        out["random"]["threefry_draw"].update(
            device_ms=prof["device_busy_ms"], launches=prof["device_launches"],
            device_idle_share=prof["device_idle_share"])
        out["random"]["profile_query"] = profile(
            torch, lambda: sessions["random"].query(preds[2], agg=specs[1]))
    out["card_vs_cpu"] = {"draw_elements": 64 * s * 3, "draw_mismatch": 0,
                          "gumbel_max_abs_err": g_err,
                          "plan_shards": plan_shards, "plan_near_ties": near_ties,
                          "plan_mismatch_away_from_ties": 0}
    return out


def bitwise_equal(torch, a, b) -> bool:
    """Same shape, dtype and bits (a NaN equals a NaN of the same bits)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def latest_phase(torch, dev, cfg, db, fleet, payloads, metas, chunks,
                 batches, specs, seed: int, do_profile: bool) -> tuple:
    """The latest-per-drone cache on a second D400 store (``max_drones``
    400, drone ids 0-399 as ``sid_hi``): the main path's rounds in the same
    chunks, timed as the main path times them; then the cache against the
    vectorised oracle over every record ingested (record, last_seen and
    valid bitwise), every other state leaf against the main path's store
    (``torch.equal``), one 4-channel 5 km batch on both stores (every
    field bitwise), and the host µs of ``latest()`` and of
    ``query(Query().latest())`` (median of 100 calls each). Then one crafted
    round at D400 width (``latest_edge_round``: tied duplicate ids, a t
    equal to the cached row's, NaN and +-inf t, ids -1, 400 and 407, NaN
    channels), held against the oracle and against the same update run on
    the CPU, bitwise. Counts are set to 0 before the ingest and read after
    the batch; every kernel must launch. Also one ``_update_latest`` call
    at a round's shape on copies of the cache: its call ms (CUDA events)
    and host µs, and under ``do_profile`` its profile with the operators
    that took the most host time. Returns (fields, store). Exits non-zero
    on any mismatch."""
    import dataclasses
    from repro_torch.api.query import Query
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import _update_latest, make_pred
    from repro_torch.data.synthetic import latest_edge_round
    from repro_torch.ingest.latest import latest_oracle_sorted
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops
    mods = {"hash64": hash64_ops, "voronoi_assign": vor_ops, "st_scan": st_ops}
    d = fleet.n_drones
    lcfg = dataclasses.replace(cfg, max_drones=d)
    for mod in mods.values():
        mod.launches = 0
    ldb = AerialDB.open(lcfg, device=dev)

    def ingest(sl):
        ldb.ingest_rounds(payloads[sl], type(metas)(*(f[sl] for f in metas)))

    ingest(chunks[0])                  # warm-up chunk, not timed
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for sl in chunks[1:]:
        ingest(sl)
    ev1.record()
    ev1.synchronize()
    timed_rounds = chunks[-1].stop - chunks[0].stop
    ingest_s = ev0.elapsed_time(ev1) / 1e3
    pred = make_pred(q=64, **batches[2][3], has_spatial=True, has_temporal=True,
                     is_and=True, device=dev)
    res_l, info_l = ldb.query(pred, agg=specs[1])
    launches = {k: m.launches for k, m in mods.items()}
    if min(launches.values()) <= 0:
        raise SystemExit(f"latest: a kernel never launched: {launches}")
    res_m, info_m = db.query(pred, agg=specs[1])
    batch_bad = [f for got, want in ((res_l, res_m), (info_l, info_m))
                 for f in want._fields
                 if not bitwise_equal(torch, getattr(got, f), getattr(want, f))]
    if batch_bad:
        raise SystemExit(f"latest: the 5 km batch differs on the cached store: {batch_bad}")

    # every state leaf but the cache equals the main path's store
    cache = ("latest_f", "latest_seen")
    leaf_bad = states_equal(torch, ldb.state, db.state, skip=cache)
    if leaf_bad:
        raise SystemExit(f"latest: the cache perturbed state leaves {leaf_bad}")

    def check(rows, ids, per_step, what):
        """The cache against the oracle over ``rows`` (N, W) with drone ids
        ``ids`` (N,), ``per_step`` records an insert; returns rows checked."""
        want_rec, want_valid, src = latest_oracle_sorted(ids, rows[:, 0], rows, d)
        got = ldb.latest()
        want_seen = np.where(want_valid, src // per_step + 1, -1)
        rec = got.record.cpu().numpy()
        bad = {"record": int((rec.view(np.int32) != want_rec.view(np.int32)).any(1).sum()),
               "last_seen": int((got.last_seen.cpu().numpy() != want_seen).sum()),
               "valid": int((got.valid.cpu().numpy() != want_valid).sum())}
        if any(bad.values()) or got.last_seen.dtype != torch.int32:
            raise SystemExit(f"latest ({what}): rows apart from the oracle {bad}")
        return int(want_valid.sum())

    n_rounds = chunks[-1].stop
    per_round = d * cfg.records_per_shard
    rows = payloads[:n_rounds].reshape(-1, payloads.shape[-1])
    ids = np.repeat(metas.sid_hi[:n_rounds].reshape(-1), cfg.records_per_shard)
    drones_exact = check(rows, ids, per_round, "day")

    host = {}
    for name, fn in (("latest", ldb.latest),
                     ("query_latest", lambda: ldb.query(Query().latest()))):
        times = []
        for _ in range(100):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        host[f"{name}_host_us"] = float(np.median(times))

    # one crafted round after the day, on the card and on the CPU
    before = ldb.latest()
    cpu_f, cpu_seen = before.record.cpu().clone(), before.last_seen.cpu().clone()
    cached_t = np.where(before.valid.cpu().numpy(), cpu_f[:, 0].numpy(), np.nan)
    payload, meta = fleet.next_shards()
    cp, cids = latest_edge_round(payload, meta.sid_hi, cached_t, d, seed=seed)
    ldb.insert(cp, meta._replace(sid_hi=cids))
    _update_latest(cpu_f, cpu_seen, torch.from_numpy(cp), torch.from_numpy(cids),
                   n_rounds + 1)
    after = ldb.latest()
    cpu_bad = int((after.record.cpu().view(torch.int32) != cpu_f.view(torch.int32))
                  .any(1).sum() + (after.last_seen.cpu() != cpu_seen).sum())
    if cpu_bad:
        raise SystemExit(f"latest (crafted round): {cpu_bad} rows apart from the CPU's")
    crafted_exact = check(np.concatenate([rows, cp.reshape(-1, cp.shape[-1])]),
                          np.concatenate([ids, np.repeat(cids, cfg.records_per_shard)]),
                          per_round, "crafted round")
    seen = after.last_seen.cpu().numpy()
    # one cache update at a round's shape, on copies
    uf, us = after.record.clone(), after.last_seen.clone()
    up, uids = (torch.from_numpy(x).to(dev) for x in (cp, cids))

    def update():
        return _update_latest(uf, us, up, uids, n_rounds + 2)
    update_fields = {"ms": cuda_ms(torch, update, 50),
                     "host_us": host_us(torch, {"u": update}, calls=50)["u"]}
    if do_profile:
        update_fields["profile"] = profile(torch, update, host_top=12)
    return {"max_drones": d, "timed_rounds": timed_rounds, "ingest_device_s": ingest_s,
            "shards_per_s": timed_rounds * d / ingest_s, **host,
            "drones_exact": drones_exact, "drones": d,
            "other_leaves_equal": len(ldb.state) - 1 - len(cache)
            + len(ldb.state.index),
            "batch_fields_equal": len(res_m._fields) + len(info_m._fields),
            "crafted": {"drones_exact": crafted_exact, "card_vs_cpu_rows_apart": 0,
                        "rows_written": int((seen == n_rounds + 1).sum()),
                        "rows_with_nan": int(np.isnan(after.record.cpu().numpy()).any(1).sum())},
            "launches": launches, "update_latest": update_fields,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}, ldb


def latest_cost(torch, dev, cfg, payloads, metas, chunks, d: int) -> dict:
    """The cache's cost on ingest, controlled: two fresh D400 stores, one
    with ``max_drones=d`` and one without, take the day's first chunks in
    turns (a warm-up chunk each, then alternating which goes first), each
    chunk timed alone with CUDA events after a synchronise. Returns each
    store's chunk ms, the medians, and the ratio of the cached store's
    shards/s to the uncached one's."""
    import dataclasses
    from repro_torch.api.session import AerialDB
    stores = {"cached": AerialDB.open(dataclasses.replace(cfg, max_drones=d), device=dev),
              "uncached": AerialDB.open(cfg, device=dev)}
    times = {k: [] for k in stores}
    for i, sl in enumerate(chunks[:9]):
        order = list(stores) if i % 2 == 0 else list(stores)[::-1]
        for name in order:
            torch.cuda.synchronize()
            ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            ev0.record()
            stores[name].ingest_rounds(payloads[sl], type(metas)(*(f[sl] for f in metas)))
            ev1.record()
            ev1.synchronize()
            if i > 0:                      # chunk 0 is the warm-up
                times[name].append(ev0.elapsed_time(ev1))
    med = {k: float(np.median(v)) for k, v in times.items()}
    return {"chunk_ms": times, "chunk_ms_median": med,
            "rounds_per_chunk": chunks[0].stop - chunks[0].start,
            "shards_per_s_ratio": med["uncached"] / med["cached"]}


def states_equal(torch, a, b, skip=()) -> list:
    """Names of the StoreState / IndexState leaves of ``a`` and ``b`` (but
    those in ``skip``) that differ in shape, dtype or bits (empty when every
    leaf is equal); ``b``'s leaves are compared on ``a``'s device."""
    def differ(x, y):
        return not bitwise_equal(torch, x, y.to(x.device))
    out = [f"index.{f}" for f in a.index._fields
           if differ(getattr(a.index, f), getattr(b.index, f))]
    return out + [f for f in a._fields if f not in ("index", *skip)
                  and differ(getattr(a, f), getattr(b, f))]


def batch_vs_twin(torch, got, want, what: str = "resilience") -> dict:
    """A faulted store's (QueryResult, QueryInfo) against its never-faulted
    twin's on every query neither overflows: count, vmin and vmax bitwise,
    vsum to rtol 1e-5. Returns the queries compared and overflowed and the
    largest vsum difference; exits non-zero, naming ``what``, on a
    mismatch."""
    (r, _), (w, _) = got, want
    keep = ~(r.overflow | w.overflow)
    if not torch.equal(r.count[keep], w.count[keep]) or not all(
            bitwise_equal(torch, getattr(r, f)[keep], getattr(w, f)[keep])
            for f in ("vmin", "vmax")):
        raise SystemExit(f"{what}: a query's count, min or max differs from "
                         "the store it is held to")
    torch.testing.assert_close(r.vsum[keep], w.vsum[keep], rtol=1e-5, atol=0,
                               equal_nan=True)
    d = (r.vsum[keep] - w.vsum[keep]).abs()
    d = d[~torch.isnan(d)]
    return {"compared": int(keep.sum()), "overflowed": int((~keep).sum()),
            "vsum_max_abs_diff": float(d.max()) if d.numel() else 0.0}


def small_repair_card_vs_cpu(torch, dev) -> dict:
    """The wrapping outage scenario of the CPU tests (8 edges, capacity 256,
    four failure domains: 2 rounds, domain 1 down for 8 rounds that wrap
    the rings, recovered without a repair) on the card and on the CPU, then
    the session's incremental repair and ``repair_state``'s full sweep of a
    clone of the pre-repair state on each: every leaf and both telemetry
    dicts equal. Exits non-zero otherwise."""
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import StoreConfig, clone_state
    from repro_torch.core.repair import repair_state
    from repro_torch.data.synthetic import CityConfig, DroneFleet, make_sites
    sites = tuple(map(tuple, make_sites(8, CityConfig(), seed=3).tolist()))
    cfg = StoreConfig(n_edges=8, sites=sites, tuple_capacity=256,
                      index_capacity=512, max_shards_per_query=64,
                      records_per_shard=8, retention_every=2,
                      n_failure_domains=4)
    out = {}
    for d in (dev, torch.device("cpu")):
        db = AerialDB.open(cfg, device=d)
        fleet = DroneFleet(12, records_per_shard=8, seed=7)
        for r in range(10):
            if r == 2:
                db.fail_device(1)
            db.insert(*fleet.next_shards())
        db.recover_device(1, repair=False)
        pre = clone_state(db.state)
        inc = db.repair()
        full = repair_state(cfg, pre, db.alive)
        out[d.type] = (db.state, inc, full)
    (s_card, i_card, f_card), (s_cpu, i_cpu, f_cpu) = out[dev.type], out["cpu"]
    bad = states_equal(torch, s_card, s_cpu) + states_equal(torch, f_card[0], f_cpu[0])
    if bad or i_card != i_cpu or f_card[1] != f_cpu[1]:
        raise SystemExit(f"resilience: the small repair differs on the card: "
                         f"{bad} {i_card} {i_cpu} {f_card[1]} {f_cpu[1]}")
    if int(s_cpu.tup_count.max()) <= 256 or i_cpu["shards_replaced"] == 0:
        raise SystemExit("resilience: the small scenario did not wrap and repair")
    return {"leaves_equal": len(s_cpu.index) + len(s_cpu) - 1,
            "incremental": i_cpu, "full_swept": f_cpu[1]["shards_swept"]}


def repair_batch_vs_plain(torch, dev, cfg, state) -> dict:
    """voronoi_assign and hash64 at the batch a full repair sends them: the
    16 x 16 slice-cell centres and 16 temporal buckets of every tracked
    shard of ``state``'s index, and the shard ids, each kernel once against
    its plain version on the same card tensors (bitwise). Exits non-zero on
    a mismatch."""
    from repro_torch.core import hashing, voronoi
    from repro_torch.core.repair import _shard_table
    from repro_torch.core.slicing import _cell_index
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops
    ent_i = state.index.ent_i.cpu().numpy()
    ent_f = state.index.ent_f.cpu().numpy()
    ev, ec, _, _, first = _shard_table(ent_i, ent_f, state.index.valid.cpu().numpy())
    f0 = torch.from_numpy(ent_f[ev[first], ec[first]]).to(dev)
    sid = torch.from_numpy(ent_i[ev[first], ec[first], :2].copy()).to(dev)
    sc = cfg.slice_cfg
    k = torch.arange(16, dtype=torch.int32, device=dev)
    ii = _cell_index(f0[:, 0], sc.lat0, sc.cell)[:, None] + k
    jj = _cell_index(f0[:, 2], sc.lon0, sc.cell)[:, None] + k
    glat = (sc.lat0 + (ii.float() + 0.5) * sc.cell)[:, :, None].expand(-1, 16, 16)
    glon = (sc.lon0 + (jj.float() + 0.5) * sc.cell)[:, None, :].expand(-1, 16, 16)
    sites = cfg.sites_array(dev)
    got = vor_ops.voronoi_assign_cuda(glat, glon, sites).reshape(-1)
    want = voronoi.voronoi_assign(torch.stack([glat.reshape(-1), glon.reshape(-1)], -1),
                                  sites)
    buckets = hashing.time_bucket(f0[:, 4], cfg.tau)[:, None] + k
    h_bad = sum(int((hash64_ops.xxh64_mod_cuda(h, lo, cfg.n_edges)
                     != hashing.xxh64_mod_plain(h, lo, cfg.n_edges)).sum())
                for h, lo in ((None, buckets), (sid[:, 0], sid[:, 1])))
    v_bad = int((got != want).sum())
    if v_bad or h_bad:
        raise SystemExit(f"resilience: at the repair batch voronoi_assign "
                         f"differs on {v_bad} points, hash64 on {h_bad} keys")
    return {"shards": int(first.size), "voronoi_points": int(got.numel()),
            "hash64_keys": int(buckets.numel() + sid.shape[0]), "mismatch": 0}


def resilience_phase(torch, dev, cfg, city, seed: int, card: str) -> dict:
    """The paper's edge-server loss (fig. 14's ``device_failure`` row) at
    D400 width: the main path's config with 4 failure domains, two sessions
    on the card taking the same 48 rounds of the same fleet; the faulted
    one loses domain 1 (20 edges) after round 24 and recovers it (the
    incremental repair) after round 48, the twin never fails. Checks, each
    fatal: (1) during the outage a 64-query AND batch (1 km x 1800 s, 4
    channels) over the last 30 minutes and over the 30 minutes before the
    failure equals the twin's on every query neither overflows, and the
    second loses replicas on the faulted store (the first matches only
    shards placed around the dead domain); (2) failing a
    dead edge and recovering an alive one leave ``ledger()`` unchanged (the
    latter runs no repair); (3) a full repair of a clone of the pre-repair
    state equals the incremental repair, every leaf; (4) the two stores'
    ``canonical_content`` is equal (no ring wraps: ``tup_overwritten`` 0
    before the repair, on rings of RESILIENCE_CAPACITY); (5) after the repair the batch equals the twin's
    with no replica lost and a completeness bound of 1, and the ledger is
    empty; (6) the small wrapping scenario equals the CPU's. Both batches'
    degraded scans (during the outage) and post-repair scans are also held
    against st_scan's plain version at this capacity (``scan_vs_plain``,
    launches not counted). Counts are set to 0 before the ingest and read
    after check 5. Then the partition leg (``partition_leg``) on a third
    store, held to the same twin; its results under ``partition``."""
    import dataclasses
    from repro_torch.api.session import AerialDB
    from repro_torch.chaos.audit import assert_content_equal, canonical_content
    from repro_torch.core.datastore import (AggSpec, clone_state, make_pred,
                                            plan_subqueries)
    from repro_torch.data.synthetic import DroneFleet, make_query_workload
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops
    mods = {"hash64": hash64_ops, "voronoi_assign": vor_ops, "st_scan": st_ops}
    t_phase = time.perf_counter()
    rcfg = dataclasses.replace(cfg, n_failure_domains=4,
                               tuple_capacity=RESILIENCE_CAPACITY)
    fleet = DroneFleet(400, city, records_per_shard=60, n_values=4, seed=seed)
    payloads, metas = fleet.next_rounds(48)

    def part(sl):
        return payloads[sl], type(metas)(*(f[sl] for f in metas))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    faulted, twin = (AerialDB.open(rcfg, device=dev) for _ in range(2))
    for db in (faulted, twin):
        db.ingest_rounds(*part(slice(0, 24)))
    faulted.fail_device(1)
    ingest_s = {}
    for name, db in (("faulted", faulted), ("twin", twin)):
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        db.ingest_rounds(*part(slice(24, 48)))
        ev1.record()
        ev1.synchronize()
        ingest_s[name] = ev0.elapsed_time(ev1) / 1e3

    # The batch's boxes over two 30-minute windows: the last (shards placed
    # around the dead domain, so none of theirs is lost) and the last before
    # the failure (shards with replicas on it).
    t_ends = {"recent": float(payloads[..., 0].max()),
              "before_failure": float(payloads[:24, ..., 0].max())}
    w = make_query_workload(np.random.default_rng(seed + 2), 64, city,
                            t_ends["recent"], 1.0, 1800.0)
    preds = {}
    for name, t_end in t_ends.items():
        t0_ = np.full(64, t_end - RECENT_S, np.float32)
        preds[name] = make_pred(q=64, **{**w, "t0": t0_, "t1": t0_ + np.float32(1800.0)},
                                has_spatial=True, has_temporal=True,
                                is_and=True, device=dev)
    spec = AggSpec(channels=(0, 1, 2, 3))

    def scan_check(db, name, when):
        """st_scan against its plain version on ``db``'s log at RESILIENCE_
        CAPACITY, at batch ``name``'s sublists planned under the session's
        mask (around the dead domain during the outage); these launches are
        not counted. Returns the largest vsum difference."""
        counts = {k: m.launches for k, m in mods.items()}
        st_, p = db.state, preds[name]
        subl, slen, _ = plan_subqueries(rcfg, st_, p, db.effective_alive)
        err = scan_vs_plain(torch, (st_.tup_f, st_.tup_sid, st_.tup_count, p,
                                    subl, slen), spec.channels,
                            rcfg.tuple_capacity, f"resilience {when}, {name}")
        for k, m in mods.items():
            m.launches = counts[k]
        return err
    during = {n: faulted.query(p, agg=spec) for n, p in preds.items()}
    lost_during = {n: int(r.replicas_lost.sum()) for n, (r, _) in during.items()}
    if lost_during["before_failure"] <= 0:
        raise SystemExit("resilience: no replica was lost during the outage")
    check1 = {n: batch_vs_twin(torch, during[n], twin.query(p, agg=spec))
              for n, p in preds.items()}
    scan_err = {"during": max(scan_check(faulted, n, "during the outage")
                              for n in preds)}

    # (2) ledger no-ops
    snap = faulted.ledger()
    faulted.fail_edges(20)                   # in domain 1: already dead
    same_after_fail = faulted.ledger() == snap
    faulted.recover_edges(0)                 # alive: no window, no repair
    if not (same_after_fail and faulted.ledger() == snap
            and faulted.last_repair is None):
        raise SystemExit(f"resilience: a no-op flip changed the ledger {snap}")

    pair = (("faulted", faulted), ("twin", twin))
    over = {n: int(db.state.tup_overwritten.sum()) for n, db in pair}
    count_max = {n: int(db.state.tup_count.max()) for n, db in pair}
    if any(over.values()):
        raise SystemExit(f"resilience: a ring wrapped {over} {count_max}")
    pre = clone_state(faulted.state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    faulted.recover_device(1)
    inc_wall = time.perf_counter() - t0
    inc, inc_s = faulted.last_repair, faulted.last_repair_seconds

    # (3) incremental == full, from a clone of the pre-repair state
    full_db = AerialDB(rcfg, pre, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = full_db.repair(full=True)
    full_wall = time.perf_counter() - t0
    full_s = full_db.last_repair_seconds
    bad = states_equal(torch, faulted.state, full_db.state)
    if bad:
        raise SystemExit(f"resilience: incremental repair != full sweep at {bad}")

    # (4) content equal to the never-faulted twin's
    t0 = time.perf_counter()
    got, want = canonical_content(faulted), canonical_content(twin)
    assert_content_equal(got, want, "resilience: ")
    content_s = time.perf_counter() - t0

    # (5) after the repair
    check5 = {}
    for name, p in preds.items():
        after = faulted.query(p, agg=spec)
        check5[name] = batch_vs_twin(torch, after, twin.query(p, agg=spec))
        res = after[0]
        if int(res.replicas_lost.max()) != 0 or not bool(
                (res.completeness_bound[~res.overflow] == 1).all()):
            raise SystemExit(f"resilience: after the repair, batch {name} "
                             f"lost {int(res.replicas_lost.max())} replicas")
    scan_err["after"] = max(scan_check(faulted, n, "after the repair")
                            for n in preds)
    ledger = faulted.ledger()
    if ledger["open_outages"] or ledger["closed_windows"] \
            or ledger["pending_sids"] or ledger["dropped_sids"]:
        raise SystemExit(f"resilience: the ledger after the repair: {ledger}")
    launches = {k: m.launches for k, m in mods.items()}
    if min(launches.values()) <= 0:
        raise SystemExit(f"resilience: a kernel never launched: {launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    batch = repair_batch_vs_plain(torch, dev, rcfg, faulted.state)
    del full_db, pre
    small = small_repair_card_vs_cpu(torch, dev)
    shards = 24 * fleet.n_drones
    faulted_s = time.perf_counter() - t_phase
    split = partition_leg(torch, dev, rcfg, part, twin, want, preds, spec,
                          scan_check, mods, fleet.n_drones, card)
    return {
        "config": {"n_failure_domains": 4, "failed_domain": 1, "failed_edges": 20,
                   "rounds": [24, 24], "tuple_capacity": rcfg.tuple_capacity},
        "tup_count_max": count_max,
        "checks": {"1_during_outage_vs_twin": True, "2_ledger_noops": True,
                   "3_incremental_equals_full": True, "4_content_equals_twin": True,
                   "5_after_repair": True, "6_small_card_vs_cpu": True},
        "during": {n: {**c, "replicas_lost_sum": lost_during[n],
                       "replicas_lost_max": int(during[n][0].replicas_lost.max()),
                       "matched_queries": int((during[n][0].count > 0).sum())}
                   for n, c in check1.items()},
        "after": check5,
        "repair_incremental": inc, "repair_incremental_seconds": inc_s,
        "repair_incremental_wall_s": inc_wall,
        "repair_full": full, "repair_full_seconds": full_s,
        "repair_full_wall_s": full_wall,
        "swept_n": {"incremental": inc["shards_swept"], "full": full["shards_swept"]},
        "content": {"edges": len(got["edges"]), "shards": len(got["index"]),
                    "tuples": int(sum(r.shape[0] for r in got["edges"])),
                    "seconds": content_s},
        "launches": launches, "st_scan_vs_plain_vsum_max_abs_diff": scan_err,
        "ingest_shards_per_s": {k: shards / v for k, v in ingest_s.items()},
        "ingest_device_s": ingest_s,
        "repair_batch_vs_plain": batch, "small_card_vs_cpu": small,
        "peak_mem_gb": peak, "faulted_s": faulted_s, "partition": split,
        "phase_s": time.perf_counter() - t_phase}


def edge_rows(state, edges: slice) -> dict:
    """Copies of every per-edge leaf's rows for ``edges``."""
    out = {f"index.{f}": getattr(state.index, f)[edges].clone()
           for f in state.index._fields}
    out.update({f: getattr(state, f)[edges].clone() for f in PER_EDGE_LEAVES})
    return out


def partition_leg(torch, dev, rcfg, part, twin, twin_content, preds, spec,
                  scan_check, mods, n_drones: int, card: str) -> dict:
    """The resilience phase's partition leg: a third store on ``rcfg`` takes
    the phase's 48 rounds, split after round 24 (``SPLIT_GROUPS``: edges
    60-79 unreachable) and healed with the incremental repair after round
    48, held to the phase's never-faulted ``twin``. Checks, each fatal:
    (P1) every per-edge leaf's rows for the far side are bitwise the same
    at the heal as at the split; (P2) during the split both batches equal
    the twin's on every query neither overflows, and the pre-split batch
    loses replicas; (P3) a full repair of a clone of the pre-heal state
    equals the heal's incremental repair, every leaf; (P4) the heal sweeps
    exactly the shards ingested during the split; (P5) the canonical
    content equals the twin's; (P6) after the heal both batches equal the
    twin's with no replica lost and a completeness bound of 1, and the
    ledger is empty. The degraded and post-heal scans are held to
    st_scan's plain version (launches not counted). Counts are set to 0
    just before the leg's ingest and read after P6."""
    from repro_torch.api.session import AerialDB
    from repro_torch.chaos.audit import assert_content_equal, canonical_content
    from repro_torch.core.datastore import clone_state
    t_leg = time.perf_counter()
    want = {n: twin.query(p, agg=spec) for n, p in preds.items()}
    near, far = SPLIT_GROUPS
    far_rows = slice(far[0], far[-1] + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    split = AerialDB.open(rcfg, device=dev)
    split.ingest_rounds(*part(slice(0, 24)))
    split.partition([near, far])
    frozen = edge_rows(split.state, far_rows)
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    split.ingest_rounds(*part(slice(24, 48)))
    ev1.record()
    ev1.synchronize()
    split_ingest_s = ev0.elapsed_time(ev1) / 1e3
    opened = split.ledger()["partition"]
    if opened != {"unreachable": far, "step": 24}:
        raise SystemExit(f"partition: the ledger holds {opened}")

    # (P2) during the split
    during = {n: split.query(p, agg=spec) for n, p in preds.items()}
    p2 = {n: batch_vs_twin(torch, during[n], want[n], "partition") for n in preds}
    lost = {n: int(r.replicas_lost.sum()) for n, (r, _) in during.items()}
    if lost["before_failure"] <= 0:
        raise SystemExit("partition: no replica was cut off during the split")
    scan_err = {"during": max(scan_check(split, n, "during the split")
                              for n in preds)}

    # (P1) the far side frozen
    now = edge_rows(split.state, far_rows)
    moved = [k for k in frozen if not bitwise_equal(torch, frozen[k], now[k])]
    if moved:
        raise SystemExit(f"partition: the unreachable edges' {moved} changed")
    del now
    over = int(split.state.tup_overwritten.sum())
    if over:
        raise SystemExit(f"partition: a ring wrapped ({over} tuples)")

    pre = clone_state(split.state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    split.heal()
    heal_wall = time.perf_counter() - t0
    inc, inc_s = split.last_repair, split.last_repair_seconds

    # (P4) the heal sweeps the split's shards
    if inc["shards_swept"] != 24 * n_drones or inc["shards_unrepairable"]:
        raise SystemExit(f"partition: the heal swept {inc['shards_swept']} "
                         f"shards, not the {24 * n_drones} of the split: {inc}")
    # (P3) incremental == full, from a clone of the pre-heal state
    full_db = AerialDB(rcfg, pre, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = full_db.repair(full=True)
    full_wall = time.perf_counter() - t0
    full_s = full_db.last_repair_seconds
    bad = states_equal(torch, split.state, full_db.state)
    if bad:
        raise SystemExit(f"partition: incremental repair != full sweep at {bad}")
    del full_db, pre

    # (P5) content equal to the never-faulted twin's
    t0 = time.perf_counter()
    got = canonical_content(split)
    assert_content_equal(got, twin_content, "partition: ")
    content_s = time.perf_counter() - t0

    # (P6) after the heal
    after = {}
    for name, p in preds.items():
        res = split.query(p, agg=spec)
        after[name] = batch_vs_twin(torch, res, want[name], "partition")
        r = res[0]
        if int(r.replicas_lost.max()) != 0 or not bool(
                (r.completeness_bound[~r.overflow] == 1).all()):
            raise SystemExit(f"partition: after the heal, batch {name} lost "
                             f"{int(r.replicas_lost.max())} replicas")
    scan_err["after"] = max(scan_check(split, n, "after the heal") for n in preds)
    ledger = split.ledger()
    empty = {"open_outages": [], "closed_windows": [], "partition": None,
             "pending_sids": 0, "dropped_sids": 0}
    if ledger != empty:
        raise SystemExit(f"partition: the ledger after the heal: {ledger}")
    launches = {k: m.launches for k, m in mods.items()}
    if min(launches.values()) <= 0:
        raise SystemExit(f"partition: a kernel never launched: {launches}")
    return {
        "card": card, "groups": [[near[0], near[-1]], [far[0], far[-1]]],
        "rounds": [24, 24],
        "checks": {"P1_far_side_frozen": True, "P2_during_split_vs_twin": True,
                   "P3_incremental_equals_full": True,
                   "P4_heal_sweeps_the_split": True,
                   "P5_content_equals_twin": True, "P6_after_heal": True},
        "frozen_leaves": len(frozen),
        "during": {n: {**c, "replicas_lost_sum": lost[n],
                       "replicas_lost_max": int(during[n][0].replicas_lost.max()),
                       "matched_queries": int((during[n][0].count > 0).sum())}
                   for n, c in p2.items()},
        "after": after, "swept_n": {"heal": inc["shards_swept"],
                                    "full": full["shards_swept"]},
        "repair_heal": inc, "repair_heal_seconds": inc_s,
        "repair_heal_wall_s": heal_wall, "repair_full": full,
        "repair_full_seconds": full_s, "repair_full_wall_s": full_wall,
        "content": {"shards": len(got["index"]), "seconds": content_s},
        "split_ingest_shards_per_s": 24 * n_drones / split_ingest_s,
        "tup_count_max": int(split.state.tup_count.max()),
        "launches": launches, "st_scan_vs_plain_vsum_max_abs_diff": scan_err,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "leg_s": time.perf_counter() - t_leg}


def adversarial_round(rng, payload: np.ndarray, rnd: int) -> tuple:
    """Round ``rnd`` of a fleet (``payload`` (D, R, 3+V)) as the drones send
    it: each record with its drone's record counter as seq; DROP_FRAC of
    the seqs never sent, PARTIAL_FRAC of the records NaN from a random value
    channel on, DUP_FRAC of the sent records sent twice, all shuffled.
    Returns (drone, seq, rows) as sent and the accepted (drone, rows), in
    the order sent, and the number of re-sends."""
    d, r, w = payload.shape
    n = d * r
    drone = np.repeat(np.arange(d, dtype=np.int64), r)
    seq = np.tile(np.arange(rnd * r, (rnd + 1) * r, dtype=np.int64), d)
    rows = payload.reshape(n, w).copy()
    start = rng.integers(0, w - 3, n)
    nan = (rng.random(n) < PARTIAL_FRAC)[:, None] \
        & (np.arange(w - 3)[None, :] >= start[:, None])
    rows[:, 3:][nan] = np.nan
    sent = np.nonzero(rng.random(n) >= DROP_FRAC)[0]
    dup = sent[rng.random(sent.size) < DUP_FRAC]
    order = np.concatenate([sent, dup])
    rng.shuffle(order)
    return (drone[order], seq[order], rows[order]), (drone[sent], rows[sent]), dup.size


def stream_checks(results, batches, specs, recs) -> tuple:
    """Every non-overflowed answer of ``results`` ((batch, spec) ->
    (QueryResult, QueryInfo)) against a numpy oracle over the accepted
    records ``recs`` (N, 3+V) float32: the count equal, min and max equal
    (NaN, where a matched record's channel is NaN, counts as a value), the
    sum to rtol 1e-5 (NaN equal). Exits non-zero otherwise; returns
    (queries checked, queries skipped for overflow)."""
    recs = recs[np.argsort(recs[:, 0], kind="stable")]
    checked = overflowed = 0
    for (bi, si), (res, _) in results.items():
        ch = [3 + c for c in specs[si].channels]
        w = batches[bi][3]
        cnt, ovf = res.count.cpu().numpy(), res.overflow.cpu().numpy()
        got = {f: getattr(res, f).cpu().numpy().reshape(64, -1)
               for f in ("vsum", "vmin", "vmax")}
        for qi in range(64):
            if ovf[qi]:
                overflowed += 1
                continue
            sub = recs[np.searchsorted(recs[:, 0], w["t0"][qi], "left"):
                       np.searchsorted(recs[:, 0], w["t1"][qi], "right")]
            m = ((w["lat0"][qi] <= sub[:, 1]) & (sub[:, 1] <= w["lat1"][qi])
                 & (w["lon0"][qi] <= sub[:, 2]) & (sub[:, 2] <= w["lon1"][qi]))
            if int(m.sum()) != int(cnt[qi]):
                raise SystemExit(f"streaming: batch {bi} query {qi}: count "
                                 f"{cnt[qi]} != oracle {int(m.sum())}")
            checked += 1
            if not m.any():
                continue
            vals = sub[m][:, ch]
            np.testing.assert_array_equal(got["vmin"][qi], vals.min(0))
            np.testing.assert_array_equal(got["vmax"][qi], vals.max(0))
            np.testing.assert_allclose(got["vsum"][qi],
                                       vals.astype(np.float64).sum(0),
                                       rtol=1e-5, equal_nan=True)
    return checked, overflowed


def streaming_phase(torch, dev, cfg, city, seed: int, card: str,
                    n_drones: int = 400, rounds: int = STREAM_ROUNDS) -> dict:
    """The paper's ingest front door (§4.4) at D400 width: the main path's
    config with the latest cache (``max_drones``), fed through
    ``IngestPipeline`` by ``rounds`` rounds of a fresh fleet made
    adversarial (``adversarial_round``), submitted in STREAM_BURSTS bursts a
    round, ``flush()`` after each round and ``flush(drain=True)`` at the
    end, with the write-ahead journal on and a seeded fault hook raising a
    transient error on FAULT_FRAC of the dispatch attempts. Checks, each
    fatal: (S1) the counters reconcile, ``accepted`` is the stream's
    distinct (drone, seq) count and ``duplicate`` its re-sends; (S2) the
    main path's three batch sizes, each window inside the last
    max(30 minutes, window), at 1 and 4 channels, against a numpy oracle
    over the accepted records (``stream_checks``); (S3) ``latest()``
    before the drain (pending records overlaid) bitwise equal to the
    oracle over every accepted record; (S4) a fresh pipeline over a fresh
    store replays the journal and drains: the same accepted count, its
    counters reconcile, and its S2 batches equal the first store's. Counts
    are set to 0 just before the first submit and read after S2."""
    import dataclasses
    import tempfile
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import AggSpec, make_pred
    from repro_torch.data.synthetic import DroneFleet, make_query_workload
    from repro_torch.ingest import (IngestPipeline, TransientDispatchError,
                                    latest_oracle_sorted)
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops
    mods = {"hash64": hash64_ops, "voronoi_assign": vor_ops, "st_scan": st_ops}
    t_phase = time.perf_counter()
    scfg = dataclasses.replace(cfg, max_drones=n_drones)
    payloads, _ = DroneFleet(n_drones, city, records_per_shard=60, n_values=4,
                             seed=seed + 3).next_rounds(rounds)
    rng = np.random.default_rng(seed + 3)
    stream = [adversarial_round(rng, payloads[r], r) for r in range(rounds)]
    acc_drone = np.concatenate([a[0] for _, a, _ in stream])
    acc_rows = np.concatenate([a[1] for _, a, _ in stream])
    resent = sum(n for _, _, n in stream)
    fault_rng = np.random.default_rng(seed + 4)

    def fault_hook(pipe, attempt):
        if fault_rng.random() < FAULT_FRAC:
            raise TransientDispatchError("injected: a dispatch lost on the link")

    t_end = float(acc_rows[:, 0].max())
    qrng = np.random.default_rng(seed + 5)
    batches = []
    for km, win in QUERY_SIZES:
        w = make_query_workload(qrng, 64, city, t_end, km, win)
        w["t0"] = qrng.uniform(t_end - max(win, RECENT_S), t_end - win,
                               64).astype(np.float32)
        w["t1"] = (w["t0"] + np.float32(win)).astype(np.float32)
        batches.append((km, win, True, w))
    specs = (AggSpec(channel=0), AggSpec(channels=(0, 1, 2, 3)))

    def run_batches(db):
        out = {}
        for bi, (_, _, _, w) in enumerate(batches):
            pred = make_pred(q=64, **w, has_spatial=True, has_temporal=True,
                             is_and=True, device=dev)
            for si, spec in enumerate(specs):
                out[(bi, si)] = db.query(pred, agg=spec)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        journal = Path(tmp) / "ingest.wal"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in mods.values():
            mod.launches = 0
        pipe = IngestPipeline(AerialDB.open(scfg, device=dev), journal=journal,
                              sleep=lambda s: None)
        pipe.fault_hook = fault_hook
        submit_s, sent, flushes, latency = 0.0, 0, [], []

        def timed_flush(**kw):
            tf = time.perf_counter()
            out = pipe.flush(**kw)
            latency.append(out["latency_s"])
            return {"wall_ms": (time.perf_counter() - tf) * 1e3,
                    **{k: out[k] for k in ("dispatches", "flushed_shards",
                                           "retries", "gave_up")}}
        t0 = time.perf_counter()
        for (d, s, rows), _, _ in stream:
            for part in np.array_split(np.arange(d.size), STREAM_BURSTS):
                ts = time.perf_counter()
                pipe.submit_arrays(d[part], s[part], rows[part, 0], rows[part, 1],
                                   rows[part, 2], rows[part, 3:])
                submit_s += time.perf_counter() - ts
            sent += d.size
            flushes.append(timed_flush())
        # (S3) latest before the drain, pending records overlaid
        t_latest = time.perf_counter()
        rec, valid = pipe.latest()
        latest_s = time.perf_counter() - t_latest
        o_rec, o_valid, _ = latest_oracle_sorted(acc_drone, acc_rows[:, 0],
                                                 acc_rows, n_drones)
        pending_at_latest = pipe.pending
        if not (np.array_equal(valid, o_valid)
                and np.array_equal(rec.view(np.int32), o_rec.view(np.int32))):
            raise SystemExit("streaming: latest() before the drain differs "
                             "from the oracle")
        drain = timed_flush(drain=True)
        end_to_end_s = time.perf_counter() - t0
        # (S1)
        rec1 = pipe.reconcile()
        if not rec1["ok"] or rec1["accepted"] != acc_drone.size \
                or rec1["duplicate"] != resent or rec1["pending"]:
            raise SystemExit(f"streaming: the counters do not reconcile: {rec1} "
                             f"(distinct {acc_drone.size}, re-sent {resent})")
        # (S2)
        results = run_batches(pipe.db)
        checked, overflowed = stream_checks(results, batches, specs, acc_rows)
        launches = {k: m.launches for k, m in mods.items()}
        if min(launches.values()) <= 0:
            raise SystemExit(f"streaming: a kernel never launched: {launches}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        journal_bytes = journal.stat().st_size
        pipe.close()
        # (S4) a fresh pipeline over a fresh store replays the journal
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay = IngestPipeline(AerialDB.open(scfg, device=dev), journal=journal)
        rep = replay.replay_journal()
        replay.flush(drain=True)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        rec2 = replay.reconcile()
        replay.close()
    if rec2["accepted"] != rec1["accepted"] or not rec2["ok"]:
        raise SystemExit(f"streaming: the replay reconciles to {rec2}, the "
                         f"stream to {rec1}")
    again = run_batches(replay.db)
    s4 = {f"{bi},{si}": batch_vs_twin(torch, again[(bi, si)], results[(bi, si)],
                                      "streaming replay")
          for bi, si in results}
    lat = np.concatenate(latency)
    return {
        "card": card, "drones": n_drones, "rounds": rounds,
        "records_sent": sent, "records_accepted": rec1["accepted"],
        "checks": {"S1_counters": True, "S2_batches_vs_oracle": True,
                   "S3_latest_vs_oracle": True, "S4_replay": True},
        "reconcile": rec1, "queries_checked": checked,
        "queries_overflowed": overflowed,
        "matched_queries": int(sum(int((r.count > 0).sum())
                                   for r, _ in results.values())),
        "nan_matched_queries": int(sum(int(torch.isnan(r.vsum).reshape(64, -1)
                                           .any(1).sum())
                                       for r, _ in results.values())),
        "submit_host_us_per_record": submit_s / sent * 1e6,
        "flush": flushes, "drain": drain,
        "flush_wall_ms_median": float(np.median([f["wall_ms"] for f in flushes])),
        "dispatches": sum(f["dispatches"] for f in flushes),
        "latency_s": {"p50": float(np.percentile(lat, 50)),
                      "p99": float(np.percentile(lat, 99)), "records": int(lat.size)},
        "records_per_s": rec1["accepted"] / end_to_end_s,
        "end_to_end_s": end_to_end_s,
        "retries": rec1["retries"], "gave_up": rec1["gave_up"],
        "latest_s": latest_s, "pending_at_latest": pending_at_latest,
        "journal_bytes": journal_bytes, "replay": rep, "replay_s": replay_s,
        "replay_vs_stream": s4, "launches": launches,
        "tup_count_max": int(pipe.db.state.tup_count.max()),
        "peak_mem_gb": peak, "phase_s": time.perf_counter() - t_phase}


def chaos_round(payload: np.ndarray, step: int) -> tuple:
    """Round ``step`` of a fleet (``payload`` (D, R, 3+V)) as the drones send
    it, in order: drone d's R records with seqs ``step * R`` on, one full
    shard a drone (fig. 19's ``_step_records``), as ``submit_arrays``
    columns."""
    d, r, w = payload.shape
    rows = payload.reshape(d * r, w)
    return (np.repeat(np.arange(d, dtype=np.int64), r),
            np.tile(np.arange(step * r, (step + 1) * r, dtype=np.int64), d),
            rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3:])


def chaos_feed(pipe, payloads: np.ndarray, step: int) -> dict:
    pipe.submit_arrays(*chaos_round(payloads[step], step))
    return pipe.flush()


def chaos_probe(torch, db, twin, pred, spec, what: str) -> dict:
    """The probe batch on the faulted store ``db``. With every edge alive
    and reachable, every query that does not overflow must have a
    completeness bound of exactly 1 and no replica lost, and equal the
    twin's (``batch_vs_twin``); degraded, only its bounds are read. Exits
    non-zero when every query overflowed."""
    res, info = db.query(pred, agg=spec)
    keep = ~res.overflow
    if not bool(keep.any()):
        raise SystemExit(f"chaos {what}: every probe query overflowed")
    bound = res.completeness_bound[keep]
    out = {"full": bool(db.effective_alive.all()),
           "min_bound": float(bound.min()),
           "replicas_lost_max": int(res.replicas_lost[keep].max()),
           "overflowed": int((~keep).sum())}
    if out["full"]:
        if not bool((bound == 1).all()) or out["replicas_lost_max"]:
            raise SystemExit(f"chaos {what}: at full health a probe query "
                             f"has bound {out['min_bound']} and lost "
                             f"{out['replicas_lost_max']} replicas")
        out.update(batch_vs_twin(torch, (res, info),
                                 twin.query(pred, agg=spec), f"chaos {what}"))
    return out


def chaos_soak(torch, dev, rcfg, payloads, soak_seed: int, pred, spec,
               n_steps: int) -> dict:
    """One seed of the soak: ``FaultPlan.random(soak_seed, ...)`` through
    ``ChaosRunner`` against a session + pipeline on ``rcfg``, a
    never-faulted twin (its own session + pipeline) fed the same rounds.
    Checks, each fatal: (C1) the plan rebuilt from its seed equals the
    first; (C2) ``counters_ok`` after every step, and at the end no give-up
    and a full reconcile; (C3) ``chaos_probe`` after every event that runs
    a repair; (C4) no ring wrapped, ``canonical_content`` equal to the
    twin's, one log entry a plan event, every repair incremental."""
    from repro_torch.api.session import AerialDB
    from repro_torch.chaos import (ChaosRunner, FaultPlan,
                                   assert_content_equal, canonical_content)
    from repro_torch.ingest import IngestPipeline
    kw = dict(n_edges=rcfg.n_edges, n_steps=n_steps, n_domains=4,
              min_alive=CHAOS_MIN_ALIVE, max_transient=2,
              require=("partition", "flush_fail"))
    plan = FaultPlan.random(soak_seed, **kw)
    if FaultPlan.random(soak_seed, **kw) != plan:                    # C1
        raise SystemExit(f"chaos seed {soak_seed}: the plan does not replay")
    events = []

    class TimedRunner(ChaosRunner):
        """The runner, with each applied event's host wall (to the end of
        its device work) and, for a repair, ``last_repair_seconds``."""

        def _apply(self, ev):
            t0 = time.perf_counter()
            entry = super()._apply(ev)
            torch.cuda.synchronize()
            row = {"step": entry["step"], "kind": entry["kind"],
                   "wall_s": time.perf_counter() - t0}
            if "repair" in entry:
                row["repair_seconds"] = self.db.last_repair_seconds
                row["shards_swept"] = entry["repair"]["shards_swept"]
            events.append(row)
            return entry

    noop = lambda s: None     # noqa: E731 — instant backoff
    db, twin = (AerialDB.open(rcfg, device=dev) for _ in range(2))
    pipe = IngestPipeline(db, max_retries=4, sleep=noop)
    twin_pipe = IngestPipeline(twin, max_retries=4, sleep=noop)
    runner = TimedRunner(plan, db, pipe)
    probes, step_s = [], []

    def probe(applied, step):
        for entry in applied:
            if entry["kind"] in CHAOS_REPAIRS:                        # C3
                probes.append({"step": step, "kind": entry["kind"],
                               **chaos_probe(torch, db, twin, pred, spec,
                                             f"seed {soak_seed} step {step}")})
    t_soak = time.perf_counter()
    for step in range(n_steps):
        t0 = time.perf_counter()
        applied = runner.advance(step)
        ev_s = time.perf_counter() - t0
        probe(applied, step)
        t0 = time.perf_counter()
        chaos_feed(pipe, payloads, step)
        rec = pipe.reconcile()                                        # C2
        step_s.append(ev_s + time.perf_counter() - t0)
        if not rec["counters_ok"]:
            raise SystemExit(f"chaos seed {soak_seed} step {step}: {rec}")
        chaos_feed(twin_pipe, payloads, step)
    probe(runner.advance(n_steps), n_steps)             # the closing events
    soak_s = time.perf_counter() - t_soak
    rec = pipe.reconcile()
    if not rec["ok"] or pipe.counters["gave_up"]:                     # C2
        raise SystemExit(f"chaos seed {soak_seed}: reconcile {rec}, "
                         f"{pipe.counters['gave_up']} give-ups")
    # C4: no ring wrapped. A repair's reclaim adds the slots it frees to
    # tup_overwritten (the retention watermark reads it), so every
    # overwritten slot must be one of the repairs' reclaimed slots.
    count_max = int(db.state.tup_count.max())
    over = int(db.state.tup_overwritten.sum())
    reclaimed = sum(e["repair"]["slots_reclaimed"] for e in runner.log
                    if "repair" in e)
    if count_max > rcfg.tuple_capacity or over != reclaimed:
        raise SystemExit(f"chaos seed {soak_seed}: a ring wrapped "
                         f"({count_max} tuples on the fullest; {over} slots "
                         f"overwritten, {reclaimed} reclaimed by repairs)")
    t0 = time.perf_counter()
    got = canonical_content(db)
    assert_content_equal(got, canonical_content(twin),
                         f"chaos seed {soak_seed}: ")
    content_s = time.perf_counter() - t0
    log = runner.log
    modes = {e["repair"]["mode"] for e in log if e["kind"] in CHAOS_REPAIRS}
    if [(e["step"], e["kind"]) for e in log] != \
            [(e.step, e.kind) for e in plan.events] or modes != {"incremental"}:
        raise SystemExit(f"chaos seed {soak_seed}: the log {runner.to_json()}")
    runner.to_json()      # raises unless every logged value is plain JSON
    degraded = [p["min_bound"] for p in probes if not p["full"]]
    return {
        "seed": soak_seed, "events": len(plan.events),
        "kinds": dict(Counter(plan.kinds())),
        "plan": plan.to_rows(),
        "checks": {"C1_plan_replays": True, "C2_counters": True,
                   "C3_probes": True, "C4_converged": True},
        "step_wall_s": {"p50": float(np.median(step_s)),
                        "max": float(np.max(step_s))},
        "event_walls": events,
        "repair_wall_s": float(sum(e["wall_s"] for e in events
                                   if "repair_seconds" in e)),
        "shards_swept": int(sum(e.get("shards_swept", 0) for e in events)),
        "probes": len(probes), "full_health_probes": len(probes) - len(degraded),
        "degraded_min_bound": min(degraded) if degraded else None,
        "probe_queries_overflowed_max": max(p["overflowed"] for p in probes),
        "probe_vsum_max_abs_diff": max((p.get("vsum_max_abs_diff", 0.0)
                                        for p in probes), default=0.0),
        "reconcile": {k: rec[k] for k in ("accepted", "flushed_records",
                                          "pending", "stored_tuples",
                                          "retries", "gave_up")},
        "tup_count_max": count_max, "slots_reclaimed": reclaimed,
        "content_shards": len(got["index"]),
        "content_s": content_s, "soak_s": soak_s}


def chaos_crash_leg(torch, dev, rcfg, payloads) -> dict:
    """(C5) A ``pipeline_crash`` armed by the runner at step 1 of a 2-step
    plan on a journaled pipeline fires in step 1's flush; a fresh session
    and pipeline replay the journal and drain. Fatal unless the replay
    loses no acknowledged record, reconciles, and holds the content of a
    never-crashed store fed the same two rounds."""
    import tempfile
    from repro_torch.api.session import AerialDB
    from repro_torch.chaos import (ChaosRunner, FaultPlan,
                                   assert_content_equal, canonical_content)
    from repro_torch.ingest import IngestPipeline, PipelineCrash
    noop = lambda s: None     # noqa: E731 — instant backoff
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "ingest.wal"
        pipe = IngestPipeline(AerialDB.open(rcfg, device=dev), journal=path,
                              sleep=noop)
        chaos_feed(pipe, payloads, 0)
        runner = ChaosRunner(FaultPlan(events=((1, "pipeline_crash", ()),),
                                       n_steps=2), pipe.db, pipe)
        runner.advance(1)
        try:
            chaos_feed(pipe, payloads, 1)
            raise SystemExit("chaos crash leg: the injected crash did not fire")
        except PipelineCrash:
            pass
        acked = pipe.counters["accepted"]
        pipe.close()
        del pipe
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay = IngestPipeline(AerialDB.open(rcfg, device=dev), journal=path,
                                sleep=noop)
        rep = replay.replay_journal()
        replay.flush(drain=True)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        rec = replay.reconcile()
        replay.close()
    lost = acked - rec["flushed_records"]
    ref = IngestPipeline(AerialDB.open(rcfg, device=dev), sleep=noop)
    for step in range(2):
        chaos_feed(ref, payloads, step)
    assert_content_equal(canonical_content(replay.db), canonical_content(ref.db),
                         "chaos crash leg: ")
    if not rec["ok"] or lost:
        raise SystemExit(f"chaos crash leg: lost {lost}, reconcile {rec}")
    return {"acked": acked, "journal_records": rep["journal_records"],
            "replayed": rep["accepted"], "already_seen": rep["already_seen"],
            "lost": lost, "replay_s": replay_s}


def chaos_small_card_vs_cpu(torch, dev) -> dict:
    """(C6) The reference chaos tests' smoke plan (``CHAOS_SMOKE``: 8 edges,
    4 failure domains, 2048-slot rings, 8-record shards, 12 drones a tick)
    through the runner on the card and on the CPU: every state leaf
    bitwise, the logs byte-identical, the counters equal. Exits non-zero
    otherwise."""
    from repro_torch.api.session import AerialDB
    from repro_torch.chaos import ChaosRunner, FaultPlan
    from repro_torch.core.datastore import StoreConfig
    from repro_torch.data.synthetic import CityConfig, make_sites
    from repro_torch.ingest import IngestPipeline
    sites = tuple(map(tuple, make_sites(8, CityConfig(), seed=3).tolist()))
    cfg = StoreConfig(n_edges=8, sites=sites, tuple_capacity=2048,
                      index_capacity=512, max_shards_per_query=64,
                      records_per_shard=8, retention_every=2,
                      n_failure_domains=4)
    out = {}
    for d in (dev, torch.device("cpu")):
        pipe = IngestPipeline(AerialDB.open(cfg, device=d), max_retries=4,
                              sleep=lambda s: None)
        runner = ChaosRunner(FaultPlan(events=CHAOS_SMOKE, n_steps=4),
                             pipe.db, pipe)

        def tick(step, pipe=pipe):
            rng = np.random.default_rng((0, step))
            seq = np.tile(np.arange(8), 12) + step * 8
            pipe.submit_arrays(np.repeat(np.arange(12), 8), seq,
                               seq + step * 0.25, rng.uniform(12.90, 13.00, 96),
                               rng.uniform(77.50, 77.62, 96),
                               rng.normal(size=(96, 4)))
            pipe.flush()
        runner.run(tick)
        out[d.type] = (pipe, runner.to_json())
    (card, card_log), (cpu, cpu_log) = out[dev.type], out["cpu"]
    bad = states_equal(torch, card.db.state, cpu.db.state)
    if bad or card_log != cpu_log or card.counters != cpu.counters \
            or not card.reconcile()["ok"]:
        raise SystemExit(f"chaos: the smoke plan differs on the card: {bad}")
    return {"leaves_equal": len(cpu.db.state.index) + len(cpu.db.state) - 1,
            "log_bytes": len(card_log), "retries": card.counters["retries"]}


def chaos_phase(torch, dev, cfg, city, seed: int, card: str,
                seeds=CHAOS_SEEDS, n_steps: int = CHAOS_STEPS,
                n_drones: int = 400, capacity: int = RESILIENCE_CAPACITY) -> dict:
    """Fig. 19's chaos soak at D400 width: the resilience phase's config
    (4 failure domains, ``capacity``-slot rings), for each seed a random
    plan over ``n_steps`` rounds of a fresh ``n_drones`` fleet
    (``chaos_soak``: checks C1-C4), the seeds one after another with the
    stores freed between them; then the crash leg (C5) and the smoke plan
    on the card against the CPU (C6). The probe batch: 64 AND queries, 1 km
    x 1800 s, 4 channels, windows spread over the rounds. Counts are set to
    0 just before the first soak and read after the last."""
    import dataclasses
    from repro_torch.core.datastore import AggSpec, make_pred
    from repro_torch.data.synthetic import DroneFleet, make_query_workload
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops
    mods = {"hash64": hash64_ops, "voronoi_assign": vor_ops, "st_scan": st_ops}
    t_phase = time.perf_counter()
    rcfg = dataclasses.replace(cfg, n_failure_domains=4, tuple_capacity=capacity)
    spec = AggSpec(channels=(0, 1, 2, 3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    soaks, payloads = [], None
    for i, s in enumerate(seeds):
        payloads, _ = DroneFleet(n_drones, city, records_per_shard=60,
                                 n_values=4, seed=seed + 10 * (i + 1)
                                 ).next_rounds(n_steps)
        t = payloads[..., 0]
        w = make_query_workload(np.random.default_rng(seed + 7), 64, city,
                                float(t.max()), 1.0, 1800.0)
        w["t0"] = np.random.default_rng(seed + 8).uniform(
            float(t.min()), float(t.max()) - 1800.0, 64).astype(np.float32)
        w["t1"] = (w["t0"] + np.float32(1800.0)).astype(np.float32)
        pred = make_pred(q=64, **w, has_spatial=True, has_temporal=True,
                         is_and=True, device=dev)
        soaks.append(chaos_soak(torch, dev, rcfg, payloads, s, pred, spec,
                                n_steps))
        torch.cuda.empty_cache()
    launches = {k: m.launches for k, m in mods.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    soaks_s = time.perf_counter() - t_phase
    crash = chaos_crash_leg(torch, dev, rcfg, payloads)
    torch.cuda.empty_cache()
    small = chaos_small_card_vs_cpu(torch, dev)
    if min(launches.values()) <= 0:
        raise SystemExit(f"chaos: a kernel never launched: {launches}")
    return {
        "card": card, "drones": n_drones, "steps": n_steps,
        "config": {"n_failure_domains": 4, "tuple_capacity": rcfg.tuple_capacity,
                   "min_alive": CHAOS_MIN_ALIVE, "max_transient": 2,
                   "max_retries": 4},
        "checks": {f"seed_{r['seed']}": r.pop("checks") for r in soaks}
        | {"C5_crash_replay": True, "C6_smoke_card_vs_cpu": True},
        "seeds": soaks, "crash": crash, "smoke_card_vs_cpu": small,
        "launches": launches, "peak_mem_gb": peak, "soaks_s": soaks_s,
        "phase_s": time.perf_counter() - t_phase}


def scan_vs_plain(torch, args_scan, channels, cap: int, what: str,
                  want_nan: bool = False) -> float:
    """st_scan's kernel against its plain version on ``args_scan``: count,
    vmin and vmax bitwise (NaN where the plain version has NaN), vsum to
    rtol 1e-5, and a second kernel call bitwise equal to the first. Exits
    non-zero on a mismatch (or, with ``want_nan``, when no NaN reached the
    plain version's minima); returns the largest vsum difference."""
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.st_scan.ref import st_scan_ref
    rows = tuple(3 + c for c in channels)
    got = st_ops.st_scan_cuda(*args_scan, rows, cap)
    again = st_ops.st_scan_cuda(*args_scan, rows, cap)
    want = st_scan_ref(*args_scan, channels=channels, valid_c=cap)
    try:
        if not torch.equal(got[0], want[0]):
            raise AssertionError("count differs")
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0,
                                   equal_nan=True)
        for g, x in zip(got[2:], want[2:]):
            torch.testing.assert_close(g, x, rtol=0, atol=0, equal_nan=True)
    except AssertionError as err:
        raise SystemExit(f"st_scan differs from plain ({what}, K {len(rows)}): "
                         f"{err}")
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, again)):
        raise SystemExit(f"st_scan ({what}): a second call gave other bits")
    if want_nan and not torch.isnan(want[2]).any():
        raise SystemExit(f"st_scan ({what}): no NaN reached the plain minima")
    d = (got[1] - want[1]).abs()
    d = d[~torch.isnan(d)]
    return float(d.max()) if d.numel() else 0.0


def st_scan_phase(torch, dev, cfg, st, alive, batches, specs) -> dict:
    """st_scan's kernel against its plain version on the main path's scan
    inputs (the three batches at 1 and 4 channels), on a copy of the day's
    log with NaN in a channel of every 7th matched slot (and of some
    unmatched ones), and on a copy rolled by a third of the ring with every
    count above capacity; then its device time at each batch and channel
    count beside the bytes it must move: five hot words a live slot of a
    selected edge, K channel words a slot some query matched (the plain
    version's masks), the listed entries, the lengths, the predicates and
    the outputs. Exits non-zero on any mismatch."""
    from repro_torch.core.datastore import make_pred, plan_subqueries
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.st_scan.ref import matched_slots, st_scan_ref
    cap = cfg.tuple_capacity
    q = 64
    channel_sets = {1: specs[0].channels, 4: specs[1].channels}
    scan_err, checks, scans = 0.0, 0, []
    for bi in range(3):
        p = make_pred(q=q, **batches[bi][3], has_spatial=True,
                      has_temporal=True, is_and=True, device=dev)
        subl, slen, _ = plan_subqueries(cfg, st, p, alive)
        args_scan = (st.tup_f, st.tup_sid, st.tup_count, p, subl, slen)
        for chans in channel_sets.values():
            scan_err = max(scan_err, scan_vs_plain(torch, args_scan, chans, cap,
                                                   f"batch {bi}"))
            checks += 1
        scans.append((args_scan, matched_slots(*args_scan, valid_c=cap)))
    args_scan, matched = scans[2]
    nan_f = st.tup_f.clone()
    hit = matched.nonzero()[::7]
    nan_f[hit[:, 0], 3, hit[:, 1]] = float("nan")
    nan_f[:, 4, ::1009] = float("nan")
    scan_vs_plain(torch, (nan_f, *args_scan[1:]), specs[1].channels, cap,
                  "NaN copy", want_nan=True)
    del nan_f
    rolled = (torch.roll(st.tup_f[..., :cap], cap // 3, dims=2).contiguous(),
              torch.roll(st.tup_sid[..., :cap], cap // 3, dims=2).contiguous(),
              torch.full_like(st.tup_count, 3 * cap))
    scan_vs_plain(torch, (*rolled, *args_scan[3:]), specs[1].channels, cap,
                  "rolled copy")
    checks += 2
    del rolled

    scan_rows = {k: tuple(3 + c for c in ch) for k, ch in channel_sets.items()}
    n_valid = torch.clamp(st.tup_count, max=cap).double()
    per_batch = []
    for bi, (a, matched) in enumerate(scans):
        subl, slen = a[4], a[5]
        selected = (slen != 0).any(dim=0)
        live = float((n_valid * selected).sum())
        n_matched = int(matched.sum())
        listed = int(slen.clamp(0, subl.shape[2]).sum())
        row = {"batch": f"{batches[bi][0]} km x {batches[bi][1]:.0f} s",
               "selected_edges": int(selected.sum()), "live_slots": live,
               "matched_slots": n_matched, "listed_entries": listed}
        for k, rows_k in scan_rows.items():
            nbytes = (live * 5 + n_matched * k) * 4 + listed * 8 \
                + slen.numel() * 4 + q * 16 * 4 + slen.numel() * 4 * (1 + 3 * k)
            row[f"k{k}_bytes"] = nbytes
            row[f"k{k}_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            row[f"k{k}_device_ms"] = device_ms(
                torch, lambda: st_ops.st_scan_cuda(*a, rows_k, cap), 10,
                "st_scan_kernel")
        per_batch.append(row)
    a = scans[2][0]
    rows = scan_rows[4]
    # the earlier count, for comparison: nine words every live slot of a
    # selected edge, every list entry
    old_bytes = per_batch[2]["live_slots"] * (5 + len(rows)) * 4 \
        + (a[4].numel() + a[5].numel()) * 4 + a[5].numel() * 4 * (1 + 3 * len(rows))
    return {
        "rows": rows, "err": scan_err, "checks": checks, "batches": per_batch,
        "bytes": per_batch[2]["k4_bytes"], "old_bytes": old_bytes,
        "device_ms": per_batch[2]["k4_device_ms"],
        "ms": cuda_ms(torch, lambda: st_ops.st_scan_cuda(*a, rows, cap), 20),
        "k1_ms": cuda_ms(torch, lambda: st_ops.st_scan_cuda(
            *a, scan_rows[1], cap), 20),
        "plain_ms": cuda_ms(torch, lambda: st_scan_ref(
            *a, channels=specs[1].channels, valid_c=cap), 1)}


def flash_vs_plain(torch, dev, seed: int) -> dict:
    """flash_attention's kernels against their plain version on the card:
    fp32 at the JAX package's kernel-test shapes, decode rows and a ragged
    size (to FLASH_F32_TOL), bf16 at the serve shapes, decode rows and a
    ragged d-128 case (to FLASH_BF16_TOL), each bf16 case through the
    kernel the wrapper chooses and through every kernel that takes it,
    forced; the decode kernel twice, bitwise. Exits non-zero on any
    mismatch or on a call that went to another kernel than expected;
    returns the largest errors by dtype and by bf16 kernel."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(seed)
    # (b, sq, skv, h, kv, dh, causal, q_offset)
    f32_cases = [(1, 256, 256, 4, 4, 64, True, 0),
                 (2, 256, 256, 8, 2, 32, True, 0),      # GQA group 4
                 (1, 384, 384, 4, 1, 64, False, 0),     # MQA, bidirectional
                 (1, 128, 128, 2, 2, 128, True, 0),
                 (2, 77, 131, 4, 2, 64, True, 54),      # ragged Sq and Skv
                 (2, 77, 131, 4, 2, 64, False, 0)]
    f32_cases += [(SERVE_BATCH, 1, MAX_SEQ, 16, 8, 128, True, p)
                  for p in (0, 63, 64, 191, 255)]
    bf16_cases = [(SERVE_BATCH, PREFILL_LEN, PREFILL_LEN, 16, 8, 128, True, 0),
                  (2, 77, 131, 4, 2, 128, True, 54),    # ragged, d 128
                  (SERVE_BATCH, 1, MAX_SEQ, 16, 8, 128, True, 191),
                  (SERVE_BATCH, 1, MAX_SEQ, 16, 8, 128, True, 0),
                  (SERVE_BATCH, 1, LONG_SEQ, 16, 8, 128, True, LONG_SEQ - 1),
                  (2, 1, MAX_SEQ, 40, 8, 128, True, 100)]   # qwen3-14b heads
    errs = {}
    n_calls = 0
    for dtype, cases, tol in ((torch.float32, f32_cases, FLASH_F32_TOL),
                              (torch.bfloat16, bf16_cases, FLASH_BF16_TOL)):
        worst = 0.0
        for case in cases:
            b, sq, skv, h, kv, dh, causal, off = case
            q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                       .to(dev, dtype) for shape in ((b, sq, h, dh), (b, skv, kv, dh),
                                                     (b, skv, kv, dh)))
            want = flash_attention_ref(q, k, v, causal=causal, q_offset=off)
            chosen = fops._variant(q, k, v)
            forced = () if dtype != torch.bfloat16 else \
                (chosen, "mma_sync") if chosen != "mma_sync" else ("mma_sync",)
            for variant in (None, *forced):
                before = dict(fops.launches_by_variant)
                got = fops.flash_attention_cuda(q, k, v, causal=causal,
                                                q_offset=off, variant=variant)
                ran = variant or chosen
                if fops.launches_by_variant[ran] != before[ran] + 1:
                    raise SystemExit(f"flash_attention {case}: variant {variant} "
                                     f"did not launch {ran}")
                err = (got.float() - want.float()).abs()
                bad = int((err > tol + tol * want.float().abs()).sum())
                if bad or not torch.isfinite(got).all():
                    raise SystemExit(f"flash_attention {dtype} {ran} {case}: {bad} "
                                     f"elements beyond {tol}, max err {float(err.max())}")
                if ran == "decode" and not torch.equal(got, fops.flash_attention_cuda(
                        q, k, v, causal=causal, q_offset=off, variant="decode")):
                    raise SystemExit(f"flash_attention decode {case}: a second "
                                     "call gave other bits")
                worst = max(worst, float(err.max()))
                if dtype == torch.bfloat16:
                    key = f"bfloat16_{ran}"
                    errs[key] = max(errs.get(key, 0.0), float(err.max()))
                n_calls += 1
        errs[str(dtype).removeprefix("torch.")] = worst
    phase("flash_vs_plain", f32_cases=len(f32_cases), bf16_cases=len(bf16_cases),
          kernel_calls=n_calls, max_abs_err=errs, f32_tol=FLASH_F32_TOL,
          bf16_tol=FLASH_BF16_TOL)
    return errs


def serve(torch, dev, seed: int, do_profile: bool) -> dict:
    """The LM serving path at full width: prefill_step, then Engine.generate
    twice. Returns the flash launch count of these runs."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train.train_loop import make_serve_steps

    class TimedEngine(Engine):
        """Records CUDA events around every decode step and keeps the logits
        after the last prompt token."""
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.events, self.prompt_logits = [], None

        def _step(self, cache, tokens, pos):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            cache, logits = super()._step(cache, tokens, pos)
            e1.record()
            self.events.append((e0, e1))
            if pos == PROMPT_LEN - 1:
                self.prompt_logits = logits.clone()
            return cache, logits

    cfg = get_config(SERVE_ARCH)
    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    n_params = sum(int(x.numel()) for x in _leaves(params))
    engine = TimedEngine(model, params, ServeConfig(
        max_new_tokens=NEW_TOKENS, max_seq=MAX_SEQ))
    del params                      # the engine keeps the bf16 copy
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eparams = engine.params
    prefill_step, _ = make_serve_steps(model)
    rng = np.random.default_rng(seed + 7)
    long_prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_BATCH, PREFILL_LEN)).astype(np.int32)).to(dev)
    prompts = rng.integers(0, cfg.vocab, (SERVE_BATCH, PROMPT_LEN)).astype(np.int32)

    # prefill_step on 8 x 2048 tokens: one warm-up, then timed runs.
    fops.launches = 0
    fops.launches_by_variant = dict.fromkeys(fops.VARIANTS, 0)
    prefill_step(eparams, {"tokens": long_prompts})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        lg = prefill_step(eparams, {"tokens": long_prompts})
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    prefill_launches = fops.launches
    prefill_by_variant = dict(fops.launches_by_variant)
    if prefill_launches != 4 * cfg.n_layers or not torch.isfinite(lg).all() \
            or lg.shape != (SERVE_BATCH, cfg.vocab_padded) \
            or prefill_by_variant["sm90"] != prefill_launches:
        raise SystemExit(f"prefill: {prefill_launches} flash launches "
                         f"({prefill_by_variant}), logits {tuple(lg.shape)} "
                         f"finite={bool(torch.isfinite(lg).all())}")
    ms = float(np.median(times))
    phase("serve_prefill", arch=SERVE_ARCH, params=n_params,
          batch=SERVE_BATCH, seq=PREFILL_LEN, init_s=init_s,
          prefill_ms=times, prefill_p50_ms=ms,
          prefill_tokens_per_s=SERVE_BATCH * PREFILL_LEN / (ms / 1e3),
          peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
          flash_launches=prefill_launches, flash_by_variant=prefill_by_variant)

    # Engine.generate: 8 requests, 128-token prompts, 64 new tokens.
    ref_logits = prefill_step(eparams, {"tokens": torch.from_numpy(prompts).to(dev)})
    torch.cuda.reset_peak_memory_stats()
    fops.launches = 0
    fops.launches_by_variant = dict.fromkeys(fops.VARIANTS, 0)
    w0 = time.perf_counter()
    ids = engine.generate(prompts)
    wall = time.perf_counter() - w0
    gen_launches = fops.launches
    gen_by_variant = dict(fops.launches_by_variant)
    want_launches = cfg.n_layers * (PROMPT_LEN + NEW_TOKENS)
    if gen_launches != want_launches or gen_by_variant["decode"] != want_launches:
        raise SystemExit(f"generate: {gen_launches} flash launches "
                         f"({gen_by_variant}), expected {want_launches} "
                         "through the decode kernel")
    if ids.shape != (SERVE_BATCH, NEW_TOKENS) or ids.min() < 0 \
            or ids.max() >= cfg.vocab:
        raise SystemExit(f"generate: ids {ids.shape} in [{ids.min()}, {ids.max()}]")
    step_ms = [e0.elapsed_time(e1) for e0, e1 in engine.events]
    ev = engine.events
    prompt_ms = ev[0][0].elapsed_time(ev[PROMPT_LEN - 1][1])
    decode_ms = ev[PROMPT_LEN][0].elapsed_time(ev[-1][1])
    diff = (engine.prompt_logits.float() - ref_logits.float()).abs()
    max_diff = float(diff[:, :cfg.vocab].max())
    agree = int((engine.prompt_logits.argmax(-1) == ref_logits.argmax(-1)).sum())
    peak = torch.cuda.max_memory_allocated() / 2**30
    again = engine.generate(prompts)
    deterministic = bool(np.array_equal(ids, again))
    phase("serve_generate", batch=SERVE_BATCH, prompt_len=PROMPT_LEN,
          new_tokens=NEW_TOKENS, max_seq=MAX_SEQ, wall_s=wall,
          prompt_phase_ms=prompt_ms,
          decode_step_p50_ms=float(np.median(step_ms[PROMPT_LEN:])),
          decode_step_ms_min_max=[float(min(step_ms[PROMPT_LEN:])),
                                  float(max(step_ms[PROMPT_LEN:]))],
          generated_tokens_per_s=SERVE_BATCH * NEW_TOKENS / (decode_ms / 1e3),
          peak_mem_gb=peak, flash_launches=gen_launches,
          flash_by_variant=gen_by_variant,
          deterministic=deterministic,
          prefill_vs_decode_max_abs_diff=max_diff,
          prefill_vs_decode_tol=PREFILL_DECODE_TOL,
          first_tokens_agree=agree, first_ids=ids[:, 0].tolist())
    if not deterministic:
        raise SystemExit("generate: a second run gave other ids")
    if not np.isfinite(max_diff) or max_diff > PREFILL_DECODE_TOL:
        raise SystemExit(f"generate: logits after the prompt differ from "
                         f"prefill_step's by {max_diff} > {PREFILL_DECODE_TOL}")

    if do_profile:
        batch = {"tokens": long_prompts}
        phase("profile_prefill", **profile(torch, lambda: prefill_step(eparams, batch)))
        cache = model.init_cache(SERVE_BATCH, MAX_SEQ)
        tok = torch.from_numpy(prompts[:, :1]).to(dev)
        phase("profile_decode_step", **profile(
            torch, lambda: model.decode_step(eparams, cache, {"tokens": tok},
                                             PROMPT_LEN + NEW_TOKENS // 2)))
    return {v: prefill_by_variant[v] + gen_by_variant[v] for v in fops.VARIANTS}


def flash_timings(torch, dev, seed: int) -> dict:
    """flash_attention at the serve path's prefill shape (the sm90 kernel
    and the mma_sync kernel, both forced) and at two decode shapes, 192
    keys of a 256-slot cache and 4096 of 4096 (the decode kernel and the
    mma_sync kernel, both forced), its plain version and SDPA (timed as the
    yardstick only), each beside the bound of the same work. ``*ms`` is
    the call time, wrapper included; ``*device_ms`` the kernel's own device
    time a launch."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(seed)
    b, h, kv, d = SERVE_BATCH, 16, 8, 128

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dev, torch.bfloat16)

    def kernel(variant, q, k, v, **kw):
        return lambda: fops.flash_attention_cuda(q, k, v, causal=True,
                                                 variant=variant, **kw)

    out = {}
    # prefill: S = 2048, causal
    q, k, v = rand(b, PREFILL_LEN, h, d), rand(b, PREFILL_LEN, kv, d), rand(b, PREFILL_LEN, kv, d)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    s = PREFILL_LEN
    flops = 4 * b * h * d * s * (s + 1) / 2
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    out["prefill"] = {
        "ms": cuda_ms(torch, kernel("sm90", q, k, v), 20),
        "device_ms": device_ms(torch, kernel("sm90", q, k, v), 10, "flash_fwd_sm90"),
        "mma_sync_ms": cuda_ms(torch, kernel("mma_sync", q, k, v), 20),
        "mma_sync_device_ms": device_ms(torch, kernel("mma_sync", q, k, v), 10,
                                        "flash_fwd_bf16"),
        "plain_ms": cuda_ms(torch, lambda: flash_attention_ref(q, k, v, causal=True), 3),
        "library_ms": cuda_ms(torch, sdpa, 20),
        "library_device_ms": device_ms(torch, sdpa, 10),
        "flops": flops, "bytes": nbytes,
        **_bound(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)}
    # decode: Sq = 1 at the last position of the generate run (191 of a
    # 256-slot cache), and at the last of a 4096-slot cache
    for name, slots, pos in (("decode", MAX_SEQ, PROMPT_LEN + NEW_TOKENS - 1),
                             ("decode_long", LONG_SEQ, LONG_SEQ - 1)):
        q, k, v = rand(b, 1, h, d), rand(b, slots, kv, d), rand(b, slots, kv, d)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x[:, :pos + 1].transpose(1, 2).contiguous() for x in (k, v))
        flops = 4 * b * h * d * (pos + 1)
        nbytes = 2 * (2 * q.numel() + 2 * b * (pos + 1) * kv * d)
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
        host = host_us(torch, {
            "decode": kernel("decode", q, k, v, q_offset=pos),
            "mma_sync": kernel("mma_sync", q, k, v, q_offset=pos)})
        out[name] = {
            "host_us": host["decode"], "mma_sync_host_us": host["mma_sync"],
            "keys": pos + 1, "slots": slots,
            "n_split": fops.decode_splits(b, kv, pos + 1),
            "ms": cuda_ms(torch, kernel("decode", q, k, v, q_offset=pos), 200),
            "device_ms": device_ms(torch, kernel("decode", q, k, v, q_offset=pos),
                                   50, "flash_decode"),
            "mma_sync_ms": cuda_ms(torch, kernel("mma_sync", q, k, v, q_offset=pos), 200),
            "mma_sync_device_ms": device_ms(
                torch, kernel("mma_sync", q, k, v, q_offset=pos), 50, "flash_fwd_bf16"),
            "plain_ms": cuda_ms(torch, lambda: flash_attention_ref(
                q, k, v, causal=True, q_offset=pos), 20),
            "library_ms": cuda_ms(torch, sdpa, 200),
            "library_device_ms": device_ms(torch, sdpa, 50),
            "flops": flops, "bytes": nbytes,
            **_bound(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)}
    return out


def _bound(ops_s: float, bytes_s: float) -> dict:
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s > bytes_s else "bytes"}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=288,
                    help="collection rounds to ingest (288 = one day)")
    ap.add_argument("--chunk", type=int, default=24,
                    help="rounds per ingest_rounds call")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--profile", action="store_true",
                    help="after each main path, print the device-time "
                         "breakdown (torch.profiler) of one ingest chunk "
                         "(into the main and the cached store), one "
                         "4-channel query batch, one prefill and one "
                         "decode step")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.api.session import AerialDB
    from repro_torch.core import hashing, voronoi
    from repro_torch.core.datastore import AggSpec, StoreConfig, make_pred
    from repro_torch.data.synthetic import (CityConfig, DroneFleet,
                                            make_query_workload, make_sites)
    from repro_torch.kernels import build
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.hash64.ref import xxh64_mod_py
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops
    from repro_torch.kernels.voronoi_assign.ref import (top2_relative_gap,
                                                        voronoi_assign_ref)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. environment --------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    build_s = build.build_all()
    phase("environment", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
          build_s=build_s,
          ptxas={k: build.ptxas_report(k) for k in build.KERNELS})

    # -- 2. hash64 and voronoi against their plain versions ----------------
    rng = np.random.default_rng(args.seed)
    n_keys = 1 << 20
    hi = torch.from_numpy(rng.integers(-2**31, 2**31, n_keys).astype(np.int32)).to(dev)
    lo = torch.from_numpy(rng.integers(-2**31, 2**31, n_keys).astype(np.int32)).to(dev)
    hash_bad = hash_keys = 0
    for n in (1, 8, 80, 65521, 65535):
        # views at their own 4-byte offsets go to the kernel without a copy
        for h, l in ((hi, lo), (None, lo), (hi[3:], lo[1:-2]), (None, lo[1:])):
            got = hash64_ops.xxh64_mod_cuda(h, l, n)
            want = hashing.xxh64_mod_plain(h, l, n)
            hash_bad += int((got != want).sum())
            hash_keys += l.numel()
    few = 1000
    got = hash64_ops.xxh64_mod_cuda(hi[:few], lo[:few], 80).cpu().numpy()
    oracle_bad = int((got != xxh64_mod_py(hi[:few].cpu().numpy(),
                                          lo[:few].cpu().numpy(), 80)).sum())
    if hash_bad or oracle_bad:
        raise SystemExit(f"hash64 disagrees: {hash_bad} vs plain, "
                         f"{oracle_bad} vs oracle")

    city = CityConfig()
    sites_np = make_sites(80, city, seed=3)
    sites = torch.from_numpy(sites_np).to(dev)
    cell = 0.01     # the slice grid: every cell centre of the city
    ci = np.arange(int(city.lat_min / cell), int(city.lat_max / cell) + 1)
    cj = np.arange(int(city.lon_min / cell), int(city.lon_max / cell) + 1)
    glat = ((ci[:, None] + 0.5) * cell + 0 * cj[None, :]).astype(np.float32)
    glon = ((cj[None, :] + 0.5) * cell + 0 * ci[:, None]).astype(np.float32)
    la, lo_c = torch.from_numpy(glat).to(dev), torch.from_numpy(glon).to(dev)
    got = vor_ops.voronoi_assign_cuda(la, lo_c, sites).reshape(-1)
    pts = torch.stack([la.reshape(-1), lo_c.reshape(-1)], -1)
    plain = voronoi.voronoi_assign(pts, sites)
    pts_np = pts.cpu().numpy()
    clear = top2_relative_gap(pts_np, sites_np) > 1e-6
    vor_bad = int((got != plain)[torch.from_numpy(clear).to(dev)].sum())
    vor_oracle_bad = int((got.cpu().numpy() != voronoi_assign_ref(
        pts_np, sites_np))[clear].sum())
    if vor_bad or vor_oracle_bad:
        raise SystemExit(f"voronoi_assign disagrees: {vor_bad} vs plain, "
                         f"{vor_oracle_bad} vs float64 oracle")
    phase("kernels_vs_plain", hash64_keys=hash_keys, hash64_mismatch=0,
          hash64_oracle_keys=few, voronoi_points=int(pts.shape[0]),
          voronoi_clear=int(clear.sum()),
          voronoi_mismatch_all=int((got != plain).sum()))

    # -- 3. the main path at full width ----------------------------------
    cfg = StoreConfig(n_edges=80, sites=tuple(map(tuple, sites_np.tolist())),
                      tuple_capacity=1 << 18, index_capacity=1 << 15,
                      max_shards_per_query=128, records_per_shard=60,
                      n_values=4, replication=3, planner="min_shards")
    fleet = DroneFleet(400, city, records_per_shard=60, n_values=4,
                       seed=args.seed)
    t0 = time.perf_counter()
    payloads, metas = fleet.next_rounds(args.rounds)
    gen_s = time.perf_counter() - t0

    for mod in (hash64_ops, vor_ops, st_ops):
        mod.launches = 0
    db = AerialDB.open(cfg, device="cuda")
    chunks = [slice(a, min(a + args.chunk, args.rounds))
              for a in range(0, args.rounds, args.chunk)]

    def ingest(sl):
        db.ingest_rounds(payloads[sl], type(metas)(*(f[sl] for f in metas)))

    ingest(chunks[0])                  # warm-up chunk, not timed
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    w0 = time.perf_counter()
    ev0.record()
    for sl in chunks[1:]:
        ingest(sl)
    ev1.record()
    ev1.synchronize()
    wall = time.perf_counter() - w0
    timed_rounds = args.rounds - (chunks[0].stop - chunks[0].start)
    ingest_s = ev0.elapsed_time(ev1) / 1e3
    shards = timed_rounds * fleet.n_drones
    tuples = shards * cfg.records_per_shard

    t_end = float(payloads[..., 0].max())
    qrng = np.random.default_rng(args.seed + 1)
    batches = []
    for km, win in QUERY_SIZES:
        w = make_query_workload(qrng, 64, city, t_end, km, win)
        recent = win <= RECENT_S
        if recent:     # anchor the window inside the last 30 minutes
            w["t0"] = qrng.uniform(t_end - RECENT_S, t_end - win, 64).astype(np.float32)
            w["t1"] = (w["t0"] + np.float32(win)).astype(np.float32)
        batches.append((km, win, recent, w))
    specs = (AggSpec(channel=0), AggSpec(channels=(0, 1, 2, 3)))
    results, times = {}, []
    for rep in range(3):
        for bi, (km, win, recent, w) in enumerate(batches):
            pred = make_pred(q=64, **w, has_spatial=True, has_temporal=True,
                             is_and=True, device=dev)
            for si, spec in enumerate(specs):
                torch.cuda.synchronize()
                q0 = time.perf_counter()
                res, info = db.query(pred, agg=spec)
                torch.cuda.synchronize()
                if rep > 0:            # repetition 0 is the warm-up
                    times.append((time.perf_counter() - q0) * 1e3)
                results[(bi, si)] = (res, info)
    launches = {"hash64": hash64_ops.launches,
                "voronoi_assign": vor_ops.launches,
                "st_scan": st_ops.launches}
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel never launched on the main path: {launches}")

    # Correctness: shapes, finiteness, and exact answers on retained windows.
    flat = payloads.reshape(-1, payloads.shape[-1]).astype(np.float64)
    flat = flat[flat[:, 0] >= t_end - RECENT_S - 600]
    checked, overflowed = exact_checks(results, batches, specs, flat)
    st = db.state
    phase("main_path", rounds=args.rounds, timed_rounds=timed_rounds,
          gen_s=gen_s, ingest_device_s=ingest_s, ingest_wall_s=wall,
          shards_per_s=shards / ingest_s, tuples_per_s=tuples / ingest_s,
          query_batch_p50_ms=float(np.median(times)),
          query_batch_ms=[float(t) for t in times],
          queries_checked_exact=checked, queries_overflowed=overflowed,
          matched_queries=int(sum(int((r.count > 0).sum()) for r, _ in results.values())),
          index_dropped=int(st.index.dropped.sum()),
          index_retired=int(st.index.retired.sum()),
          tup_overwritten=int(st.tup_overwritten.sum()),
          peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
          launches=launches)
    phase("planners", seed=args.seed, **planners_phase(
        torch, dev, cfg, db, batches, specs, flat, args.seed, args.profile,
        results, times))
    fields, ldb = latest_phase(torch, dev, cfg, db, fleet, payloads, metas,
                               chunks, batches, specs, args.seed, args.profile)
    phase("latest", main_path_shards_per_s=shards / ingest_s,
          cost=latest_cost(torch, dev, cfg, payloads, metas, chunks, fleet.n_drones),
          **fields)

    if args.profile:
        extra = fleet.next_rounds(args.chunk)
        pred = make_pred(q=64, **batches[2][3], has_spatial=True,
                         has_temporal=True, is_and=True, device=dev)
        phase("profile_ingest", **profile(torch, lambda: db.ingest_rounds(*extra),
                                          host_top=12))
        phase("profile_query", **profile(torch, lambda: db.query(pred, agg=specs[1])))
        # the same chunk into the cached store: the launches it adds are
        # the cache's cost
        phase("profile_ingest_latest", **profile(torch, lambda: ldb.ingest_rounds(*extra),
                                                 host_top=12))
    del ldb
    phase("resilience", **resilience_phase(torch, dev, cfg, city, args.seed, smi))
    torch.cuda.empty_cache()
    phase("streaming", **streaming_phase(torch, dev, cfg, city, args.seed, smi))
    torch.cuda.empty_cache()
    phase("chaos", **chaos_phase(torch, dev, cfg, city, args.seed, smi))
    torch.cuda.empty_cache()

    # -- 4. st_scan vs plain on the main path's inputs; kernel timings -------
    scan = st_scan_phase(torch, dev, cfg, st, db.alive, batches, specs)
    rows = scan["rows"]

    def bound(bytes_, ops=0.0):
        b_ms, o_ms = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
        return (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations")

    # hash64 at the insert's temporal-slice shape (B x max_t_slices H_t keys).
    buckets = hashing.time_bucket(torch.from_numpy(metas.t0[-1]).to(dev),
                                  cfg.tau)[:, None] + torch.arange(
        16, dtype=torch.int32, device=dev)
    h_plain = cuda_ms(torch, lambda: hashing.xxh64_mod_plain(None, buckets, 80), 50)
    # hash64 at each main-path shape of an insert round: the slice buckets
    # above, the shard midpoints' buckets (H_t) and the shard ids (H_i), each
    # beside an empty kernel on its grid (hash64_empty_launch) and its bytes
    # read once and written once: 8 B a key in the H_t form, 12 in the H_i.
    mid_t = 0.5 * (torch.from_numpy(metas.t0[-1]) + torch.from_numpy(metas.t1[-1])).to(dev)
    sid_hi = torch.from_numpy(metas.sid_hi[-1]).to(dev)
    sid_lo = torch.from_numpy(metas.sid_lo[-1]).to(dev)
    hash_shapes = {}
    for shape, hi_k, lo_k, key_bytes in (
            ("ht_slices", None, buckets, 8),
            ("ht_midpoints", None, hashing.time_bucket(mid_t, cfg.tau), 8),
            ("hi_shard_ids", sid_hi, sid_lo, 12)):
        call = (lambda h=hi_k, lo_=lo_k: hash64_ops.xxh64_mod_cuda(h, lo_, 80))
        keys = int(lo_k.numel())
        b_ms, b_by = bound(keys * key_bytes)
        hash_shapes[shape] = {
            "keys": keys, "high_word": hi_k is not None,
            "ms": cuda_ms(torch, call, 200),
            "device_ms": device_ms(torch, call, 50, "hash64_mod_kernel"),
            "launch_floor_device_ms": device_ms(
                torch, lambda k=keys: hash64_ops.launch_floor(k, dev), 50,
                "hash64_empty_kernel"),
            "bound_ms": b_ms, "bound_by": b_by,
            "err": int((call() != hashing.xxh64_mod_plain(hi_k, lo_k, 80)).sum())}
    h_err = sum(v.pop("err") for v in hash_shapes.values())
    h_ms, h_dev = (hash_shapes["ht_slices"][k] for k in ("ms", "device_ms"))

    # voronoi at the insert's spatial-slice shape (B x 16 x 16 cell centres).
    i0 = torch.floor(torch.from_numpy(metas.lat0[-1]).to(dev) / cell)
    j0 = torch.floor(torch.from_numpy(metas.lon0[-1]).to(dev) / cell)
    ks = torch.arange(16, device=dev, dtype=torch.float32)
    vlat = ((i0[:, None] + ks + 0.5) * cell)[:, :, None].expand(-1, 16, 16).contiguous()
    vlon = ((j0[:, None] + ks + 0.5) * cell)[:, None, :].expand(-1, 16, 16).contiguous()
    v_ms = cuda_ms(torch, lambda: vor_ops.voronoi_assign_cuda(vlat, vlon, sites), 200)
    vpts = torch.stack([vlat.reshape(-1), vlon.reshape(-1)], -1)
    v_plain = cuda_ms(torch, lambda: voronoi.voronoi_assign(vpts, sites), 50)
    c, sc, _ = voronoi.centred_sites(sites)
    vpc = vpts - c
    v_lib = cuda_ms(torch, lambda: torch.cdist(vpc, sc).argmin(1), 50)
    v_dev = device_ms(torch, lambda: vor_ops.voronoi_assign_cuda(vlat, vlon, sites),
                      50, "voronoi_assign_kernel")
    # every device activity of a call: the kernel alone, once the sites are
    # packed
    v_wrap_dev = device_ms(torch, lambda: vor_ops.voronoi_assign_cuda(
        vlat, vlon, sites), 50)
    v_lib_dev = device_ms(torch, lambda: torch.cdist(vpc, sc).argmin(1), 50)
    centred_ms = cuda_ms(torch, lambda: voronoi.centred_sites(sites), 200)
    v_err = int((vor_ops.voronoi_assign_cuda(vlat, vlon, sites).reshape(-1)
                 != voronoi.voronoi_assign(vpts, sites)).sum())
    n_pts, n_e = vpts.shape[0], sites.shape[0]
    v_ops = n_pts * (6 * n_e + 2)
    # voronoi at the insert's placement shape (the B shard midpoints).
    mlat = 0.5 * (torch.from_numpy(metas.lat0[-1]) + torch.from_numpy(metas.lat1[-1])).to(dev)
    mlon = 0.5 * (torch.from_numpy(metas.lon0[-1]) + torch.from_numpy(metas.lon1[-1])).to(dev)
    mpts = torch.stack([mlat, mlon], -1)
    mpc = mpts - c
    place = {
        "points": int(mpts.shape[0]),
        "ms": cuda_ms(torch, lambda: vor_ops.voronoi_assign_cuda(mlat, mlon, sites), 200),
        "device_ms": device_ms(torch, lambda: vor_ops.voronoi_assign_cuda(mlat, mlon, sites),
                               50, "voronoi_assign_kernel"),
        "plain_ms": cuda_ms(torch, lambda: voronoi.voronoi_assign(mpts, sites), 50),
        "library_ms": cuda_ms(torch, lambda: torch.cdist(mpc, sc).argmin(1), 50),
        "library_device_ms": device_ms(torch, lambda: torch.cdist(mpc, sc).argmin(1), 50),
        "err": int((vor_ops.voronoi_assign_cuda(mlat, mlon, sites)
                    != voronoi.voronoi_assign(mpts, sites)).sum())}
    place["bound_ms"], place["bound_by"] = bound(
        mpts.shape[0] * 12, mpts.shape[0] * (6 * n_e + 2))
    # The kernel's work per (point, site) of the plain version's E sites a
    # point: VISIT_INSTRUCTIONS a visit (static, from SASS) times the visits
    # a point's warp issues, beside the operations the bound counts.
    visits = voronoi_visits(torch, vor_ops, vlat, vlon, sites)
    p_visits = voronoi_visits(torch, vor_ops, mlat, mlon, sites)
    vor_work = {"instructions_per_visit_static_sass": VISIT_INSTRUCTIONS,
                "ahead": visits["ahead"],
                "sites_listed_per_point": visits["listed"],
                "visits_issued_per_point": visits["issued"],
                "instructions_per_point_site": VISIT_INSTRUCTIONS * visits["issued"] / n_e,
                "placement_sites_listed_per_point": p_visits["listed"],
                "placement_visits_issued_per_point": p_visits["issued"],
                "bound_operations_per_point_site": (6 * n_e + 2) / n_e}

    def recount(points, listed):
        """The bound recounted for the sites the data needs: 12 bytes a point
        and the 8 E bytes of the sites, against 2 + 6 operations a listed
        site (unfused, so at half the FMA-counted rate)."""
        b_ms = (points * 12 + n_e * 8) / HBM_BYTES_PER_S * 1e3
        o_ms = points * (2 + 6 * listed) / (FP32_FLOP_PER_S / 2) * 1e3
        return (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations")

    kernels = []
    for name, route, src, replaces, ms, dev_ms, plain_ms, (b_ms, b_by), lib_ms, \
            lib_dev, err in (
            ("st_scan", "cuda", "src/repro_torch/csrc/st_scan.cu",
             "src/repro/kernels/st_scan/st_scan.py:109", scan["ms"],
             scan["device_ms"], scan["plain_ms"], bound(scan["bytes"]), None,
             None, scan["err"]),
            ("hash64", "cuda", "src/repro_torch/csrc/hash64.cu",
             "src/repro/kernels/hash64/hash64.py:28", h_ms, h_dev, h_plain,
             bound(buckets.numel() * 8), None, None, float(h_err)),
            ("voronoi_assign", "cuda", "src/repro_torch/csrc/voronoi_assign.cu",
             "src/repro/kernels/voronoi_assign/voronoi_assign.py:32", v_ms,
             v_dev, v_plain, bound(n_pts * 12, v_ops), v_lib, v_lib_dev,
             float(v_err))):
        kernels.append({"name": name, "route": route, "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms, "device_ms": dev_ms,
                        "library_device_ms": lib_dev})
    kernels[-1]["wrapper_device_ms"] = v_wrap_dev
    kernels[-1].update({f"placement_{k}": v for k, v in place.items() if k != "err"})
    # The ranking's bound_ms counts all E sites a point; beside it, recounted
    # for the listed sites this run's points need.
    kernels[-1]["bound_ms_recount"], kernels[-1]["bound_by_recount"] = recount(
        n_pts, visits["listed"])
    kernels[-1]["placement_bound_ms_recount"], kernels[-1]["placement_bound_by_recount"] = \
        recount(int(mpts.shape[0]), p_visits["listed"])
    kernels[0]["bound_ms_old"] = scan["old_bytes"] / HBM_BYTES_PER_S * 1e3
    phase("kernel_timings", st_scan_k1_ms=scan["k1_ms"],
          voronoi_centred_sites_ms=centred_ms,
          st_scan_shape={"E": 80, "C": cfg.padded_capacity, "Q": 64,
                         "L": cfg.max_shards_per_query, "K": len(rows),
                         "selected_edges": scan["batches"][2]["selected_edges"]},
          st_scan_checks=scan["checks"], st_scan_batches=scan["batches"],
          st_scan_bound_ms={"nine_words_every_live_slot": kernels[0]["bound_ms_old"],
                            "hot_words_plus_matched_channels": kernels[0]["bound_ms"]},
          hash64_keys=int(buckets.numel()), hash64_shapes=hash_shapes,
          launch_floor_device_ms=hash_shapes["ht_slices"]["launch_floor_device_ms"],
          voronoi_points=int(n_pts),
          voronoi_placement=place, voronoi_work=vor_work)
    if h_err or v_err or place["err"]:
        raise SystemExit(f"kernel disagrees at timing shapes: hash64 {h_err}, "
                         f"voronoi {v_err}, voronoi placement {place['err']}")
    del db, st, scan    # free the store before serving
    torch.cuda.empty_cache()

    # -- 5-7. flash_attention and the LM serving path ----------------------
    flash_err = flash_vs_plain(torch, dev, args.seed)
    served = serve(torch, dev, args.seed, args.profile)
    ft = flash_timings(torch, dev, args.seed)
    pre, dec, long = ft["prefill"], ft["decode"], ft["decode_long"]
    flash = "src/repro/kernels/flash_attention/flash_attention.py:66"
    # The mma_sync kernel is on no main path any more (fp32, d 32/64, and
    # bf16 with 1 < Sq < 64): its entry gives its forced decode-shape times.
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu", "replaces": flash,
        "launches": served["mma_sync"],
        "max_abs_err": flash_err["bfloat16_mma_sync"],
        "ms": dec["mma_sync_ms"], "device_ms": dec["mma_sync_device_ms"],
        "host_us": dec["mma_sync_host_us"],
        "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
        "library_device_ms": dec["library_device_ms"],
        "long_device_ms": long["mma_sync_device_ms"],
        "prefill_ms": pre["mma_sync_ms"],
        "prefill_device_ms": pre["mma_sync_device_ms"]})
    kernels.append({
        "name": "flash_attention_sm90", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_sm90.cu", "replaces": flash,
        "launches": served["sm90"],
        "max_abs_err": flash_err["bfloat16_sm90"],
        "ms": pre["ms"], "device_ms": pre["device_ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": pre["library_ms"],
        "library_device_ms": pre["library_device_ms"]})
    kernels.append({
        "name": "flash_attention_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_decode.cu", "replaces": flash,
        "launches": served["decode"],
        "max_abs_err": flash_err["bfloat16_decode"],
        "ms": dec["ms"], "device_ms": dec["device_ms"], "host_us": dec["host_us"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "library_device_ms": dec["library_device_ms"],
        "long_ms": long["ms"], "long_device_ms": long["device_ms"],
        "long_plain_ms": long["plain_ms"], "long_bound_ms": long["bound_ms"],
        "long_library_device_ms": long["library_device_ms"]})
    phase("flash_timings", shapes={
        "prefill": [SERVE_BATCH, PREFILL_LEN, 16, 8, 128, "causal", "bf16"],
        "decode": [SERVE_BATCH, 1, 16, 8, 128, "q_offset",
                   PROMPT_LEN + NEW_TOKENS - 1, "Skv", MAX_SEQ],
        "decode_long": [SERVE_BATCH, 1, 16, 8, 128, "q_offset", LONG_SEQ - 1,
                        "Skv", LONG_SEQ]}, **ft)
    phase("device_ms_profiles", calls=len(DEVICE_MS_PROFILES),
          profiles=sum(DEVICE_MS_PROFILES),
          retried=[i for i, k in enumerate(DEVICE_MS_PROFILES) if k > 1])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
