"""aeriallint layer 2 of the port: the sync, launch and build budget.

The eager counterpart of ``repro.analysis.retrace``. What a retrace costs
JAX (a weak config hash, a shape-unstable call site: a silent 10x on
latency) shows up in eager PyTorch as host syncs and kernel launches that
the workload did not need, and as kernel builds and library loads in a
process that should have none. This harness runs the reference's canonical
facade workload unchanged (``_CANON_KWARGS``, 6 drones at fleet seed 7: one
insert, a 2-round ingest, one query per AggSpec channel set, a fail, a
query around the dead edge, a recover with its incremental repair, a
re-insert and a re-query) on the single store, ``make_edge_mesh(4)`` and
``make_fleet_mesh(2, 2)``, twice: cold, then a fresh session warm. Per
entry point (``open``, ``insert``, ``ingest_rounds``, ``query[<channels>]``,
``fail_edges``, ``recover_edges``) it counts:

  * **syncs**: calls that make the host wait for the device, counted by a
    ``TorchFunctionMode`` (``SyncCounter``): ``item``, ``tolist``,
    ``cpu``, ``numpy``, ``__array__``, ``__bool__`` / ``__int__`` /
    ``__float__`` / ``__index__``, ``nonzero``, ``unique``,
    ``masked_select``, ``equal``, boolean-mask indexing, one-argument
    ``where``, and on the card ``to`` / ``copy_`` off the card. A call
    counts when its tensor lies on the run's device: on the CPU every
    tensor does, so the CPU count is the calls that would wait on a card
    along the CPU path (plain kernel versions included). On the card,
    ``h2d`` counts blocking host->card copies beside it, and
    ``sync_debug`` the warnings of ``torch.cuda.set_sync_debug_mode``;
  * **launches** of the port's kernels, from their wrappers' counters
    (they count on the card only);
  * **builds** and **loads** of kernel libraries (``kernels.build``).

Budgets are exact data (``analysis/aeriallint.toml``, ``[retrace.budgets.
<device>.<leg>.<entry>]``): the warm run must give each entry's ``syncs``
and ``launches``, with no build and no load; the cold run the same plus the
entry's ``fills``, work a process does once per configuration (voronoi's
site packing on the card). Entry points run on ``cuda`` unless ``--device
cpu`` is given; without a card they raise.

    python -m repro_torch.analysis.retrace --device cpu   # exit 1 on violation
    python -m repro_torch.analysis.retrace --json -o RETRACE.json   # the card

``build_check`` runs the CLI in two child processes over one empty build
directory: the first must build and load st_scan, hash64 and
voronoi_assign exactly once each, cold, and nothing warm; the second must
build nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import warnings
from collections import Counter
from typing import Optional

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.analysis.config import AeriallintConfig, load_config
from repro_torch.api import AerialDB, AggSpec, Query, StoreConfig
from repro_torch.data.synthetic import DroneFleet
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.hash64 import ops as hash64_ops
from repro_torch.kernels.st_scan import ops as st_scan_ops
from repro_torch.kernels.voronoi_assign import ops as voronoi_ops
from repro_torch.launch.mesh import make_edge_mesh, make_fleet_mesh

# The reference's canonical workload (repro/analysis/retrace.py), unchanged.
_CANON_KWARGS = dict(n_edges=8, tuple_capacity=384, index_capacity=160,
                     max_shards_per_query=24, records_per_shard=3, n_values=2)
_N_DRONES = 6
_FLEET_SEED = 7
LEGS = ("single", "edge4", "fleet2x2")
KERNELS = {"st_scan": st_scan_ops, "hash64": hash64_ops,
           "voronoi_assign": voronoi_ops}

# Calls that read a tensor of the device back to the host.
_READS = {"item", "tolist", "cpu", "numpy", "__array__", "__bool__", "__int__",
          "__float__", "__index__", "nonzero", "argwhere", "unique",
          "unique_consecutive", "masked_select", "equal", "allclose",
          "is_nonzero"}


def _dev_of(x) -> Optional[torch.device]:
    """The device a ``to`` / ``copy_`` argument names, else None."""
    if isinstance(x, torch.Tensor):
        return x.device
    if isinstance(x, (str, torch.device)):
        try:
            return torch.device(x)
        except RuntimeError:        # a dtype name, not a device
            return None
    return None


def _has_mask(index) -> bool:
    items = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in items)


class SyncCounter(TorchFunctionMode):
    """Counts, by operation, the calls that make the host wait for
    ``device`` (see the module docstring); ``syncs`` is their total, ``h2d``
    the blocking host->card copies (on a card only)."""

    def __init__(self, device):
        super().__init__()
        self.kind = torch.device(device).type
        self.ops: Counter = Counter()
        self.h2d = 0

    @property
    def syncs(self) -> int:
        return sum(self.ops.values())

    def _on(self, t) -> bool:
        return isinstance(t, torch.Tensor) and t.device.type == self.kind

    def _classify(self, name, args, kwargs):
        t = args[0] if args else None
        card = self.kind != "cpu"
        if name in _READS:
            return self._on(t) and name
        if name in ("__getitem__", "__setitem__"):
            return self._on(t) and len(args) > 1 and _has_mask(args[1]) \
                and "mask_index"
        if name == "where":
            return self._on(t) and len(args) + len(kwargs) == 1 and "where"
        if not card or name not in ("to", "copy_", "cuda", "as_tensor",
                                    "tensor"):
            return None
        blocking = not kwargs.get("non_blocking", False) and not (
            len(args) > 2 and args[-1] is True)
        if name == "to":
            dst = next((d for d in map(_dev_of, [kwargs.get("device"),
                                                  *args[1:]]) if d), None)
            src = t.device if isinstance(t, torch.Tensor) else None
        elif name == "copy_":
            src = args[1].device if isinstance(args[1], torch.Tensor) else None
            dst = t.device if isinstance(t, torch.Tensor) else None
        elif name == "cuda":
            src, dst = t.device, torch.device(self.kind)
        else:                       # as_tensor / tensor of host data
            dst = _dev_of(kwargs.get("device"))
            src = t.device if isinstance(t, torch.Tensor) else \
                torch.device("cpu")
        if src is None or dst is None or src.type == dst.type or not blocking:
            return None
        if dst.type == "cpu":
            return f"{name}_to_host"
        self.h2d += 1
        return None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        what = self._classify(getattr(func, "__name__", ""), args, kwargs)
        if what:
            self.ops[what] += 1
        return func(*args, **kwargs)


def _launches() -> dict:
    return {k: mod.launches for k, mod in KERNELS.items()}


class Meter:
    """Per-entry-point counts of a run on ``device``: ``with meter("insert"):
    ...`` adds that block's syncs, launches, builds and loads to
    ``counts["insert"]``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.counts: dict = {}

    @contextlib.contextmanager
    def __call__(self, entry: str):
        card = self.device.type == "cuda"
        l0, b0, ld0 = _launches(), Counter(build.builds), Counter(build.loads)
        counter = SyncCounter(self.device)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if card:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with counter:
                    yield
            finally:
                if card:
                    torch.cuda.set_sync_debug_mode("default")
        c = self.counts.setdefault(entry, {
            "calls": 0, "syncs": 0, "ops": Counter(), "launches": Counter(),
            "builds": Counter(), "loads": Counter(), "h2d": 0,
            "sync_debug": 0})
        c["calls"] += 1
        c["syncs"] += counter.syncs
        c["ops"].update(counter.ops)
        c["launches"].update({k: n - l0[k] for k, n in _launches().items()
                              if n != l0[k]})
        c["builds"].update(Counter(build.builds) - b0)
        c["loads"].update(Counter(build.loads) - ld0)
        if card:
            c["h2d"] += counter.h2d
            c["sync_debug"] += sum("ynchroniz" in str(w.message)
                                   for w in caught)

    def report(self) -> dict:
        return {e: {k: dict(v) if isinstance(v, Counter) else v
                    for k, v in c.items()} for e, c in self.counts.items()}


def canonical_config(**overrides) -> StoreConfig:
    kw = dict(_CANON_KWARGS)
    kw.update(overrides)
    return StoreConfig(**kw)


def mesh_for(leg: str, n_edges: int, device):
    """The leg's mesh: None for the single store, else the (4,) edge mesh
    or the (2, 2) fleet mesh, every block on ``device``."""
    if leg == "single":
        return None
    if leg == "edge4":
        return make_edge_mesh(4, n_edges=n_edges, device=device)
    if leg == "fleet2x2":
        return make_fleet_mesh(2, 2, n_edges=n_edges, device=device)
    raise ValueError(f"unknown leg {leg!r}: pick from {LEGS}")


def canonical_workload(cfg: StoreConfig, mesh, device,
                       meter: Optional[Meter] = None):
    """The facade workload every budget is defined against (the
    reference's ``canonical_workload``, step for step), each entry point
    inside ``meter``. Returns the session and the answers of its queries."""
    meter = meter or Meter(device)
    with meter("open"):
        db = AerialDB.open(cfg, mesh=mesh, device=device, seed=0)
    fleet = DroneFleet(_N_DRONES, records_per_shard=cfg.records_per_shard,
                       n_values=cfg.n_values, seed=_FLEET_SEED)
    answers = []
    with meter("insert"):
        db.insert(*fleet.next_shards())
    with meter("ingest_rounds"):
        db.ingest_rounds(*fleet.next_rounds(2))

    window = Query().bbox(12.0, 14.0, 77.0, 79.0).time(0.0, 1e5)
    single = window.agg("mean", channel=0)
    pair = AggSpec(channels=(0, 1))
    pred, _ = window.build(db.device)

    def query(q, agg=None):
        spec = agg or q.spec
        with meter(f"query[{','.join(map(str, spec.channels))}]"):
            answers.append(db.query(q, agg=agg) if agg else db.query(q))

    query(single)
    query(pred, pair)
    with meter("fail_edges"):
        db.fail_edges(1)
    query(single)                         # re-plan around the dead edge
    with meter("recover_edges"):
        db.recover_edges(1)               # implicit incremental repair
    with meter("insert"):
        db.insert(*fleet.next_shards())
    query(pred, pair)
    return db, answers


def _check(budgets: dict, got: dict, phase: str, leg: str,
           card: bool) -> list:
    out = []

    def bad(entry, what, want, have):
        out.append({"leg": leg, "phase": phase, "entry": entry, "what": what,
                    "want": want, "got": have,
                    "message": f"[{leg}/{phase}] {entry}: {what} {have}, "
                               f"budget {want}"})
    for entry in sorted(set(budgets) | set(got)):
        b, c = budgets.get(entry), got.get(entry)
        if b is None:
            bad(entry, "entry", "a budget", "no budget")
            continue
        if c is None:
            bad(entry, "entry", "measured", "never ran")
            continue
        want = b.get("syncs", 0) + (b.get("fills", {}).get("syncs", 0)
                                    if phase == "cold" else 0)
        if c["syncs"] != want:
            bad(entry, "syncs", want, c["syncs"])
        want_l = b.get("launches", {}) if card else {}
        if {k: n for k, n in c["launches"].items() if n} != want_l:
            bad(entry, "launches", want_l, c["launches"])
        if phase == "warm" and (c["builds"] or c["loads"]):
            bad(entry, "builds/loads", {}, [c["builds"], c["loads"]])
    return out


def run_retrace(device="cuda", cfg: Optional[AeriallintConfig] = None,
                legs=LEGS) -> dict:
    """Run the canonical workload cold and warm on each leg under the
    meters and hold it to the budgets; returns the report. The cold run
    expects its ``fills`` once a process: run it once a process on the
    card."""
    cfg = cfg or load_config()
    dev = resolve_device(device)
    runs, violations = [], []
    for leg in legs:
        phases = {}
        for phase in ("cold", "warm"):
            # a config made anew, equal in value: the warm run hits the
            # per-configuration caches only if StoreConfig hashes by value
            store_cfg = canonical_config()
            meter = Meter(dev)
            canonical_workload(store_cfg, mesh_for(leg, store_cfg.n_edges, dev),
                               dev, meter)
            phases[phase] = meter.report()
        budgets = cfg.budgets(dev.type, leg)
        v = [x for phase, got in phases.items()
             for x in _check(budgets, got, phase, leg, dev.type == "cuda")]
        violations += v
        runs.append({"leg": leg, **phases, "violations": len(v)})
    return {"tool": "aeriallint.retrace", "device": str(dev),
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "runs": runs, "violations": violations, "ok": not violations}


def totals(run: dict, phase: str, key: str) -> dict:
    """A leg's ``builds`` or ``loads`` by kernel, summed over its entries."""
    out = Counter()
    for c in run[phase].values():
        out.update(c[key])
    return dict(out)


def build_check(build_dir: str) -> dict:
    """Two child processes run this CLI on the card over ``build_dir``
    (empty at the start): the first must build and load each of st_scan,
    hash64 and voronoi_assign exactly once, in its cold run, and nothing in
    its warm runs; the second must build nothing. Returns each child's
    builds and loads by leg and phase, its own budget verdict and the
    violations."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, REPRO_TORCH_BUILD_DIR=build_dir,
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    once = {k: 1 for k in KERNELS}
    out, violations = {}, []
    for child in ("first", "second"):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.retrace", "--json",
             "--device", "cuda"], env=env, capture_output=True, text=True,
            timeout=900)
        try:
            rep = json.loads(proc.stdout)
        except json.JSONDecodeError:
            violations.append(f"{child}: exit {proc.returncode}, no report: "
                              f"{proc.stderr[-2000:]}")
            continue
        got = {r["leg"]: {phase: {k: totals(r, phase, k)
                                  for k in ("builds", "loads")}
                          for phase in ("cold", "warm")} for r in rep["runs"]}
        out[child] = {"rc": proc.returncode, "ok": rep["ok"],
                      "budget_violations": rep["violations"][:5], **got}
        if not rep["ok"]:
            violations.append(f"{child}: {len(rep['violations'])} budget "
                              f"violation(s): {rep['violations'][:2]}")
        cold, loads = Counter(), Counter()
        for leg in got.values():
            cold.update(leg["cold"]["builds"])
            loads.update(leg["cold"]["loads"])
            if leg["warm"]["builds"] or leg["warm"]["loads"]:
                violations.append(f"{child}: a warm run built or loaded "
                                  f"{leg['warm']}")
        want_builds = once if child == "first" else {}
        if dict(cold) != want_builds:
            violations.append(f"{child}: cold builds {dict(cold)}, want "
                              f"{want_builds}")
        if dict(loads) != once:
            violations.append(f"{child}: cold loads {dict(loads)}, want {once}")
    return {"children": out, "violations": violations, "ok": not violations}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.retrace",
        description="aeriallint layer 2 of the port: the canonical "
                    "workload's sync, launch and build budget.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--json", action="store_true",
                    help="print the machine-readable report")
    ap.add_argument("-o", "--output", default=None,
                    help="also write the JSON report to this file")
    args = ap.parse_args(argv)

    report = run_retrace(args.device)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
    if args.json:
        json.dump(report, sys.stdout, indent=2)
        print()
    else:
        for v in report["violations"]:
            print(v["message"])
        print(f"aeriallint.retrace: {len(report['runs'])} leg(s) on "
              f"{report['device']}, {len(report['violations'])} budget "
              "violation(s).")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
