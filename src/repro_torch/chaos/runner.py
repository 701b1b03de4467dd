"""``ChaosRunner``: drive a :class:`FaultPlan` against a live deployment
(port of ``repro.chaos.runner``).

The runner is the thin applicator between a seeded schedule and the
tolerance machinery it exercises: membership events hit the ``AerialDB``
session (``fail_edges`` / ``recover_edges`` / ``fail_device`` /
``recover_device`` / ``partition`` / ``heal`` — recoveries and heals run
the incremental repair inline, the path under test), ingest events arm the
``IngestPipeline``'s ``fault_hook`` (``flush_fail`` raises
``TransientDispatchError`` on the next n dispatch attempts;
``pipeline_crash`` raises ``PipelineCrash`` once). Every applied event is
appended to :attr:`log` as a machine-readable dict — event identity plus
the effect telemetry (repair summary, ledger snapshot) — so a soak run's
full fault history can be printed as JSON (:meth:`to_json`).

Determinism: the runner adds no randomness — applying the same plan to
identically-seeded sessions/pipelines with the same workload produces
bitwise-identical stores and identical logs, and the same plan applied
to a port session and a reference session gives the same log and the
same state leaves (``tests/test_torch_chaos.py``). The runner
deliberately does NOT catch ``PipelineCrash``: a crash tears the flush
mid-flight exactly like a real process death, and recovery (fresh
pipeline + ``replay_journal``) is the harness's job — see
``chip_smoke.py``'s chaos phase.
"""

from __future__ import annotations

import json
from typing import Callable, Optional

from repro_torch.chaos.plan import FaultPlan
from repro_torch.ingest.pipeline import PipelineCrash, TransientDispatchError

__all__ = ["ChaosRunner"]

# Repair telemetry keys worth echoing per event (the full dict stays on
# AerialDB.last_repair).
_REPAIR_KEYS = ("shards_swept", "shards_tracked", "shards_replaced",
                "shards_unrepairable", "tuples_copied", "slots_reclaimed",
                "entries_backfilled", "mode")


class ChaosRunner:
    """Apply a fault plan step by step (see module docstring).

    Args:
      plan:     the seeded :class:`FaultPlan`.
      db:       the ``AerialDB`` session to inject membership faults into.
      pipeline: the ``IngestPipeline`` for ``flush_fail`` /
                ``pipeline_crash`` events (those raise without one).
    """

    def __init__(self, plan: FaultPlan, db, pipeline=None):
        self.plan = plan
        self.db = db
        self.pipeline = pipeline
        self.log: list = []
        self._i = 0

    @property
    def done(self) -> bool:
        return self._i >= len(self.plan.events)

    def advance(self, step: int) -> list:
        """Apply every not-yet-applied event due at or before ``step``, in
        plan order; returns the telemetry entries appended for them."""
        applied = []
        while (self._i < len(self.plan.events)
               and self.plan.events[self._i].step <= step):
            ev = self.plan.events[self._i]
            self._i += 1
            applied.append(self._apply(ev))
        return applied

    def run(self, tick: Callable[[int], None],
            n_steps: Optional[int] = None) -> list:
        """Drive the whole plan: for each step, apply due events then call
        ``tick(step)`` (the workload — submits, flushes, queries), and
        finally apply the closing events at the horizon. Returns the full
        log. Crashes (``PipelineCrash`` out of a tick) propagate — use
        manual :meth:`advance` loops when the harness owns recovery."""
        n = self.plan.n_steps if n_steps is None else n_steps
        for step in range(n):
            self.advance(step)
            tick(step)
        self.advance(self.plan.n_steps)
        return self.log

    def to_json(self) -> str:
        return json.dumps(self.log)

    # -- event application ---------------------------------------------------

    def _apply(self, ev) -> dict:
        entry = {"step": int(ev.step), "kind": ev.kind,
                 "args": _plain(list(ev.args))}
        fn = getattr(self, f"_ev_{ev.kind}")
        fn(ev.args, entry)
        self.log.append(entry)
        return entry

    def _note_repair(self, entry) -> None:
        rep = self.db.last_repair
        if rep is not None:
            entry["repair"] = {k: rep[k] for k in _REPAIR_KEYS}
        entry["ledger"] = self.db.ledger()

    def _need_pipeline(self, kind):
        if self.pipeline is None:
            raise ValueError(
                f"plan contains a {kind!r} event but the runner has no "
                "pipeline: pass ChaosRunner(plan, db, pipeline=...).")
        return self.pipeline

    def _ev_fail_edges(self, args, entry):
        self.db.fail_edges(list(args[0]))
        entry["ledger"] = self.db.ledger()

    def _ev_recover_edges(self, args, entry):
        self.db.recover_edges(list(args[0]))
        self._note_repair(entry)

    def _ev_fail_device(self, args, entry):
        self.db.fail_device(int(args[0]))
        entry["ledger"] = self.db.ledger()

    def _ev_recover_device(self, args, entry):
        self.db.recover_device(int(args[0]))
        self._note_repair(entry)

    def _ev_partition(self, args, entry):
        self.db.partition([list(g) for g in args[0]])
        entry["ledger"] = self.db.ledger()

    def _ev_heal(self, args, entry):
        self.db.heal()
        self._note_repair(entry)

    def _ev_flush_fail(self, args, entry):
        pipe = self._need_pipeline("flush_fail")
        burst = {"left": int(args[0])}
        entry["burst"] = int(args[0])

        def hook(pipeline, attempt):
            if burst["left"] > 0:
                burst["left"] -= 1
                raise TransientDispatchError(
                    f"chaos: injected transient dispatch failure "
                    f"({burst['left']} left in burst)")
        pipe.fault_hook = hook

    def _ev_pipeline_crash(self, args, entry):
        pipe = self._need_pipeline("pipeline_crash")

        def hook(pipeline, attempt):
            pipeline.fault_hook = None       # one-shot: crash exactly once
            raise PipelineCrash("chaos: injected mid-flush pipeline crash")
        pipe.fault_hook = hook


def _plain(x):
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    return int(x) if hasattr(x, "__int__") and not isinstance(x, bool) else x
