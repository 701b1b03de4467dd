"""Seeded, replayable fault-injection schedules (port of
``repro.chaos.plan``: pure numpy, a copy, so that the same seed and
parameters give the reference's plan event for event).

A ``FaultPlan`` is a deterministic list of timed :class:`FaultEvent`\\ s —
the fault taxonomy the chaos engine can inject against a live ``AerialDB``
session (+ ``IngestPipeline``):

=================  ========================================================
kind               meaning / args
=================  ========================================================
``fail_edges``     edge crash — ``(edge_ids,)``
``recover_edges``  edge recovery (+ incremental repair) — ``(edge_ids,)``
``fail_device``    whole failure-domain loss — ``(domain,)``
``recover_device`` failure-domain recovery (+ repair) — ``(domain,)``
``partition``      fleet network partition — ``(groups,)``: connectivity
                   groups, coordinator keeps the first
``heal``           partition heal (+ repair) — ``()``
``flush_fail``     transient flush-dispatch failures — ``(n,)``: the next
                   n dispatch attempts raise ``TransientDispatchError``
``pipeline_crash`` mid-flush process crash — ``()``: the next dispatch
                   raises ``PipelineCrash`` (recovery = fresh pipeline +
                   journal replay)
=================  ========================================================

``FaultPlan.random(seed, ...)`` generates a *well-formed* schedule from a
PRNG seed — pure in the seed and parameters, so the same seed replays the
identical plan (the determinism contract the soak benchmark and the
property tests gate). Well-formed means: at least ``min_alive`` edges stay
alive AND reachable at every point (placement keeps its full replication
degree), at most one partition is open at a time, transient bursts stay
within ``max_transient`` (callers bound it by the pipeline's retry budget
to keep ``gave_up == 0``), and every fault is closed by the end — trailing
``recover_*`` / ``heal`` events at step ``n_steps`` return the fleet to
full health, so a final repair converges the store to the never-faulted
canonical placement.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["EVENT_KINDS", "FaultEvent", "FaultPlan"]

EVENT_KINDS = ("fail_edges", "recover_edges", "fail_device",
               "recover_device", "partition", "heal", "flush_fail",
               "pipeline_crash")


class FaultEvent(NamedTuple):
    """One timed injection: fires when the runner advances to ``step``."""
    step: int
    kind: str
    args: Tuple = ()


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, replayable fault schedule (see module docstring).

    ``events`` must be step-sorted with known kinds — validated eagerly so
    a malformed hand-built plan fails at construction, not mid-soak.
    ``seed`` records provenance for plans built by :meth:`random` (None
    for hand-built ones); two plans are equal iff their events and horizon
    are — the replay-determinism property is ``FaultPlan.random(s, ...) ==
    FaultPlan.random(s, ...)``.
    """
    events: Tuple[FaultEvent, ...]
    n_steps: int
    seed: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "events",
                           tuple(FaultEvent(*e) for e in self.events))
        steps = [e.step for e in self.events]
        if steps != sorted(steps):
            raise ValueError("FaultPlan events must be step-sorted "
                             f"(got steps {steps}).")
        bad = sorted({e.kind for e in self.events} - set(EVENT_KINDS))
        if bad:
            raise ValueError(f"unknown fault kind(s) {bad}: valid kinds "
                             f"are {EVENT_KINDS}.")

    def kinds(self) -> Tuple[str, ...]:
        return tuple(e.kind for e in self.events)

    def to_rows(self) -> list:
        """JSON-serializable event rows (telemetry / BENCH artifacts)."""
        def plain(x):
            if isinstance(x, (tuple, list)):
                return [plain(v) for v in x]
            return int(x) if isinstance(x, (int, np.integer)) else x
        return [{"step": int(e.step), "kind": e.kind,
                 "args": plain(list(e.args))} for e in self.events]

    @classmethod
    def random(cls, seed: int, *, n_edges: int, n_steps: int = 12,
               n_domains: int = 0, min_alive: int = 4,
               p_fault: float = 0.6, max_concurrent: int = 3,
               max_transient: int = 2, allow_crash: bool = False,
               require: Tuple[str, ...] = ()) -> "FaultPlan":
        """Generate a well-formed seeded schedule (module docstring).

        Args:
          seed:        the replay key — same seed, same plan, always.
          n_edges:     deployment size (edge ids drawn from it).
          n_steps:     schedule horizon; closing recover/heal events land
                       at step ``n_steps`` exactly.
          n_domains:   > 0 enables ``fail_device``/``recover_device``
                       events over contiguous blocks of
                       ``n_edges // n_domains`` edges (must match the
                       session's failure-domain layout).
          min_alive:   edges that stay alive AND reachable throughout —
                       keep >= the replication degree so placement never
                       degrades below full replication.
          p_fault:     per-step probability of injecting an event.
          max_concurrent: bound on simultaneously-dead edges.
          max_transient:  cap on each ``flush_fail`` burst; bound it by
                       the pipeline's ``max_retries`` for ``gave_up == 0``.
          allow_crash: permit one ``pipeline_crash`` per plan (the caller
                       must then own journal-replay recovery).
          require:     event kinds that must appear; the generator retries
                       derived sub-seeds (deterministically) until they do.
        """
        for attempt in range(64):
            plan = cls._random_once(np.random.default_rng(
                np.random.SeedSequence([int(seed), attempt])),
                seed, n_edges, n_steps, n_domains, min_alive, p_fault,
                max_concurrent, max_transient, allow_crash)
            if set(require) <= set(plan.kinds()):
                return plan
        raise ValueError(
            f"could not generate a plan containing {require} in 64 "
            f"attempts (seed {seed}): loosen the constraints (more steps, "
            "higher p_fault) or drop the requirement.")

    @classmethod
    def _random_once(cls, rng, seed, n_edges, n_steps, n_domains,
                     min_alive, p_fault, max_concurrent, max_transient,
                     allow_crash) -> "FaultPlan":
        events = []
        dead_edges: set = set()       # edge-granular failures
        dead_doms: set = set()        # whole-domain failures
        partition: Optional[set] = None
        crashed = False
        block = (n_edges // n_domains) if n_domains else 0

        def dom_edges(d):
            return set(range(d * block, (d + 1) * block))

        def dead_all():
            out = set(dead_edges)
            for d in dead_doms:
                out |= dom_edges(d)
            return out

        def effective():
            return (set(range(n_edges)) - dead_all()
                    - (partition if partition else set()))

        for step in range(n_steps):
            if rng.random() >= p_fault:
                continue
            feasible = ["flush_fail"]
            eff = effective()
            if (len(dead_all()) < max_concurrent
                    and len(eff) > min_alive + 1):
                feasible.append("fail_edges")
            # One dead domain at a time: a whole-block loss already counts
            # as the plan's big concurrent failure.
            if n_domains and not dead_doms and any(
                    dom_edges(d) <= eff
                    and len(eff - dom_edges(d)) >= min_alive
                    for d in range(n_domains)):
                feasible.append("fail_device")
            if dead_edges:
                feasible.append("recover_edges")
            if dead_doms:
                feasible.append("recover_device")
            if partition is None and len(eff) >= min_alive + 2:
                feasible.append("partition")
            if partition is not None:
                feasible.append("heal")
            if allow_crash and not crashed:
                feasible.append("pipeline_crash")

            kind = str(rng.choice(sorted(feasible)))
            if kind == "fail_edges":
                k = int(rng.integers(1, min(2, len(eff) - min_alive) + 1))
                picks = rng.choice(sorted(eff), size=k, replace=False)
                edges = tuple(int(e) for e in np.sort(picks))
                dead_edges |= set(edges)
                events.append(FaultEvent(step, kind, (edges,)))
            elif kind == "fail_device":
                cands = [d for d in range(n_domains)
                         if d not in dead_doms
                         and dom_edges(d) <= eff
                         and len(eff - dom_edges(d)) >= min_alive]
                if not cands:
                    continue
                d = int(rng.choice(cands))
                dead_doms.add(d)
                events.append(FaultEvent(step, kind, (d,)))
            elif kind == "recover_edges":
                k = int(rng.integers(1, len(dead_edges) + 1))
                picks = rng.choice(sorted(dead_edges), size=k,
                                   replace=False)
                edges = tuple(int(e) for e in np.sort(picks))
                dead_edges -= set(edges)
                events.append(FaultEvent(step, kind, (edges,)))
            elif kind == "recover_device":
                d = int(rng.choice(sorted(dead_doms)))
                dead_doms.discard(d)
                events.append(FaultEvent(step, kind, (d,)))
            elif kind == "partition":
                reach = sorted(effective())
                hi = max(1, len(reach) - min_alive)
                k = int(rng.integers(1, hi + 1))
                cut = {int(e) for e in rng.choice(reach, size=k,
                                                  replace=False)}
                partition = cut
                keep = tuple(s for s in range(n_edges) if s not in cut)
                events.append(FaultEvent(
                    step, kind, ((keep, tuple(sorted(cut))),)))
            elif kind == "heal":
                partition = None
                events.append(FaultEvent(step, kind, ()))
            elif kind == "pipeline_crash":
                crashed = True
                events.append(FaultEvent(step, kind, ()))
            else:       # flush_fail
                n = int(rng.integers(1, max_transient + 1))
                events.append(FaultEvent(step, kind, (n,)))

        # Close every open fault at the horizon: the fleet must end whole
        # so the final repair converges to the never-faulted placement.
        if partition is not None:
            events.append(FaultEvent(n_steps, "heal", ()))
        if dead_edges:
            events.append(FaultEvent(
                n_steps, "recover_edges", (tuple(sorted(dead_edges)),)))
        for d in sorted(dead_doms):
            events.append(FaultEvent(n_steps, "recover_device", (d,)))
        return cls(events=tuple(events), n_steps=n_steps, seed=int(seed))
