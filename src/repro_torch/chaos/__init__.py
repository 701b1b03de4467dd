"""Chaos engine (port of ``repro.chaos``): seeded fault injection for the
store, driven through the port's public surfaces.

* :class:`FaultPlan` / :class:`FaultEvent` (``plan.py``) — a deterministic,
  seeded schedule of timed faults: edge crash/recover, whole failure-domain
  loss, fleet network partition/heal, transient flush-dispatch failures,
  mid-flush pipeline crash. ``FaultPlan.random(seed, ...)`` is pure numpy
  in its seed and gives the reference's plan event for event.
* :class:`ChaosRunner` (``runner.py``) — applies a plan against a live
  ``AerialDB`` session + ``IngestPipeline`` (on the card or the CPU),
  logging every injected event (with repair/ledger effect telemetry) as
  JSON.
* ``audit.py`` — the canonical-content equivalence check: after the final
  heal + repair a faulted store must hold bit-identical content to a
  never-faulted twin, independent of ring write order.

Layering: chaos sits above ``repro_torch.ingest`` and ``repro_torch.api``
and drives only their public surfaces (session membership calls, the
pipeline's ``fault_hook``).
"""

from repro_torch.chaos.audit import assert_content_equal, canonical_content
from repro_torch.chaos.plan import EVENT_KINDS, FaultEvent, FaultPlan
from repro_torch.chaos.runner import ChaosRunner

__all__ = ["EVENT_KINDS", "FaultEvent", "FaultPlan", "ChaosRunner",
           "assert_content_equal", "canonical_content"]
