"""Streaming ingest (port of ``repro.ingest``): the host-side front door that
turns ragged, unreliable per-drone telemetry into the store's shard batches
— submit queue with (drone, seq) dedup and backpressure, batch coalescing
over ``AerialDB.insert`` / ``ingest_rounds`` (one non-blocking copy a chunk
from pinned memory on the card), a write-ahead journal, and the
latest-per-drone overlay.

Layering: this package sits strictly above ``repro_torch.api`` (it only
drives the facade) and is host-side numpy plus dispatch.

    from repro_torch.api import AerialDB
    from repro_torch.ingest import IngestPipeline

    pipe = IngestPipeline(AerialDB.open(cfg, max_drones=D))
    pipe.submit([(drone_id, seq, t, lat, lon, *values), ...])
    pipe.flush()                       # full shards -> device
    record, valid = pipe.latest()      # store cache + in-flight records
"""

from repro_torch.ingest.coalesce import group_shards, plan_chunks
from repro_torch.ingest.journal import WriteAheadJournal
from repro_torch.ingest.latest import (latest_oracle, latest_oracle_sorted,
                                       overlay_latest)
from repro_torch.ingest.pipeline import (IngestPipeline, PipelineCrash,
                                         TransientDispatchError)

__all__ = ["IngestPipeline", "PipelineCrash", "TransientDispatchError",
           "WriteAheadJournal", "group_shards", "plan_chunks",
           "latest_oracle", "latest_oracle_sorted", "overlay_latest"]
