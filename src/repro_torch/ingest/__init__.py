"""Streaming ingest (port of ``repro.ingest``): so far the latest-per-drone
oracle and overlay, numpy only. The pipeline, coalescer and journal are a
later slice (ROADMAP Queue 1).
"""

from repro_torch.ingest.latest import (latest_oracle, latest_oracle_sorted,
                                       overlay_latest)

__all__ = ["latest_oracle", "latest_oracle_sorted", "overlay_latest"]
