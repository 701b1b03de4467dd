"""Write-ahead journal for crash-durable ingest (port of
``repro.ingest.journal``; the same file format, byte for byte).

``IngestPipeline`` is host-side state: a process crash mid-flush loses every
accepted-but-unflushed record, and (because the store's device state is not
persisted either) the recovery story for an edge server is "rebuild from the
journal". This module is the minimal durable half of that contract:

* **append-before-ack** — the pipeline appends every ACCEPTED record
  (post-dedup, post-validation) before ``submit`` returns, so any record a
  producer saw acknowledged is on disk;
* **fixed-size binary records** — ``(drone int64, seq int64, row
  float32[width])`` after a magic+width header. Fixed size makes torn tails
  self-describing: a crash mid-append leaves a partial record that
  ``replay`` simply excludes (and reopen truncates) — no checksums or
  framing needed;
* **idempotent replay** — ``replay`` returns the journaled columns for
  re-submission through a fresh pipeline; the pipeline's ``(drone, seq)``
  dedup makes double-replay (or replay over a partially-recovered stream)
  converge instead of double-counting.

The journal is append-only for its lifetime (compaction/checkpointing is a
follow-up — see ROADMAP); ``fsync=True`` trades throughput for
power-loss durability, the default flushes to the OS on every append
(process-crash durable, the chaos model's fault).
"""

from __future__ import annotations

import os
import struct

import numpy as np

__all__ = ["WriteAheadJournal"]

_MAGIC = b"ADBWAL1\x00"
_HEADER = struct.Struct("<I")          # tuple width, after the magic


class WriteAheadJournal:
    """Append-only (drone, seq, row) record log with torn-tail recovery.

    Args:
      path:  journal file; created (with header) if absent, validated and
             truncated to the last whole record if it exists.
      width: the store's tuple width (``StoreConfig.tuple_width``) — the
             float32 row length per record. Reopening with a different
             width raises instead of silently mis-framing.
      fsync: fsync after every append (power-loss durability); default
             False flushes to the OS (process-crash durability).
    """

    def __init__(self, path, width: int, *, fsync: bool = False):
        self.path = os.fspath(path)
        self.width = int(width)
        self.fsync = bool(fsync)
        self._rec = np.dtype([("drone", "<i8"), ("seq", "<i8"),
                              ("row", "<f4", (self.width,))])
        header = _MAGIC + _HEADER.pack(self.width)
        size = os.path.getsize(self.path) if os.path.exists(self.path) else 0
        if size < len(header):
            # Fresh journal (or a crash tore even the header): start clean.
            with open(self.path, "wb") as f:
                f.write(header)
        else:
            with open(self.path, "rb") as f:
                head = f.read(len(header))
            if head[:len(_MAGIC)] != _MAGIC:
                raise ValueError(
                    f"{self.path} is not an AerialDB WAL (bad magic).")
            (w,) = _HEADER.unpack(head[len(_MAGIC):])
            if w != self.width:
                raise ValueError(
                    f"{self.path} was written with tuple width {w}, but "
                    f"this store has width {self.width}: replaying it here "
                    "would mis-frame every record.")
            torn = (size - len(header)) % self._rec.itemsize
            if torn:
                # Crash mid-append: drop the partial trailing record so
                # subsequent appends stay frame-aligned.
                with open(self.path, "r+b") as f:
                    f.truncate(size - torn)
        self._f = open(self.path, "ab")
        self._n = ((os.path.getsize(self.path) - len(header))
                   // self._rec.itemsize)

    @property
    def n_records(self) -> int:
        """Whole records on disk (torn tails excluded)."""
        return self._n

    @property
    def itemsize(self) -> int:
        """On-disk bytes per record (the torn-tail framing unit)."""
        return self._rec.itemsize

    def append(self, drone, seq, rows) -> int:
        """Append one batch of accepted records; returns the batch size.
        The write is flushed to the OS before returning (fsynced when the
        journal was opened with ``fsync=True``)."""
        drone = np.asarray(drone, np.int64).reshape(-1)
        n = drone.shape[0]
        buf = np.empty(n, self._rec)
        buf["drone"] = drone
        buf["seq"] = np.asarray(seq, np.int64).reshape(-1)
        buf["row"] = np.asarray(rows, np.float32).reshape(n, self.width)
        self._f.write(buf.tobytes())
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._n += n
        return n

    def replay(self):
        """Read every whole record back: ``(drone (N,), seq (N,), rows
        (N, width), info)`` — bit-exact copies of what was appended (NaN
        partial-payload channels included). A torn tail (crash mid-append)
        is excluded and reported in ``info["torn_bytes"]``; re-submitting
        the result through a pipeline is idempotent by (drone, seq)
        dedup."""
        self._f.flush()
        with open(self.path, "rb") as f:
            data = f.read()
        body = data[len(_MAGIC) + _HEADER.size:]
        item = self._rec.itemsize
        n = len(body) // item
        recs = np.frombuffer(body[:n * item], self._rec)
        return (recs["drone"].copy(), recs["seq"].copy(),
                recs["row"].copy(),
                {"records": int(n), "torn_bytes": int(len(body) - n * item)})

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "WriteAheadJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
