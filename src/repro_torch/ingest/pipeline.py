"""``IngestPipeline``: the streaming front door over an ``AerialDB`` session
(port of ``repro.ingest.pipeline``).

The paper's headline setting (§4.4, D400) is hundreds of drones offloading
telemetry to edge servers *as it arrives* — ragged per-drone records at
arbitrary rates, with duplicates, drops, and partial payloads — while the
store wants clean ``(B, R, 3+V)`` shard batches. This module is the shape
between the two:

* **submit** — validate + dedup records by ``(drone_id, seq)`` into a
  pending columnar buffer, with bounded backpressure and exact counters
  (``accepted`` / ``duplicate`` / ``partial`` / ``dropped``). Out-of-order
  and gappy seq streams are first-class: a gap leaves per-drone "holes"
  that late arrivals may still fill; re-sent seqs are duplicates.
* **flush** — coalesce pending records into shards (``coalesce.py``) and
  drive them through ``AerialDB.insert`` / ``ingest_rounds``. On the card
  the dispatches are **asynchronous**: each chunk's payload and
  ``ShardMeta`` leave pinned host memory in one non-blocking copy and the
  insert only enqueues kernels, so host assembly of chunk k+1 overlaps
  chunk k's device work, and ``flush(block=True)`` waits once, on a CUDA
  event recorded after the last dispatch, which is also where per-record
  **ingest-to-queryable latency** (submit wall-time -> flush-complete
  wall-time) is stamped. On the CPU every op completes as it is called.
* **latest** — the store's O(drones) hot cache (``AerialDB.latest()``)
  overlaid with still-pending records, so "newest position per drone"
  includes in-flight telemetry the device has not seen yet.

Counter reconciliation: ``accepted == flushed_records + pending`` at all
times, and after a drain-flush on an all-alive store, ``sum(tup_count) ==
flushed_records * replication`` — every accepted record is on every
replica, exactly once.

Fault tolerance: each flush dispatch runs under bounded
**retry-with-backoff** — a ``TransientDispatchError`` (dropped RPC on the
intermittent UAV-edge link; injected through ``fault_hook``) is retried up
to ``max_retries`` times with exponential backoff, and a chunk that
exhausts its budget has its records returned to the pending buffer
(counters ``retries`` / ``gave_up``), so the ``accepted == flushed +
pending`` invariant survives every outcome. An optional **write-ahead
journal** (``journal=``) appends accepted records before ``submit`` acks;
after a crash (``PipelineCrash`` mid-flush), a fresh pipeline's
:meth:`replay_journal` re-submits the log — idempotent by the same
``(drone, seq)`` dedup — so no acknowledged record is ever lost. A
wall-clock **flush scheduler** (``flush_interval_s`` + :meth:`maybe_flush`)
and a post-flush **fan-out hook** (``on_flush=``, error-isolated) complete
the surface.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.api import ShardMeta
from repro_torch.ingest.coalesce import group_shards, plan_chunks
from repro_torch.ingest.journal import WriteAheadJournal
from repro_torch.ingest.latest import overlay_latest

__all__ = ["IngestPipeline", "PipelineCrash", "TransientDispatchError"]


class TransientDispatchError(RuntimeError):
    """A flush dispatch failed BEFORE mutating the store (dropped RPC,
    momentary link loss): safe to retry. Raised by transports or injected
    through ``IngestPipeline.fault_hook``."""


class PipelineCrash(RuntimeError):
    """Injected mid-flush process crash: deliberately NOT
    caught by the retry loop — it propagates out of ``flush`` and leaves
    the pipeline in the torn state a real crash would. Recovery is a fresh
    pipeline + :meth:`IngestPipeline.replay_journal`."""

# Per-drone seq gaps leave "holes" a late arrival may still fill. Hole sets
# are bounded per drone: a gap wider than this is treated as permanent loss
# (later arrivals inside it count as duplicates) instead of unbounded state.
_MAX_HOLES_PER_DRONE = 4096


# ShardMeta's field dtypes, in field order.
_META_DTYPES = (np.int32, np.int32) + (np.float32,) * 6


def _chunk_to(pays: np.ndarray, metas: ShardMeta, dev: torch.device):
    """One chunk's payload ``(N, B, k, W)`` and ShardMeta of ``(N, B)``
    fields as tensors on ``dev``, in ONE non-blocking copy: the chunk is
    packed into a pinned int32 buffer (float32 words by their bits, each
    part at a 128-byte offset) and viewed back on the card."""
    parts = [np.ascontiguousarray(pays, np.float32)] + [
        np.ascontiguousarray(f, dt) for f, dt in zip(metas, _META_DTYPES)]
    offs, n = [], 0
    for p in parts:
        offs.append(n)
        n += -(-p.size // 32) * 32
    buf = torch.empty(n, dtype=torch.int32, pin_memory=True)
    host = buf.numpy()
    for p, o in zip(parts, offs):
        host[o:o + p.size] = p.reshape(-1).view(np.int32)
    # The buffer comes from PyTorch's caching host allocator, which records
    # an event on the copy's stream and hands the block out again only once
    # that event has completed, so dropping it after the call is safe.
    card = buf.to(dev, non_blocking=True)
    out = [card[o:o + p.size].view(torch.float32 if p.dtype == np.float32
                                   else torch.int32).view(p.shape)
           for p, o in zip(parts, offs)]
    return out[0], ShardMeta(*out[1:])


class IngestPipeline:
    """Async telemetry queue + coalescer + latest overlay over one session.

    Args:
      db: the ``AerialDB`` session to feed (on the card or the CPU).
      max_pending: backpressure bound on buffered records; a ``submit``
        whose batch would exceed it has its tail dropped (counted).
      batch_shards: device batch size B for full shards; defaults to the
        largest power of two with ``B * records_per_shard <=
        tuple_capacity`` (capped at 256) so a batch can never wrap an
        edge ring within one insert step.
      journal: optional write-ahead journal — a path (opened as a
        ``WriteAheadJournal`` with the store's tuple width) or an already-
        open journal. Accepted records are appended before ``submit``
        returns; ``replay_journal`` on a fresh pipeline recovers them.
      journal_fsync: fsync the journal on every append (power-loss
        durability) when ``journal`` is given as a path.
      flush_interval_s: arm the wall-clock flush scheduler — see
        :meth:`maybe_flush`. None (default) leaves flushing fully manual.
      on_flush: post-flush fan-out callback ``cb(summary_dict)``, invoked
        after local storage whenever a flush shipped records. Error-
        isolated: a raising callback increments ``on_flush_errors`` and
        never poisons the flush.
      max_retries: bounded retry budget per dispatch on
        ``TransientDispatchError`` (0 disables retry).
      backoff_s / backoff_factor: exponential backoff schedule between
        retries (``backoff_s * backoff_factor**attempt``).
      sleep: injectable sleep (tests pass a no-op to keep seeded
        runs deterministic and fast).
    """

    def __init__(self, db, max_pending: int = 1 << 20,
                 batch_shards: Optional[int] = None, *,
                 journal=None, journal_fsync: bool = False,
                 flush_interval_s: Optional[float] = None,
                 on_flush: Optional[Callable[[dict], None]] = None,
                 max_retries: int = 4, backoff_s: float = 0.01,
                 backoff_factor: float = 2.0,
                 sleep: Callable[[float], None] = time.sleep):
        cfg = db.cfg
        self.db = db
        self.width = cfg.tuple_width
        self.r_full = cfg.records_per_shard
        self.max_pending = max_pending
        if batch_shards is None:
            batch_shards = 1
            while (batch_shards * 2 * self.r_full <= cfg.tuple_capacity
                   and batch_shards * 2 <= 256):
                batch_shards *= 2
        if batch_shards * self.r_full > cfg.tuple_capacity:
            raise ValueError(
                f"batch_shards={batch_shards} x records_per_shard="
                f"{self.r_full} exceeds tuple_capacity={cfg.tuple_capacity}: "
                "one edge could wrap its ring within a single insert step. "
                "Lower batch_shards or raise tuple_capacity.")
        self.batch_shards = batch_shards
        # Pending columnar buffer: list of (drone, seq, rows, t_submit).
        self._pend: list = []
        self._n_pending = 0
        # Dedup state: per-drone max accepted seq (grown on demand) + holes.
        self._max_seq = np.full(0, -1, np.int64)
        self._holes: Dict[int, set] = {}
        self._shard_seq: Dict[int, int] = {}
        self.counters = {"accepted": 0, "duplicate": 0, "partial": 0,
                         "dropped": 0, "dropped_malformed": 0,
                         "dropped_backpressure": 0, "flushed_records": 0,
                         "flushed_shards": 0, "flushes": 0,
                         "retries": 0, "gave_up": 0, "replayed": 0,
                         "on_flush_errors": 0}
        self.last_flush: Optional[dict] = None
        self.journal = (WriteAheadJournal(journal, self.width,
                                          fsync=journal_fsync)
                        if journal is not None
                        and not isinstance(journal, WriteAheadJournal)
                        else journal)
        self.flush_interval_s = flush_interval_s
        self.on_flush = on_flush
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_factor = float(backoff_factor)
        self._sleep = sleep
        # Fault/transport injection point: ``hook(pipeline, attempt)`` runs
        # before every device dispatch attempt; raising
        # TransientDispatchError exercises the retry path, PipelineCrash
        # the crash path. None in production with a reliable local device.
        self.fault_hook: Optional[Callable] = None
        self._replaying = False
        # maybe_flush deadline — armed lazily from the first call's clock,
        # so callers driving a synthetic ``now`` never mix clocks.
        self._flush_deadline: Optional[float] = None

    # -- submit --------------------------------------------------------------

    def _grow(self, n: int) -> None:
        if n > self._max_seq.shape[0]:
            grown = np.full(max(n, 2 * self._max_seq.shape[0]), -1, np.int64)
            grown[:self._max_seq.shape[0]] = self._max_seq
            self._max_seq = grown

    def submit(self, records) -> dict:
        """Queue ragged per-drone records; returns the live counters dict.

        ``records`` is a sequence of ``(drone_id, seq, t, lat, lon,
        values...)`` tuples (trailing values may be missing or None ->
        NaN-filled, counted ``partial``) or dicts with those keys (``values``
        a sequence). For bulk submission use :meth:`submit_arrays`.
        """
        n = len(records)
        v = self.width - 3
        drone = np.empty(n, np.int64)
        seq = np.empty(n, np.int64)
        cols = np.full((n, self.width), np.nan, np.float64)
        for i, rec in enumerate(records):
            if isinstance(rec, dict):
                flat = (rec["drone_id"], rec["seq"], rec["t"], rec["lat"],
                        rec["lon"], *(rec.get("values") or ()))
            else:
                flat = tuple(rec)
            if len(flat) > 5 + v:
                raise ValueError(
                    f"record {i} carries {len(flat) - 5} values but the "
                    f"store is configured for n_values={v}.")
            try:
                drone[i] = int(flat[0])
                seq[i] = int(flat[1])
                cols[i, :len(flat) - 2] = [float(x) for x in flat[2:]]
            except (TypeError, ValueError):
                drone[i] = -1        # malformed -> dropped below
        return self.submit_arrays(drone, seq, cols[:, 0], cols[:, 1],
                                  cols[:, 2], cols[:, 3:])

    def submit_arrays(self, drone, seq, t, lat, lon, values=None) -> dict:
        """Vectorized submit: (N,) id/seq/t/lat/lon arrays + optional
        (N, <=V) values (missing columns NaN-fill -> ``partial``)."""
        drone = np.asarray(drone, np.int64).reshape(-1)
        n = drone.shape[0]
        seq = np.asarray(seq, np.int64).reshape(-1)
        rows = np.full((n, self.width), np.nan, np.float32)
        rows[:, 0] = np.asarray(t, np.float32)
        rows[:, 1] = np.asarray(lat, np.float32)
        rows[:, 2] = np.asarray(lon, np.float32)
        if values is not None:
            values = np.asarray(values, np.float32).reshape(n, -1)
            if values.shape[1] > self.width - 3:
                raise ValueError(
                    f"values has {values.shape[1]} channels but the store is "
                    f"configured for n_values={self.width - 3}.")
            rows[:, 3:3 + values.shape[1]] = values

        # Malformed: broken id/seq or non-finite coordinates (value-channel
        # NaNs are partial payloads and fine; a NaN t/lat/lon would poison
        # placement + slicing).
        well = ((drone >= 0) & (seq >= 0)
                & np.isfinite(rows[:, :3]).all(axis=1))
        self.counters["dropped_malformed"] += int(n - well.sum())

        # Backpressure: bounded pending buffer; the batch's tail past the
        # budget is dropped (conservatively — duplicates in the kept head
        # still count against it).
        room = self.max_pending - self._n_pending
        kept = np.nonzero(well)[0]
        if kept.size > room:
            self.counters["dropped_backpressure"] += int(kept.size - room)
            kept = kept[:room]
        self.counters["dropped"] = (self.counters["dropped_malformed"]
                                    + self.counters["dropped_backpressure"])
        if kept.size == 0:
            return dict(self.counters)
        drone, seq, rows = drone[kept], seq[kept], rows[kept]
        self._grow(int(drone.max()) + 1)

        # Dedup by (drone, seq). Sorted view; within-batch re-sends keep the
        # first occurrence. Fast path: a drone whose batch records are
        # exactly the contiguous run max_seq+1.. needs no hole bookkeeping.
        order = np.lexsort((seq, drone))
        d_s, s_s = drone[order], seq[order]
        first = np.r_[True, d_s[1:] != d_s[:-1]]
        prev = np.where(first, self._max_seq[d_s], np.r_[np.int64(-1), s_s[:-1]])
        contig = s_s == prev + 1
        grp = np.cumsum(first) - 1
        all_contig = np.logical_and.reduceat(contig, np.nonzero(first)[0])
        accept = np.zeros(d_s.shape[0], bool)
        fast = all_contig[grp]
        accept[fast] = True
        np.maximum.at(self._max_seq, d_s[fast], s_s[fast])
        for i in np.nonzero(~fast)[0]:    # slow path: dups / gaps / refills
            did, s = int(d_s[i]), int(s_s[i])
            top = int(self._max_seq[did])
            if s > top:
                holes = self._holes.setdefault(did, set())
                gap = s - top - 1
                if gap and len(holes) + gap <= _MAX_HOLES_PER_DRONE:
                    holes.update(range(top + 1, s))
                self._max_seq[did] = s
                accept[i] = True
            elif s in self._holes.get(did, ()):
                self._holes[did].discard(s)
                accept[i] = True
            else:
                self.counters["duplicate"] += 1
        acc_idx = order[accept]
        if acc_idx.size:
            a_rows = rows[acc_idx]
            if self.journal is not None and not self._replaying:
                # Durability ordering: on disk BEFORE the ack (the returned
                # counters). Replayed records are already journaled.
                self.journal.append(drone[acc_idx], seq[acc_idx], a_rows)
            self.counters["partial"] += int(
                np.isnan(a_rows[:, 3:]).any(axis=1).sum())
            self._pend.append((drone[acc_idx], seq[acc_idx], a_rows,
                               np.full(acc_idx.size, time.monotonic())))
            self._n_pending += acc_idx.size
            self.counters["accepted"] += int(acc_idx.size)
        return dict(self.counters)

    # -- flush ---------------------------------------------------------------

    @property
    def pending(self) -> int:
        return self._n_pending

    def _dispatch(self, fn, *args) -> bool:
        """One device dispatch under the bounded retry-with-backoff loop.

        ``TransientDispatchError`` (from ``fault_hook`` or a raising
        transport) is retried up to ``max_retries`` times, sleeping
        ``backoff_s * backoff_factor**attempt`` between attempts; the retry
        contract assumes the failed dispatch did NOT mutate the store (an
        injected fault raises before the device call; a real transport must
        fail atomically). Returns False when the budget is exhausted
        (``gave_up`` counted — the caller returns the chunk's records to
        pending). ``PipelineCrash`` is deliberately not caught."""
        attempt = 0
        while True:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(self, attempt)
                fn(*args)
                return True
            except TransientDispatchError:
                if attempt >= self.max_retries:
                    self.counters["gave_up"] += 1
                    return False
                self.counters["retries"] += 1
                self._sleep(self.backoff_s * self.backoff_factor ** attempt)
                attempt += 1

    def flush(self, drain: bool = False, block: bool = True) -> dict:
        """Coalesce pending records into shards and ingest them.

        Full ``records_per_shard`` groups always ship; ``drain=True`` also
        ships trailing partial groups (batched by size). On the card each
        chunk goes from pinned host memory to the card in one non-blocking
        copy and reaches the session as device tensors; the dispatches only
        enqueue work — host assembly of chunk k+1 overlaps chunk k's — and
        ``block=True`` ends with one wait, on a CUDA event recorded after
        the last dispatch, stamping per-record ingest-to-queryable latency;
        ``block=False`` returns without waiting. On the CPU the session's
        ops complete as they are called.
        Each dispatch runs under :meth:`_dispatch` retry; a chunk that
        exhausts its retry budget has its records returned to the pending
        buffer (``accepted == flushed + pending`` holds through give-ups;
        a later flush re-coalesces them).

        Returns a summary dict (also kept on ``last_flush``): shards/records
        flushed, dispatch count, this flush's ``retries`` / ``gave_up`` /
        ``returned_records``, and (when blocking) ``latency_s`` — the
        flushed records' submit->queryable wall times. ``on_flush`` fires
        (error-isolated) after local storage whenever records shipped.
        """
        retries0 = self.counters["retries"]
        gave0 = self.counters["gave_up"]
        if not self._pend:
            out = {"flushed_shards": 0, "flushed_records": 0,
                   "dispatches": 0, "retries": 0, "gave_up": 0,
                   "returned_records": 0, "latency_s": np.empty(0)}
            self.last_flush = out
            return out
        drone = np.concatenate([p[0] for p in self._pend])
        seq = np.concatenate([p[1] for p in self._pend])
        rows = np.concatenate([p[2] for p in self._pend])
        tsub = np.concatenate([p[3] for p in self._pend])
        batches, leftover = group_shards(drone, seq, rows, self.r_full,
                                         self._shard_seq, drain)
        dev = self.db.device
        on_card = dev.type == "cuda"
        n_shards = n_records = dispatches = 0
        flushed_tsub = []
        failed_idx = []
        for k, (pay, meta, idx) in sorted(batches.items()):
            b_total = pay.shape[0]
            b_max = max(self.batch_shards * self.r_full // max(k, 1), 1)
            off = 0
            sizes = plan_chunks(b_total, b_max)
            i = 0
            while i < len(sizes):
                # Equal-size run -> ONE fused multi-round scan dispatch.
                j = i
                while j < len(sizes) and sizes[j] == sizes[i]:
                    j += 1
                nb, b = j - i, sizes[i]
                sl = slice(off, off + nb * b)
                pays = pay[sl].reshape(nb, b, k, self.width)
                metas = type(meta)(*(np.asarray(f)[sl].reshape(nb, b)
                                     for f in meta))
                if on_card:
                    pays, metas = _chunk_to(pays, metas, dev)
                if nb == 1:
                    ok = self._dispatch(
                        self.db.insert, pays[0],
                        type(meta)(*(f[0] for f in metas)))
                else:
                    ok = self._dispatch(self.db.ingest_rounds, pays, metas)
                dispatches += 1
                chunk_idx = np.asarray(idx)[sl].reshape(-1)
                if ok:
                    n_shards += nb * b
                    n_records += chunk_idx.size
                    flushed_tsub.append(tsub[chunk_idx])
                else:
                    failed_idx.append(chunk_idx)
                off += nb * b
                i = j
        # Keep the leftover (sub-shard) tails AND any gave-up chunks'
        # records pending. (Gave-up shards already consumed their sid_lo
        # numbers — the re-flush assigns fresh ones, which only needs sids
        # to stay unique, not dense.)
        keep = (np.concatenate([leftover] + failed_idx)
                if failed_idx else leftover)
        self._pend = ([(drone[keep], seq[keep], rows[keep], tsub[keep])]
                      if keep.size else [])
        self._n_pending = int(keep.size)
        self.counters["flushed_shards"] += n_shards
        self.counters["flushed_records"] += n_records
        self.counters["flushes"] += 1
        out = {"flushed_shards": n_shards, "flushed_records": n_records,
               "dispatches": dispatches,
               "retries": self.counters["retries"] - retries0,
               "gave_up": self.counters["gave_up"] - gave0,
               "returned_records": int(sum(f.size for f in failed_idx)),
               "latency_s": np.empty(0)}
        if block:
            if on_card:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                ev.synchronize()
            done = time.monotonic()
            if flushed_tsub:
                out["latency_s"] = done - np.concatenate(flushed_tsub)
        self.last_flush = out
        if self.on_flush is not None and n_records:
            # Fan-out AFTER local storage; error-isolated — a raising
            # subscriber never poisons the flush.
            try:
                self.on_flush(out)
            except Exception:
                self.counters["on_flush_errors"] += 1
        return out

    def maybe_flush(self, now: Optional[float] = None, *,
                    drain: bool = False, block: bool = True
                    ) -> Optional[dict]:
        """Wall-clock flush scheduler: flush iff ``now`` has passed the
        armed deadline, then re-arm ``flush_interval_s`` ahead.

        The deadline arms lazily on the first call (from ITS clock), so
        callers driving a synthetic ``now`` never race the constructor's
        wall clock; ``now=None`` reads ``time.monotonic()``. Returns the
        flush summary — with the triggering ``deadline`` and ``late_s``
        stamped into it (and thus into ``last_flush``) — when a flush ran,
        else None. Requires ``flush_interval_s``."""
        if self.flush_interval_s is None:
            raise ValueError(
                "maybe_flush() needs a flush interval: open the pipeline "
                "with IngestPipeline(db, flush_interval_s=...) — or call "
                "flush() directly for manual control.")
        if now is None:
            now = time.monotonic()
        if self._flush_deadline is None:
            self._flush_deadline = now + self.flush_interval_s
        if now < self._flush_deadline:
            return None
        deadline = self._flush_deadline
        out = self.flush(drain=drain, block=block)
        out["deadline"] = deadline
        out["late_s"] = now - deadline
        self._flush_deadline = now + self.flush_interval_s
        return out

    # -- journal recovery ----------------------------------------------------

    def replay_journal(self, batch: int = 8192) -> dict:
        """Re-submit every journaled record through the normal ``submit``
        path (crash recovery: fresh pipeline + fresh/rebuilt session +
        replay). Idempotent: the ``(drone, seq)`` dedup absorbs records
        that already made it in (double replay accepts nothing twice).
        Replay respects backpressure by flushing whenever the pending
        buffer could not absorb the next batch. Returns a summary dict;
        the accepted delta is also counted in ``counters['replayed']``."""
        if self.journal is None:
            raise ValueError(
                "no journal to replay: open the pipeline with journal=... "
                "(a path or WriteAheadJournal).")
        d, s, r, info = self.journal.replay()
        acc0 = self.counters["accepted"]
        self._replaying = True
        try:
            for i in range(0, d.shape[0], batch):
                if self._n_pending + batch > self.max_pending:
                    self.flush()
                j = min(i + batch, d.shape[0])
                self.submit_arrays(d[i:j], s[i:j], r[i:j, 0], r[i:j, 1],
                                   r[i:j, 2], r[i:j, 3:])
        finally:
            self._replaying = False
        accepted = self.counters["accepted"] - acc0
        self.counters["replayed"] += accepted
        return {"journal_records": info["records"],
                "torn_bytes": info["torn_bytes"], "accepted": accepted,
                "already_seen": info["records"] - accepted}

    def close(self) -> None:
        """Close the journal file handle (the pipeline itself is
        stateless on disk beyond it)."""
        if self.journal is not None:
            self.journal.close()

    # -- latest overlay ------------------------------------------------------

    def latest(self):
        """``(record (D, W), valid (D,))`` numpy — the store's hot cache
        with still-pending (in-flight) records overlaid, so the answer is
        exact over everything ever *submitted*, not just flushed. The cache
        comes to the host in one copy (records by their bits beside
        ``last_seen``)."""
        res = self.db.latest()
        w = res.record.shape[1]
        packed = torch.cat([res.record.view(torch.int32),
                            res.last_seen.to(torch.int32)[:, None]],
                           dim=1).cpu().numpy()
        record = np.ascontiguousarray(packed[:, :w]).view(np.float32)
        valid = packed[:, w] >= 0
        for d, _s, rows, _t in self._pend:
            overlay_latest(record, valid, d, rows[:, 0], rows)
        return record, valid

    # -- reconciliation ------------------------------------------------------

    def reconcile(self) -> dict:
        """Exact counter reconciliation.

        Two legs, reported separately so a caller can gate each where it
        holds:

        * ``counters_ok`` — ``accepted == flushed_records + pending``.
          Holds at EVERY step, through retries, give-ups (gave-up chunks
          return to pending), journal replay, partitions, and outages.
        * ``stored_ok`` — ``sum(tup_count) == flushed_records *
          replication``. Holds at convergence points: an all-effective
          store that never wrapped, reclaimed mid-degradation, or dropped —
          including after a full heal/recover + repair, where every shard
          is back to exactly ``replication`` canonical copies. Mid-outage
          it can legitimately over-count (stale frozen copies on dead
          edges await reclamation).

        ``ok`` is their conjunction. Returns the evidence dict; raises
        nothing (callers assert). Reads one number from the device."""
        c = self.counters
        stored = int(self.db.state.tup_count.sum())
        expect = c["flushed_records"] * self.db.cfg.replication
        counters_ok = c["accepted"] == c["flushed_records"] + self._n_pending
        stored_ok = stored == expect
        return {"ok": counters_ok and stored_ok, "counters_ok": counters_ok,
                "stored_ok": stored_ok, "accepted": c["accepted"],
                "flushed_records": c["flushed_records"],
                "pending": self._n_pending, "stored_tuples": stored,
                "expected_tuples": expect,
                "duplicate": c["duplicate"], "partial": c["partial"],
                "dropped": c["dropped"], "retries": c["retries"],
                "gave_up": c["gave_up"], "replayed": c["replayed"]}
