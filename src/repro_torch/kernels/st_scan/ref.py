"""Plain PyTorch version of the spatio-temporal predicate scan (st_scan).

Port of ``repro.kernels.st_scan.ref``. For every (query q, edge e) pair it
aggregates the edge's live tuples (``slot < min(count, valid_c)``) that pass
the query's spatial/temporal/sid predicate AND belong to a shard in the
(q, e) OR-list:

    sublist_len > 0 — OR-list filter with that many valid (hi, lo) entries,
                = 0 — edge not selected: contributes nothing,
                < 0 — scan-all sentinel (no shard scoping).

The log arrives column-major, ``(E, 3+V, C)`` / ``(E, 2, C)``. The JAX form
materialises (Q, E, C, L); this version loops over queries and over chunks
of the tuple axis, so it also runs on the card at the store's real sizes
(the CUDA kernel is held against it there). Counts, minima and maxima equal
the JAX reference's bit for bit; sums agree to reduction order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Elements of the (E, chunk, L) OR-list comparison built per step.
_CHUNK_ELEMS = 1 << 26


def check_channels(channels, n_cols: int) -> Tuple[int, ...]:
    """Validate a static channel tuple against a ``3 + V``-row log; returns
    the value-row indices (``3 + channel``)."""
    if isinstance(channels, int):
        channels = (channels,)
    channels = tuple(int(c) for c in channels)
    if not channels:
        raise ValueError("channels is empty: select at least one sensor "
                         "channel to aggregate.")
    if len(set(channels)) != len(channels):
        raise ValueError(
            f"channels={channels} contains duplicates: each channel is "
            "aggregated once per scan; deduplicate the request.")
    for ch in channels:
        if not 0 <= ch < n_cols - 3:
            raise ValueError(
                f"channel={ch} is not a valid sensor channel: the tuple log "
                f"holds {n_cols - 3} channels (value rows 3..{n_cols - 1}; "
                "negative channels would alias the t/lat/lon metadata rows).")
    return tuple(3 + ch for ch in channels)


def tuple_pred_match(tup_f, tup_sid, pred, qi: Optional[int] = None):
    """Tuple-level predicate (no shard list): (Q, E, C) bool, or (E, C) for
    the single query ``qi``. ``tup_f``/``tup_sid`` are column-major."""
    t, lat, lon = tup_f[:, 0, :], tup_f[:, 1, :], tup_f[:, 2, :]
    sid_hi, sid_lo = tup_sid[:, 0, :], tup_sid[:, 1, :]

    def bc(x):
        return x[qi] if qi is not None else x[:, None, None]

    sp = (bc(pred.lat0) <= lat) & (lat <= bc(pred.lat1)) & \
         (bc(pred.lon0) <= lon) & (lon <= bc(pred.lon1))
    tp = (bc(pred.t0) <= t) & (t <= bc(pred.t1))
    ip = (sid_hi == bc(pred.sid_hi)) & (sid_lo == bc(pred.sid_lo))
    hs, ht, hi = bc(pred.has_spatial), bc(pred.has_temporal), bc(pred.has_sid)
    m_and = (sp | ~hs) & (tp | ~ht) & (ip | ~hi)
    m_or = (sp & hs) | (tp & ht) | (ip & hi)
    return torch.where(bc(pred.is_and), m_and, m_or)


def _query_masks(tup_f, tup_sid, tup_count, pred, sublists, sublist_len,
                 valid_c: Optional[int]):
    """Yield (qi, m) for every query: m (E, C) bool, the slots query qi
    aggregates (live, predicate AND shard OR-list)."""
    e, w, c = tup_f.shape
    q, _, l, _ = sublists.shape
    if valid_c is None:
        valid_c = c
    dev = tup_f.device
    n_valid = torch.clamp(tup_count.to(torch.int32), max=min(valid_c, c))
    slot = torch.arange(c, dtype=torch.int32, device=dev)
    alive_t = slot[None, :] < n_valid[:, None]                       # (E, C)
    sid_hi, sid_lo = tup_sid[:, 0, :], tup_sid[:, 1, :]
    entry = torch.arange(l, dtype=torch.int32, device=dev)
    chunk = max(1, _CHUNK_ELEMS // max(1, e * l))
    for qi in range(q):
        slen = sublist_len[qi]                                       # (E,)
        entry_ok = entry[None, :] < slen.abs()[:, None]              # (E, L)
        lst = sublists[qi]                                           # (E, L, 2)
        in_list = torch.empty((e, c), dtype=torch.bool, device=dev)
        for a in range(0, c, chunk):
            hit = ((sid_hi[:, a:a + chunk, None] == lst[:, None, :, 0])
                   & (sid_lo[:, a:a + chunk, None] == lst[:, None, :, 1])
                   & entry_ok[:, None, :])                           # (E, c, L)
            in_list[:, a:a + chunk] = hit.any(dim=-1)
        shard_ok = torch.where((slen < 0)[:, None], True, in_list) \
            & (slen != 0)[:, None]
        yield qi, tuple_pred_match(tup_f, tup_sid, pred, qi) & shard_ok & alive_t


def st_scan_ref(tup_f, tup_sid, tup_count, pred, sublists, sublist_len,
                channels: Tuple[int, ...] = (0,),
                valid_c: Optional[int] = None):
    """Plain scan.

    Args:
      tup_f:       (E, 3+V, C) float32 column-major tuple log.
      tup_sid:     (E, 2, C) int32.
      tup_count:   (E,) int32 total tuples ever written (monotonic).
      pred:        QueryPred with (Q,) fields.
      sublists:    (Q, E, L, 2) int32 shard OR-lists.
      sublist_len: (Q, E) int32 (see module docstring).
      channels:    sensor channels to aggregate (value rows ``3 + channel``).
      valid_c:     logical ring capacity; slots >= valid_c are never live.

    Returns (count (Q, E) int32, vsum/vmin/vmax (Q, K, E) float32).
    """
    e, w, c = tup_f.shape
    q = sublists.shape[0]
    value_rows = list(check_channels(channels, w))
    dev = tup_f.device
    vals = tup_f[:, value_rows, :]                                   # (E, K, C)
    count = torch.empty((q, e), dtype=torch.int32, device=dev)
    k = len(value_rows)
    vsum = torch.empty((q, k, e), dtype=torch.float32, device=dev)
    vmin = torch.empty_like(vsum)
    vmax = torch.empty_like(vsum)
    for qi, m in _query_masks(tup_f, tup_sid, tup_count, pred, sublists,
                              sublist_len, valid_c):
        mk = m[:, None, :]                                           # (E, 1, C)
        count[qi] = m.sum(dim=-1, dtype=torch.int32)
        vsum[qi] = torch.where(mk, vals, 0.0).sum(dim=-1).T
        vmin[qi] = torch.where(mk, vals, float("inf")).amin(dim=-1).T
        vmax[qi] = torch.where(mk, vals, float("-inf")).amax(dim=-1).T
    return count, vsum, vmin, vmax


def matched_slots(tup_f, tup_sid, tup_count, pred, sublists, sublist_len,
                  valid_c: Optional[int] = None):
    """(E, C) bool: the slots that some query of the batch aggregates (the
    slots whose channel words a scan must read)."""
    e, _, c = tup_f.shape
    any_m = torch.zeros((e, c), dtype=torch.bool, device=tup_f.device)
    for _, m in _query_masks(tup_f, tup_sid, tup_count, pred, sublists,
                             sublist_len, valid_c):
        any_m |= m
    return any_m
