"""Host-side latest-per-drone oracle + overlay (port of
``repro.ingest.latest``; numpy only).

The device-side hot cache (``core.datastore._update_latest``, served by
``AerialDB.latest()``) answers "newest record per drone" in O(drones). This
module is its *specification*: a brute-force oracle over an explicit record
set, and the overlay of still-pending (in-flight) records onto the store's
cache answer.

Tie rule (shared with the device cache): among records of one drone with the
same maximal ``t``, the **latest arrival wins** — last position in the
record stream for the oracle, highest flat batch index for the device
scatter, pending-over-stored for the overlay.
"""

from __future__ import annotations

import numpy as np

__all__ = ["latest_oracle", "latest_oracle_sorted", "overlay_latest"]


def latest_oracle(drone_ids, t, rows, max_drones: int):
    """Brute-force latest-per-drone over an explicit record set.

    Args:
      drone_ids: (N,) int drone id per record.
      t:         (N,) float timestamp per record.
      rows:      (N, W) float full records (t, lat, lon, values...).
      max_drones: cache size D; ids outside [0, D) are ignored.

    Returns ``(record (D, W) float32, valid (D,) bool)`` — for each drone,
    the max-t record (later stream position wins t ties; non-finite t
    excluded), zeros where the drone never appears.
    """
    drone_ids = np.asarray(drone_ids).reshape(-1)
    t = np.asarray(t, np.float32).reshape(-1)
    rows = np.asarray(rows, np.float32).reshape(t.shape[0], -1)
    record = np.zeros((max_drones, rows.shape[1]), np.float32)
    valid = np.zeros((max_drones,), bool)
    best_t = np.full((max_drones,), -np.inf, np.float32)
    ok = np.isfinite(t) & (drone_ids >= 0) & (drone_ids < max_drones)
    for i in np.nonzero(ok)[0]:
        d = int(drone_ids[i])
        if t[i] >= best_t[d]:
            best_t[d] = t[i]
            record[d] = rows[i]
            valid[d] = True
    return record, valid


def latest_oracle_sorted(drone_ids, t, rows, max_drones: int):
    """``latest_oracle`` without the Python loop, for record sets of
    millions: sort the admitted records by (drone, t, arrival) and take
    each drone's last. ``-0.0`` and ``+0.0`` sort as equal, so arrival
    breaks their tie, as ``>=`` does in the loop.

    Returns ``(record (D, W) float32, valid (D,) bool, source (D,) int64)``;
    ``source`` is the stream position of each drone's record, -1 where
    none (a cache's ``last_seen`` is the insert that carried it).
    """
    drone_ids = np.asarray(drone_ids).reshape(-1)
    t = np.asarray(t, np.float32).reshape(-1)
    rows = np.asarray(rows, np.float32).reshape(t.shape[0], -1)
    pos = np.nonzero(np.isfinite(t) & (drone_ids >= 0)
                     & (drone_ids < max_drones))[0]
    order = pos[np.lexsort((pos, t[pos], drone_ids[pos]))]
    ids = drone_ids[order]
    last = order[np.r_[ids[1:] != ids[:-1], True]] if order.size else order
    record = np.zeros((max_drones, rows.shape[1]), np.float32)
    source = np.full((max_drones,), -1, np.int64)
    record[drone_ids[last]] = rows[last]
    source[drone_ids[last]] = last
    return record, source >= 0, source


def overlay_latest(record, valid, drone_ids, t, rows):
    """Overlay in-flight records onto a store cache answer, IN PLACE.

    ``record``/``valid`` are host copies of ``LatestResult.record`` /
    ``.valid``; pending records win ties against stored ones (they are the
    later arrival by definition — still unflushed). Returns (record, valid).
    """
    d_max = record.shape[0]
    pend_rec, pend_valid = latest_oracle(drone_ids, t, rows, d_max)
    stored_t = np.where(valid, record[:, 0], -np.inf)
    pend_t = np.where(pend_valid, pend_rec[:, 0], -np.inf)
    win = pend_valid & (pend_t >= stored_t)
    record[win] = pend_rec[win]
    valid |= win
    return record, valid
