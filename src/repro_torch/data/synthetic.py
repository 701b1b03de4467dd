"""Synthetic drone-fleet workload generator (paper §4.2, §4.4.1).

A numpy-only copy of ``repro.data.synthetic`` (the port imports nothing from
the JAX package); the same seeds give the same fleets, sites and queries.

Emulates the paper's setup: D drones random-walking a city region (the paper
uses ~20 km x 25 km of Bangalore; we use a configurable lat/lon box), each
sampling sensors every ``sample_period`` seconds and batching
``records_per_shard`` records into a shard (paper: 60 records / 5 min,
~17 kB). Edge sites are placed uniformly at random inside the region (the
paper samples OpenCellID tower locations).

Mobility follows the paper's random walk: at every step a drone either hovers
(P=0.8) or moves to a random neighboring waypoint (P=0.2) at ~10 m/s. Since
street graphs are out of scope, waypoints are a jittered lattice — what
matters to AerialDB is the spatio-temporal *distribution* of shards, not road
topology (the paper itself confines mobility to the communication plane,
§4.6).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.placement import ShardMeta


@dataclasses.dataclass(frozen=True)
class CityConfig:
    lat_min: float = 12.85      # ~Bangalore
    lat_max: float = 13.10      # ~27 km
    lon_min: float = 77.45
    lon_max: float = 77.75      # ~33 km
    p_hover: float = 0.8
    speed_deg: float = 0.0001   # ~11 m per 1 s step at these latitudes


def make_sites(n_edges: int, city: CityConfig, seed: int = 0) -> np.ndarray:
    """(E, 2) edge-server locations (stand-in for OpenCellID towers)."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(city.lat_min, city.lat_max, n_edges)
    lon = rng.uniform(city.lon_min, city.lon_max, n_edges)
    return np.stack([lat, lon], axis=1).astype(np.float32)


class DroneFleet:
    """Streaming shard generator for D drones."""

    def __init__(self, n_drones: int, city: CityConfig = CityConfig(),
                 records_per_shard: int = 60, sample_period: float = 5.0,
                 n_values: int = 4, seed: int = 1, stagger_s: float = 0.0):
        """``stagger_s`` de-synchronizes drone clocks (paper §3.4.1's
        random-delay mitigation for the H_t temporal-clustering hotspot):
        each drone's collection schedule is offset uniformly in
        [0, stagger_s). stagger_s ~ tau spreads per-round temporal
        mid-points across H_t buckets."""
        self.n_drones = n_drones
        self.city = city
        self.r = records_per_shard
        self.n_values = n_values
        self.sample_period = sample_period
        self.rng = np.random.default_rng(seed)
        self.t_offset = self.rng.uniform(0, stagger_s, n_drones) \
            if stagger_s > 0 else np.zeros(n_drones)
        self.pos = np.stack([
            self.rng.uniform(city.lat_min, city.lat_max, n_drones),
            self.rng.uniform(city.lon_min, city.lon_max, n_drones)], axis=1)
        self.t = 0.0
        self.seq = 0

    def next_shards(self):
        """One collection round: every drone emits one shard.

        Returns (payload (D, R, 3+V) float32, ShardMeta of numpy arrays).
        """
        d, r, v = self.n_drones, self.r, self.n_values
        c = self.city
        times = self.t + np.arange(r)[None, :] * self.sample_period \
            + self.t_offset[:, None]                                  # (D, R)
        lats = np.empty((d, r))
        lons = np.empty((d, r))
        for k in range(r):
            hover = self.rng.random(d) < c.p_hover
            step = self.rng.normal(0, c.speed_deg * self.sample_period, (d, 2))
            self.pos = np.where(hover[:, None], self.pos, self.pos + step)
            self.pos[:, 0] = np.clip(self.pos[:, 0], c.lat_min, c.lat_max)
            self.pos[:, 1] = np.clip(self.pos[:, 1], c.lon_min, c.lon_max)
            lats[:, k] = self.pos[:, 0]
            lons[:, k] = self.pos[:, 1]
        values = self.rng.normal(25.0, 5.0, (d, r, v))                # sensor obs
        payload = np.concatenate(
            [times[..., None], lats[..., None], lons[..., None], values],
            axis=-1).astype(np.float32)

        meta = ShardMeta(
            sid_hi=np.arange(d, dtype=np.int32),
            sid_lo=np.full(d, self.seq, np.int32),
            lat0=lats.min(1).astype(np.float32), lat1=lats.max(1).astype(np.float32),
            lon0=lons.min(1).astype(np.float32), lon1=lons.max(1).astype(np.float32),
            t0=times.min(1).astype(np.float32), t1=times.max(1).astype(np.float32),
        )
        self.t += r * self.sample_period
        self.seq += 1
        return payload, meta

    def next_rounds(self, n: int):
        """Stack ``n`` collection rounds for the fused ingest driver
        (``distributed.federation.ingest_rounds``): returns
        (payloads (N, D, R, 3+V) float32, ShardMeta with (N, D) fields)."""
        rounds = [self.next_shards() for _ in range(n)]
        payloads = np.stack([p for p, _ in rounds])
        meta = ShardMeta(*(np.stack([np.asarray(getattr(m, f)) for _, m in rounds])
                           for f in ShardMeta._fields))
        return payloads, meta


def latest_edge_round(payload, sid_hi, cached_t, max_drones: int,
                      seed: int = 0):
    """A copy of one round (``payload`` (B, R, 3+V), ``sid_hi`` (B,), B >= 10)
    reworked, on ten shards drawn from ``seed``, into every edge case of the
    latest-per-drone cache of ``max_drones`` rows, whose t before this round
    is ``cached_t`` (D,) (NaN where a row is empty):

    * two shards of one drone with the same t column (their max t ties;
      the later shard wins), the first also tied within itself;
    * a shard whose max t equals its drone's cached t (the new record wins),
      its newest record with NaN channels, and one whose t are all below
      the cached t (no change);
    * a shard whose newest t is +inf (excluded: the next record wins), one
      of all-NaN t, and one ending in NaN, -inf;
    * shards with drone ids -1, ``max_drones`` and ``max_drones + 7``
      (excluded).

    The cached-t cases take drones with a finite ``cached_t``. Returns
    ``(payload, sid_hi)``, new arrays (float32, int32).
    """
    rng = np.random.default_rng(seed)
    p = np.array(payload, np.float32)
    ids = np.array(sid_hi, np.int32)
    cached_t = np.asarray(cached_t, np.float32)
    r = p.shape[1]
    seen = np.isfinite(cached_t[np.clip(ids, 0, len(cached_t) - 1)]) \
        & (ids >= 0) & (ids < len(cached_t))
    tie, stale = rng.choice(np.nonzero(seen)[0], 2, replace=False)
    rest = rng.permutation(np.setdiff1d(np.arange(p.shape[0]), [tie, stale]))
    a, c, inf_s, nan_s, ninf_s, neg, big, bigger = rest[:8]
    ids[c] = ids[a]
    p[a, r - 2, 0] = p[a, r - 1, 0]
    p[c, :, 0] = p[a, :, 0]
    steps = np.arange(r, dtype=np.float32)[::-1]
    p[tie, :, 0] = cached_t[ids[tie]] - steps
    p[tie, r - 1, 3::2] = np.nan
    p[stale, :, 0] = cached_t[ids[stale]] - 100.0 - steps
    p[inf_s, r - 1, 0] = np.inf
    p[nan_s, :, 0] = np.nan
    p[ninf_s, r - 2:, 0] = (-np.inf, np.nan)
    ids[[neg, big, bigger]] = (-1, max_drones, max_drones + 7)
    return p, ids


def make_query_workload(rng, n_queries: int, city: CityConfig, t_max: float,
                        spatial_km: float, temporal_s: float):
    """Paper §4.5.1 query workloads: random bbox of given size x time range.

    spatial_km in {0.2, 1, 5}; temporal_s in {300, 1800, 7200}.
    """
    deg = spatial_km / 111.0
    lat0 = rng.uniform(city.lat_min, city.lat_max - deg, n_queries).astype(np.float32)
    lon0 = rng.uniform(city.lon_min, city.lon_max - deg, n_queries).astype(np.float32)
    t0 = rng.uniform(0, max(t_max - temporal_s, 1.0), n_queries).astype(np.float32)
    return dict(
        lat0=lat0, lat1=(lat0 + deg).astype(np.float32),
        lon0=lon0, lon1=(lon0 + deg).astype(np.float32),
        t0=t0, t1=(t0 + temporal_s).astype(np.float32),
    )
