"""AerialDB-backed training data pipeline (port of
``repro.data.pipeline``): the store as the LM scaffold's data plane.

A synthetic drone fleet streams its shards into the port's ``AerialDB``
(content-hash placement, 3x replication). Each training step issues one
batch of spatio-temporal window queries against the store; every window's
aggregates (count, sum) seed the token stream of one sequence. A batch is
therefore a pure function of (seed, step), and a restarted trainer replays
the same stream from its checkpointed step.

The port runs the store and its queries on ``device`` (the card by
default, so the ingest and every batch launch the datastore's kernels);
the query key of step s is ``threefry.key(s)``, the reference's
``jax.random.key(s)``. The tokenizer is the reference's numpy code, the
float32 ``stats[i, 1] * 100`` included. ``get_batch`` returns int32
tensors on ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api import AerialDB, StoreConfig, make_pred
from repro_torch.core import threefry
from repro_torch.data.synthetic import CityConfig, DroneFleet, make_sites
from repro_torch.device import resolve_device


@dataclasses.dataclass
class PipelineConfig:
    vocab: int = 512
    batch: int = 4
    seq: int = 64
    n_drones: int = 16
    n_edges: int = 8
    rounds: int = 6               # fleet collection rounds to ingest
    records_per_shard: int = 30
    seed: int = 0


class AerialPipeline:
    """Ingest a synthetic fleet into AerialDB, then serve token batches."""

    def __init__(self, cfg: PipelineConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        sites = make_sites(cfg.n_edges, CityConfig(), seed=cfg.seed + 3)
        self.store_cfg = StoreConfig(
            n_edges=cfg.n_edges, sites=tuple(map(tuple, sites.tolist())),
            tuple_capacity=1 << 14, index_capacity=2048,
            max_shards_per_query=64, records_per_shard=cfg.records_per_shard)
        self.db = AerialDB.open(self.store_cfg, device=self.device,
                                seed=cfg.seed)
        fleet = DroneFleet(cfg.n_drones, records_per_shard=cfg.records_per_shard,
                           seed=cfg.seed + 1)
        self.t_max = 0.0
        for _ in range(cfg.rounds):
            payload, meta = fleet.next_shards()
            self.db.insert(payload, meta)
            self.t_max = float(payload[..., 0].max())

    def _window_stats(self, step: int, q: int):
        """Query q spatio-temporal windows; returns the QueryResult whose
        per-window aggregates seed the tokenizer."""
        rng = np.random.default_rng((self.cfg.seed, step))
        city = CityConfig()
        span = 0.05
        lat0 = rng.uniform(city.lat_min, city.lat_max - span, q).astype(np.float32)
        lon0 = rng.uniform(city.lon_min, city.lon_max - span, q).astype(np.float32)
        t0 = rng.uniform(0, max(self.t_max - 300.0, 1.0), q).astype(np.float32)
        pred = make_pred(q=q, lat0=lat0, lat1=lat0 + span, lon0=lon0,
                         lon1=lon0 + span, t0=t0, t1=t0 + 600.0,
                         has_spatial=True, has_temporal=True, is_and=True,
                         device=self.device)
        result, _ = self.db.query(pred, key=threefry.key(step))
        return result

    def get_batch(self, step: int):
        """Deterministic token batch derived from store queries at ``step``."""
        cfg = self.cfg
        result = self._window_stats(step, cfg.batch)
        stats = np.stack([result.count.cpu().numpy().astype(np.float32),
                          result.vsum.cpu().numpy().astype(np.float32)], axis=1)
        toks = tokenize(stats, cfg.seed, step, cfg.vocab, cfg.seq)
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(self.device),
                "labels": torch.from_numpy(toks[:, 1:].copy()).to(self.device)}


def tokenize(stats: np.ndarray, seed: int, step: int, vocab: int,
             seq: int) -> np.ndarray:
    """(batch, seq + 1) int32 tokens from per-window (count, sum) float32
    stats: each window's aggregates fold into its sequence's PRNG stream,
    so the observations change the data (the reference's loop)."""
    toks = np.empty((stats.shape[0], seq + 1), np.int32)
    for i in range(stats.shape[0]):
        h = np.int64(abs(int(stats[i, 0]) * 2654435761 + int(stats[i, 1] * 100)))
        rng = np.random.default_rng((seed, step, int(h) & 0x7FFFFFFF))
        toks[i] = rng.integers(0, vocab, seq + 1)
    return toks
