"""``AerialDB``: the single-device session facade of the port.

Port of the single-device subset of ``repro.api.session``: one object owns
the ``StoreConfig``, the ``StoreState`` (on one device), the edge ``alive``
mask, the planner's PRNG key (on the host, split once a query as the
reference splits it) and the host-side step counter that paces index
retention.

    db = AerialDB.open(cfg)                       # on the card
    db.ingest_rounds(payloads, metas)             # N rounds, no host sync
    res, info = db.query(Query().bbox(...).time(...).agg("mean", channel=2))
    db.latest()                                   # newest record per drone

Failure and recovery, repair, partitions and meshes are later slices
(ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.api.query import Query
from repro_torch.core import threefry
from repro_torch.core.datastore import (AggSpec, LatestResult, QueryInfo,
                                        QueryResult, StoreConfig, StoreState,
                                        check_batch_fits, init_store,
                                        insert_local, pred_to, run_query)
from repro_torch.core.index import QueryPred
from repro_torch.core.placement import ShardMeta
from repro_torch.device import resolve_device

__all__ = ["AerialDB"]

Queryish = Union[Query, QueryPred, Tuple[QueryPred, AggSpec]]


def _to_device(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=dev, dtype=dtype)


def _meta_to(meta: ShardMeta, dev: torch.device) -> ShardMeta:
    dts = (torch.int32, torch.int32) + (torch.float32,) * 6
    return ShardMeta(*(_to_device(f, dev, dt) for f, dt in zip(meta, dts)))


class AerialDB:
    """An open single-device AerialDB deployment."""

    def __init__(self, cfg: StoreConfig, state: StoreState, alive=None,
                 key: Optional[threefry.Key] = None, device="cuda",
                 seed: int = 0):
        """Wrap existing parts (tests adopt a converted state this way); most
        callers want :meth:`open`. ``state`` must already be on ``device``.
        ``key`` is the planner's PRNG key (``threefry.key(seed)`` when
        None); the session owns it and splits it once a query."""
        self._device = resolve_device(device)
        if state.tup_f.device.type != self._device.type:
            raise ValueError(f"state lives on {state.tup_f.device}, the "
                             f"session on {self._device}")
        self._cfg = cfg
        self._state = state
        self._key = threefry.key(seed) if key is None else key
        alive = np.ones(cfg.n_edges, bool) if alive is None else alive
        self._alive = _to_device(alive, self._device, torch.bool)
        # Host mirror of state.steps (one read at adoption, never again): the
        # retention cadence branches on it without a device sync.
        self._steps = int(state.steps)

    @classmethod
    def open(cls, cfg: Optional[StoreConfig] = None, *, device="cuda",
             seed: int = 0, **cfg_overrides) -> "AerialDB":
        """Open a fresh deployment on ``device`` (default the card; raises
        without CUDA unless ``device="cpu"``). ``cfg=None`` builds
        ``StoreConfig(**overrides)``; with a config, overrides are applied
        with ``dataclasses.replace``. ``seed`` makes the planner's key, as
        ``jax.random.key(seed)`` does."""
        if cfg is None:
            cfg = StoreConfig(**cfg_overrides)
        elif cfg_overrides:
            cfg = dataclasses.replace(cfg, **cfg_overrides)
        dev = resolve_device(device)
        return cls(cfg, init_store(cfg, dev), key=threefry.key(seed),
                   device=dev)

    # -- owned pieces (read-only views) -------------------------------------

    @property
    def cfg(self) -> StoreConfig:
        return self._cfg

    @property
    def state(self) -> StoreState:
        return self._state

    @property
    def alive(self) -> torch.Tensor:
        return self._alive

    @property
    def device(self) -> torch.device:
        return self._device

    # -- ingest -------------------------------------------------------------

    def insert(self, payload, meta: ShardMeta) -> dict:
        """Insert one batch of B shards (R tuples each); returns the info
        dict (replicas, per-edge intake/index telemetry)."""
        check_batch_fits(self._cfg, tuple(np.shape(payload)))
        payload = _to_device(payload, self._device, torch.float32)
        self._state, info = insert_local(
            self._cfg, self._state, payload, _meta_to(meta, self._device),
            self._alive, self._steps)
        self._steps += 1
        return info

    def ingest_rounds(self, payloads, metas: ShardMeta) -> dict:
        """Multi-round ingest: ``payloads`` (N, B, R, 3+V), ``metas`` with
        (N, B) fields, moved to the device in one copy each, then inserted
        round by round with no host sync. Returns the info dict stacked over
        rounds."""
        check_batch_fits(self._cfg, tuple(np.shape(payloads))[1:])
        payloads = _to_device(payloads, self._device, torch.float32)
        metas = _meta_to(metas, self._device)
        infos = []
        for i in range(payloads.shape[0]):
            self._state, info = insert_local(
                self._cfg, self._state, payloads[i],
                ShardMeta(*(f[i] for f in metas)), self._alive, self._steps)
            self._steps += 1
            infos.append(info)
        if not infos:
            return {}
        return {k: torch.stack([inf[k] for inf in infos]) for k in infos[0]}

    # -- query --------------------------------------------------------------

    def _compile(self, q: Queryish,
                 agg: Optional[AggSpec]) -> Tuple[QueryPred, AggSpec]:
        if isinstance(q, Query):
            if agg is not None:
                raise ValueError(
                    "pass the AggSpec on the builder (.agg(...)) OR as the "
                    "agg= override for a raw QueryPred, not both.")
            return q.build(self._device)
        if isinstance(q, QueryPred):
            return q, agg if agg is not None else AggSpec()
        if isinstance(q, tuple) and len(q) == 2 \
                and isinstance(q[0], QueryPred) and isinstance(q[1], AggSpec):
            if agg is not None:
                raise ValueError("q already carries an AggSpec; drop agg=.")
            return q
        raise TypeError(
            f"cannot query with {type(q).__name__}: pass a Query builder, a "
            "QueryPred (e.g. make_pred(...) or Query.batch(...)), or a "
            "(QueryPred, AggSpec) pair.")

    def query(self, q: Queryish, *, agg: Optional[AggSpec] = None,
              key: Optional[threefry.Key] = None
              ) -> Union[Tuple[QueryResult, QueryInfo], LatestResult]:
        """Run a query batch: a ``Query`` builder, a batched ``QueryPred``
        (``Query.batch`` / ``make_pred``) or a ``(QueryPred, AggSpec)`` pair.
        Every channel of the spec is aggregated in one scan of the log.
        ``key`` is an explicit planner key; None takes a fresh split of the
        session's key (every query consumes one, whatever the planner, so
        the sequence of keys is the reference's). Returns
        ``(QueryResult, QueryInfo)``. A ``Query().latest()`` builder
        short-circuits to :meth:`latest` and returns its ``LatestResult``:
        no scan, no planner, and no split of the session's key."""
        if isinstance(q, Query) and q.want_latest:
            if agg is not None:
                raise ValueError(
                    "latest() queries take no AggSpec: the hot-cache read "
                    "returns raw (D, 3+V) records, not aggregates.")
            return self.latest()
        pred, spec = self._compile(q, agg)
        spec.validate_for(self._cfg)         # a refused query takes no key
        if key is None:
            self._key, key = threefry.split(self._key)
        return run_query(self._cfg, self._state, pred_to(pred, self._device),
                         self._alive, spec, key)

    def latest(self) -> LatestResult:
        """Latest-per-drone hot-cache read (paper §4.4 near-real-time path):
        the newest (max-t) record, the ingest step that wrote it and its
        validity per drone id, straight from the cache state (no scan, no
        index, no planner, nothing read back to the host). Exact up to the
        last completed insert."""
        if self._cfg.max_drones == 0:
            raise ValueError(
                "the latest-per-drone cache is disabled: open the session "
                "with StoreConfig.max_drones >= the fleet's highest drone id "
                "+ 1 to track an O(drones) hot cache (drone id = sid_hi).")
        seen = self._state.latest_seen
        return LatestResult(record=self._state.latest_f, last_seen=seen,
                            valid=seen >= 0)
