"""``AerialDB``: the session facade of the port, on one device or on a
datastore mesh (the 1-D edge mesh or the 2-D fleet mesh, in one process or
one process a fleet).

Port of ``repro.api.session``: one object owns the ``StoreConfig``, the
``StoreState`` (on one device, or split into the blocks of a mesh),
the edge ``alive`` mask, the planner's PRNG key (on the host, split once a
query as the reference splits it), the host-side step counter that paces
index retention and the failure ledger, and dispatches every operation to
the single-device bodies (``core.datastore``) or the federated runtime
(``distributed.federation``), depending on whether the session was opened
on a mesh. The two paths are held bitwise equal
(``tests/test_torch_federation.py``), so the dispatch is a deployment
choice.

    db = AerialDB.open(cfg)                       # on the card
    db = AerialDB.open(cfg, make_edge_mesh(4))    # 4 edge blocks on the card
    db = AerialDB.open(cfg, make_fleet_mesh(2, 2))  # 2 fleets of 2 blocks
    db.ingest_rounds(payloads, metas)             # N rounds, no host sync
    res, info = db.query(Query().bbox(...).time(...).agg("mean", channel=2))
    db.latest()                                   # newest record per drone
    db.fail_edges(1, 5); ...; db.recover_edges(1, 5)
    db.fail_device(0); ...; db.recover_device(0)  # a whole failure domain
    db.partition([[0, 1], [2, 3]]); ...; db.heal()  # a network partition

Failure-domain resilience (paper §4.5.3), as the reference: ``fail_*``
opens an outage-epoch record ``(dead edges, fail step)`` on a host-side
ledger, ``recover_*`` closes its window at the current step and by default
runs the incremental anti-entropy repair (``core.repair``) over the shards
the recorded outages could have touched; ``repair(full=True)`` sweeps every
shard. Ingest-time index drops are watched without a read (the per-insert
drop counts stay on the device until the ledger, a repair or a backlog of
64 inserts drains them) and ride the ledger's pending set. On a mesh the
failure domains default to its blocks, and a repair runs on the gathered
store and writes the result back into the blocks.

Fleet partitions, as the reference: :meth:`partition` cuts edges off as
unreachable but intact (a ledger state distinct from dead) and
:meth:`heal` closes the split's window on the same outage ledger. Every
placement, query and repair sees ``effective_alive = alive & reachable``;
the unreachable side's state is never written, reclaimed or backfilled
while the split is open.

The alive and reachable masks are host facts: the session keeps both in
numpy and makes fresh device tensors of them (and of their conjunction) at
every flip, from pinned memory on the card, and takes the step from its
host mirror, so a fail, recover, partition or heal without repair reads
nothing from the device and adds no launch to an insert. Repair,
``ledger()`` and the drop watch's drain are the sync points.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.api.query import Query
from repro_torch.core import repair as _repair
from repro_torch.core import threefry
from repro_torch.core.datastore import (AggSpec, LatestResult, QueryInfo,
                                        QueryResult, StoreConfig, StoreState,
                                        check_batch_fits, init_store,
                                        insert_local, pred_to, run_query)
from repro_torch.core.index import QueryPred
from repro_torch.core.placement import ShardMeta
from repro_torch.device import resolve_device
from repro_torch.distributed import federation as _fed
from repro_torch.distributed.sharding import (device_edge_block, gather_store,
                                              mesh_edge_devices, shard_store)
from repro_torch.launch.mesh import world_size

__all__ = ["AerialDB"]

Queryish = Union[Query, QueryPred, Tuple[QueryPred, AggSpec]]


def _to_device(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=dev, dtype=dtype)


def _meta_to(meta: ShardMeta, dev: torch.device) -> ShardMeta:
    dts = (torch.int32, torch.int32) + (torch.float32,) * 6
    return ShardMeta(*(_to_device(f, dev, dt) for f, dt in zip(meta, dts)))


def _mask_to(mask: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A fresh (E,) bool tensor on ``dev`` holding a copy of the host mask;
    on the card the copy leaves pinned memory without blocking, so a flip
    never waits on the device."""
    t = torch.from_numpy(np.array(mask, bool))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _sids(x):
    """An insert's sid words, kept for the drop watch without a read: a
    tensor as a copy on its own device (no sync; a caller may refill its
    buffer before the watch drains), anything else as a host copy."""
    return x.detach().clone() if isinstance(x, torch.Tensor) else np.array(x)


def _session_device(mesh, device) -> torch.device:
    """The session's device: ``device`` (default the card) without a mesh;
    on a mesh, its first block's, which a ``device`` also given must
    name."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    dev = mesh.devices[0]
    if device is not None:
        want = resolve_device(device)
        if want.type != dev.type or (want.index is not None
                                     and dev.index is not None
                                     and want.index != dev.index):
            raise ValueError(
                f"device={str(device)!r} disagrees with the mesh, whose "
                f"first block is on {dev}: pass the mesh alone, or a device "
                "it uses.")
    return dev


class AerialDB:
    """An open AerialDB deployment, on one device or on a datastore mesh."""

    def __init__(self, cfg: StoreConfig, state: StoreState, alive=None,
                 key: Optional[threefry.Key] = None, device=None,
                 seed: int = 0, mesh=None):
        """Wrap existing parts (tests adopt a converted state this way); most
        callers want :meth:`open`. ``key`` is the planner's PRNG key
        (``threefry.key(seed)`` when None); the session owns it and splits
        it once a query.

        Without a mesh, ``state`` must already be on ``device`` (default
        the card). On a mesh (``launch.mesh.EdgeMesh``), ``state`` is
        either a logical store, which is split into the mesh's blocks (a
        copy, ``distributed.sharding.shard_store``; in a multi-process world
        this process's blocks only), or the blocks themselves, which are
        adopted; the session's device is the first
        block's, and a ``device`` also given must agree."""
        self._device = _session_device(mesh, device)
        if mesh is None:
            blocks, devices = (state,), (self._device,)
        else:
            _fed.check_edge_mesh(cfg, mesh)
            if isinstance(state, StoreState):
                state = shard_store(state, mesh)
            state = blocks = tuple(state)
            devices = mesh.devices
            if len(blocks) != len(devices):
                raise ValueError(f"{len(blocks)} block states for a mesh of "
                                 f"{len(devices)} blocks in this process")
        for blk, dev in zip(blocks, devices):
            if blk.tup_f.device.type != dev.type:
                raise ValueError(f"state lives on {blk.tup_f.device}, the "
                                 f"session on {dev}")
        self._cfg = cfg
        self._mesh = mesh
        self._state = state
        self._key = threefry.key(seed) if key is None else key
        # The alive mask lives on the host (one read of an adopted tensor);
        # its device tensor is made anew at every flip.
        self._alive_np = (np.ones(cfg.n_edges, bool) if alive is None
                          else _repair.host_copy(alive).astype(bool))
        # Fleet partition: ``_reachable_np`` marks the edges the session can
        # still talk to; ``_partition`` holds the open split's unreachable
        # set and opening step (at most one open), closed onto the outage
        # ledger by :meth:`heal`.
        self._reachable_np = np.ones(cfg.n_edges, bool)
        self._partition: Optional[dict] = None
        self._masks_to_device()
        # Host mirror of state.steps (one read at adoption, never again): the
        # retention cadence and the outage ledger read it without a sync.
        self._steps = int(blocks[0].steps)
        self._last_repair: Optional[dict] = None
        self._last_repair_seconds: Optional[dict] = None
        # Outage-epoch ledger (see ``core.repair``): open records are
        # in-flight outages ``[dead edge set, fail_step]``; closed records
        # ``(recovered edge set, fail_step, recover_step)`` accumulate until
        # a repair consumes them. ``_pending_sids`` holds shards swept by a
        # repair that ran while other edges were still dead: they must be
        # re-swept until a repair completes with every edge alive.
        self._open_outages: list = []
        self._closed_outages: list = []
        self._pending_sids: set = set()
        # Ingest-time index drop watch: each insert's (sids, per-edge
        # index_entries_dropped device tensor) is kept unread; the drain
        # (repair, ledger, or a backlog past _DROP_WATCH_MAX) reads them and
        # folds the sids of every round that dropped into ``_dropped_sids``.
        self._drop_watch: list = []
        self._dropped_sids: set = set()
        dead = np.nonzero(~self._alive_np)[0]
        if dead.size:
            # Adopted state with unknown outage history: a fail_step of -1
            # covers every index entry, so the first repair after recovery
            # degenerates to (a correct) full-coverage sweep.
            self._open_outages.append([set(dead.tolist()), -1])

    @classmethod
    def open(cls, cfg: Optional[StoreConfig] = None, mesh=None, *,
             device=None, seed: int = 0, **cfg_overrides) -> "AerialDB":
        """Open a fresh deployment.

        Args:
          cfg:    deployment config; None builds ``StoreConfig(**overrides)``;
                  with a config, overrides are applied with
                  ``dataclasses.replace``.
          mesh:   optional datastore mesh (``launch.mesh.make_edge_mesh``
                  or ``make_fleet_mesh``): the store is split into its
                  blocks, and every operation runs the federated runtime.
                  In a multi-process world the session holds its fleet's
                  blocks: :attr:`state` and :meth:`repair` raise there.
                  None runs on one device.
          device: without a mesh, the store's device (default the card;
                  raises without CUDA unless ``device="cpu"``); with one,
                  the mesh's devices are used and a ``device`` given must
                  agree with them.
          seed:   makes the planner's key, as ``jax.random.key(seed)``.
        """
        if cfg is None:
            cfg = StoreConfig(**cfg_overrides)
        elif cfg_overrides:
            cfg = dataclasses.replace(cfg, **cfg_overrides)
        dev = _session_device(mesh, device)
        return cls(cfg, init_store(cfg, dev), key=threefry.key(seed),
                   device=dev, mesh=mesh)

    # -- owned pieces (read-only views) -------------------------------------

    @property
    def cfg(self) -> StoreConfig:
        return self._cfg

    @property
    def state(self) -> StoreState:
        """The store. On a mesh, the logical ``(E, ...)`` store gathered
        from the blocks (``distributed.sharding.gather_store``): a copy on
        the first block's device, made anew at each read, that the session
        never writes; the session's own paths use :attr:`blocks`."""
        if self._mesh is None:
            return self._state
        if self._mesh.multi_process:
            raise ValueError(
                "AerialDB.state gathers every block of the mesh, but this "
                f"process holds fleet {self._mesh.fleet}'s blocks only: read "
                "AerialDB.blocks (this process's blocks, in block order) and "
                "mesh.blocks(n_edges) for their edge ranges.")
        return gather_store(self._state)

    @property
    def blocks(self) -> Tuple[StoreState, ...]:
        """The store's blocks, updated in place by the session: the mesh's,
        in block order, or the one store on one device."""
        return self._state if self._mesh is not None else (self._state,)

    @property
    def mesh(self):
        """The mesh the session runs on (None on one device)."""
        return self._mesh

    @property
    def alive(self) -> torch.Tensor:
        return self._alive

    @property
    def reachable(self) -> torch.Tensor:
        """(E,) bool — edges not cut off by an open :meth:`partition`.
        Orthogonal to :attr:`alive`: an edge can be dead, unreachable, or
        both; only ``alive & reachable`` edges serve."""
        return self._reachable

    @property
    def effective_alive(self) -> torch.Tensor:
        """(E,) bool — the mask every placement, query and repair decision
        sees: ``alive & reachable``, made on the host at each flip (the
        alive tensor itself while no partition is open)."""
        return self._effective

    @property
    def device(self) -> torch.device:
        return self._device

    # -- ingest -------------------------------------------------------------

    # Drop-watch backlog bound: past this many unread insert telemetry
    # records, the next ingest drains them (their compute long finished, so
    # the read does not stall the queue).
    _DROP_WATCH_MAX = 64

    def _watch_drops(self, sid_hi, sid_lo, dropped: torch.Tensor) -> None:
        """Record one ingest's (sids (N, B), device drop counts (N, E))
        unread, for the lazy drain."""
        self._drop_watch.append((sid_hi, sid_lo, dropped))
        if len(self._drop_watch) > self._DROP_WATCH_MAX:
            self._drain_drop_watch()

    def _drain_drop_watch(self) -> None:
        """Read the watched drop counters (one device read for the whole
        backlog) and fold the sids of every round that dropped index entries
        into ``_dropped_sids``. Sweeping a batch-mate whose entry landed is
        a canonical-placement no-op, so a superset is fine."""
        if not self._drop_watch:
            return
        counts = torch.cat([d for _, _, d in self._drop_watch]).cpu().numpy()
        row = 0
        for hi, lo, dropped in self._drop_watch:
            d = counts[row:row + dropped.shape[0]]
            row += dropped.shape[0]
            hit = np.nonzero(d.sum(axis=1) > 0)[0]
            if hit.size:
                hi, lo = _repair.host_copy(hi), _repair.host_copy(lo)
                for rnd in hit:
                    self._dropped_sids.update(
                        _repair.sid_key(int(h), int(l))
                        for h, l in zip(hi[rnd], lo[rnd]))
        self._drop_watch = []

    def insert(self, payload, meta: ShardMeta) -> dict:
        """Insert one batch of B shards (R tuples each); returns the info
        dict (replicas, per-edge intake/index telemetry)."""
        check_batch_fits(self._cfg, tuple(np.shape(payload)))
        payload = _to_device(payload, self._device, torch.float32)
        dmeta = _meta_to(meta, self._device)
        if self._mesh is None:
            self._state, info = insert_local(
                self._cfg, self._state, payload, dmeta, self.effective_alive,
                self._steps)
        else:
            self._state, info = _fed.federated_insert_step(
                self._cfg, self._state, payload, dmeta, self.effective_alive,
                self._mesh, self._steps)
        self._steps += 1
        self._watch_drops(_sids(meta.sid_hi)[None], _sids(meta.sid_lo)[None],
                          info["index_entries_dropped"][None])
        return info

    def ingest_rounds(self, payloads, metas: ShardMeta) -> dict:
        """Multi-round ingest: ``payloads`` (N, B, R, 3+V), ``metas`` with
        (N, B) fields, moved to the device in one copy each, then inserted
        round by round with no host sync. Returns the info dict stacked over
        rounds."""
        check_batch_fits(self._cfg, tuple(np.shape(payloads))[1:])
        sid_hi, sid_lo = _sids(metas.sid_hi), _sids(metas.sid_lo)
        payloads = _to_device(payloads, self._device, torch.float32)
        self._state, out = _fed.ingest_rounds(
            self._cfg, self._state, payloads, _meta_to(metas, self._device),
            self.effective_alive, self._mesh, host_step=self._steps)
        self._steps += payloads.shape[0]
        if out:
            self._watch_drops(sid_hi, sid_lo, out["index_entries_dropped"])
        return out

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
        pred = pred_to(pred, self._device)
        if self._mesh is None:
            return run_query(self._cfg, self._state, pred,
                             self.effective_alive, spec, key)
        return _fed.federated_query_step(self._cfg, self._state, pred,
                                         self.effective_alive, key,
                                         self._mesh, spec)

    def latest(self) -> LatestResult:
        """Latest-per-drone hot-cache read (paper §4.4 near-real-time path):
        the newest (max-t) record, the ingest step that wrote it and its
        validity per drone id, straight from the cache state (no scan, no
        index, no planner, nothing read back to the host; on a mesh, the
        first block's copy of the replicated cache). Exact up to the last
        completed insert."""
        if self._cfg.max_drones == 0:
            raise ValueError(
                "the latest-per-drone cache is disabled: open the session "
                "with StoreConfig.max_drones >= the fleet's highest drone id "
                "+ 1 to track an O(drones) hot cache (drone id = sid_hi).")
        first = self.blocks[0]
        seen = first.latest_seen
        return LatestResult(record=first.latest_f, last_seen=seen,
                            valid=seen >= 0)

    # -- membership / failure domains ---------------------------------------

    def _edge_ids(self, edges) -> np.ndarray:
        """Normalise and validate edge ids on the host, before any device
        op sees them: an out-of-range index into a CUDA tensor is a
        device-side assert that poisons the context, so negatives, ids >=
        ``cfg.n_edges``, duplicates and an empty list all raise here."""
        ids = np.asarray(
            edges[0] if len(edges) == 1 and not isinstance(edges[0], int)
            else edges, np.int64).reshape(-1)
        if ids.size == 0:
            raise ValueError("no edge ids given: pass at least one edge id "
                             "(fail_edges(3) or fail_edges([3, 5])).")
        e = self._cfg.n_edges
        bad = ids[(ids < 0) | (ids >= e)]
        if bad.size:
            raise ValueError(
                f"edge id(s) {sorted(set(bad.tolist()))} out of range: this "
                f"deployment has n_edges={e} (valid ids 0..{e - 1}); an "
                "out-of-range index would be a device-side assert on the "
                "card.")
        if np.unique(ids).size != ids.size:
            dup = sorted({int(i) for i in ids
                          if (ids == i).sum() > 1})
            raise ValueError(
                f"duplicate edge id(s) {dup}: membership flips take each "
                "edge at most once.")
        return ids.astype(np.int32)

    def _device_edges(self, device: int) -> np.ndarray:
        """Resolve a failure-domain id to its contiguous edge block:
        ``cfg.n_failure_domains`` blocks when configured (> 1), else the
        session mesh's blocks (the layout contract)."""
        n = self._cfg.n_failure_domains
        if n == 1 and self._mesh is not None:
            n = mesh_edge_devices(self._mesh)
        if n == 1:
            raise ValueError(
                "no failure domains to address: open the session on an edge "
                "mesh or set StoreConfig.n_failure_domains > 1 (device-level "
                "failures flip one contiguous block of E / n_domains edges).")
        return np.asarray(device_edge_block(self._cfg.n_edges, n, device),
                          np.int32)

    def _masks_to_device(self) -> None:
        """Fresh device tensors of the host masks and of their conjunction
        (the alive tensor itself while every edge is reachable)."""
        dev = self._device
        self._alive = _mask_to(self._alive_np, dev)
        self._reachable = _mask_to(self._reachable_np, dev)
        self._effective = (
            self._alive if self._reachable_np.all()
            else _mask_to(self._alive_np & self._reachable_np, dev))

    def _set_alive(self, ids: np.ndarray, value: bool) -> None:
        self._alive_np[ids] = value
        self._masks_to_device()

    def fail_edges(self, *edges) -> "AerialDB":
        """Mark edges dead (paper §4.5.3): later inserts place around them
        and queries re-plan around them; ids are validated eagerly. Each
        call opens an outage-epoch record ``(newly dead edges, current
        step)``. Failing an already-dead edge changes nothing (it stays on
        the record its first failure opened); a call whose every id is dead
        is a no-op."""
        ids = self._edge_ids(edges)
        newly_dead = ids[self._alive_np[ids]]
        self._set_alive(ids, False)
        if newly_dead.size:
            self._open_outages.append(
                [set(int(i) for i in newly_dead), self._steps])
        return self

    def recover_edges(self, *edges, repair: bool = True) -> "AerialDB":
        """Bring failed edges back (their state was kept while dead).

        Closes the recovered edges' outage windows at the current step and,
        by default, runs the incremental :meth:`repair`, so shards ingested
        during the outage are re-placed onto the recovered edges and their
        entries and tuples backfilled. ``repair=False`` defers (the closed
        windows stay on the ledger). Recovering edges that are all alive
        leaves the session untouched: no window closes and no repair runs.
        """
        ids = self._edge_ids(edges)
        newly_alive = set(int(i) for i in ids[~self._alive_np[ids]])
        if not newly_alive:
            return self
        self._set_alive(ids, True)
        recover_step = self._steps
        for rec in self._open_outages:
            inter = rec[0] & newly_alive
            if inter:
                self._closed_outages.append(
                    (frozenset(inter), rec[1], recover_step))
                rec[0] -= inter
                newly_alive -= inter
        self._open_outages = [r for r in self._open_outages if r[0]]
        if newly_alive:
            # Dead edges with no ledger record: treat their history as
            # unknown.
            self._closed_outages.append(
                (frozenset(newly_alive), -1, recover_step))
        if repair:
            self.repair()
        return self

    def fail_device(self, device: int) -> "AerialDB":
        """Kill a whole failure domain (one contiguous edge block): the
        paper's edge-server loss. Placement spreads replicas across domains
        (``StoreConfig.n_failure_domains``), so one loss leaves every shard
        reachable."""
        return self.fail_edges(self._device_edges(device))

    def recover_device(self, device: int, repair: bool = True) -> "AerialDB":
        """Bring a failed domain's edge block back; runs the incremental
        :meth:`repair` by default (see :meth:`recover_edges`)."""
        return self.recover_edges(self._device_edges(device), repair=repair)

    # -- fleet partitions (unreachable but intact) ---------------------------

    def partition(self, edge_groups) -> "AerialDB":
        """Open a fleet network partition: split the edges into disjoint
        connectivity groups; the session stays with the FIRST group, and
        every edge of the other groups becomes unreachable but intact. Those
        edges leave placement, query planning and repair (through
        :attr:`effective_alive`), and their state is never written while
        the split is open: their data is invisible, not lost.

        ``edge_groups`` is a sequence of edge-id groups (a flat list of ids
        is one group). Edges named in no group join the coordinator's side;
        with one group given, its complement is cut off. Groups must be
        disjoint and the split must separate something. At most one
        partition is open at a time (:meth:`heal` first). Dead edges may sit
        in any group: death and reachability compose. Reads nothing from
        the device."""
        if self._partition is not None:
            raise ValueError(
                "a fleet partition is already open (unreachable edges "
                f"{sorted(self._partition['unreachable'])}): heal() it "
                "first — nested/overlapping partitions are not modeled.")
        groups = list(edge_groups)
        if groups and isinstance(groups[0], (int, np.integer)):
            groups = [groups]                   # flat id list = one group
        if not groups:
            raise ValueError("partition() needs at least one edge group.")
        ids = [self._edge_ids((g,)) if len(g) else np.empty(0, np.int32)
               for g in groups]           # empty group: names no edges
        flat = np.concatenate(ids)
        if np.unique(flat).size != flat.size:
            dup = sorted({int(i) for i in flat if (flat == i).sum() > 1})
            raise ValueError(
                f"edge id(s) {dup} appear in more than one partition group: "
                "connectivity groups must be disjoint.")
        if len(ids) == 1:
            unreachable = np.setdiff1d(
                np.arange(self._cfg.n_edges, dtype=np.int32), ids[0])
        else:
            unreachable = np.concatenate(ids[1:])
        if unreachable.size == 0:
            raise ValueError(
                "partition separates nothing: every edge ends up on the "
                "coordinator side. Name at least one edge in a non-first "
                "group (or pass a single group that excludes some edges).")
        if unreachable.size == self._cfg.n_edges:
            raise ValueError(
                "partition leaves the coordinator no reachable edges: the "
                "first group (the session's side) must keep at least one.")
        self._reachable_np[unreachable] = False
        self._masks_to_device()
        self._partition = {"unreachable": set(int(i) for i in unreachable),
                           "step": self._steps}
        return self

    def heal(self, *, repair: bool = True) -> "AerialDB":
        """Close the open partition: every edge is reachable again and the
        split's window ``(open step, current step]`` closes onto the outage
        ledger a recovery uses, so the default incremental :meth:`repair`
        sweeps the shards ingested while the fleet was split (plus those
        straddling still-dead edges). ``repair=False`` defers, like
        :meth:`recover_edges`. Healing a healed session is a no-op. Without
        the repair, reads nothing from the device."""
        if self._partition is None:
            return self
        rec = self._partition
        self._partition = None
        self._reachable_np[:] = True
        self._masks_to_device()
        self._closed_outages.append(
            (frozenset(rec["unreachable"]), rec["step"], self._steps))
        if repair:
            self.repair()
        return self

    def ledger(self) -> dict:
        """Snapshot of the failure ledger: open outage records, closed
        (unconsumed) windows, the open partition if any (its unreachable
        edges and opening step) and the pending and dropped sweep debts.
        Drains the drop watch, a device read."""
        self._drain_drop_watch()
        return {
            "open_outages": [(sorted(rec[0]), int(rec[1]))
                             for rec in self._open_outages],
            "closed_windows": [(sorted(eds), int(f), int(r))
                               for eds, f, r in self._closed_outages],
            "partition": (None if self._partition is None else
                          {"unreachable":
                           sorted(self._partition["unreachable"]),
                           "step": self._partition["step"]}),
            "pending_sids": len(self._pending_sids),
            "dropped_sids": len(self._dropped_sids),
        }

    def _outage_log(self) -> _repair.OutageLog:
        """The ledger as the ``OutageLog`` of an incremental sweep (sorted,
        so deterministic): the closed windows, the edges of the open
        outages (dead now) and of the open partition (unreachable now), and
        the pending and dropped sids."""
        self._drain_drop_watch()
        affected = set()
        for rec in self._open_outages:
            affected |= rec[0]
        if self._partition is not None:
            affected |= self._partition["unreachable"]
        return _repair.OutageLog(
            windows=tuple(sorted((int(f), int(r))
                                 for _eds, f, r in self._closed_outages)),
            affected_edges=tuple(sorted(affected)),
            pending_sids=tuple(sorted(self._pending_sids
                                      | self._dropped_sids)))

    def repair(self, *, full: bool = False) -> dict:
        """Anti-entropy sweep (``core.repair.repair_state``) under the
        effective mask (unreachable edges are treated as dead: never read,
        written or reclaimed), in place. Incremental by default — only the
        shards the ledger's outages could have touched, so an empty ledger
        is a telemetry-only no-op; ``full=True`` sweeps every tracked shard.
        A repair consumes the closed windows; shards swept while edges are
        still dead or unreachable stay pending. On a mesh the sweep runs on
        the gathered store and its result is written back into every block
        (replicated leaves included). Single-process only: the sweep gathers
        the whole store to one host, so a ``torch.distributed`` world of
        more than one process raises. Returns the telemetry dict (also
        :attr:`last_repair`; its host seconds are :attr:`last_repair_seconds`).
        """
        if world_size() > 1:
            raise NotImplementedError(
                "AerialDB.repair() is single-process only: it gathers the "
                "full store to the host, which under a multi-process world "
                f"(torch.distributed world size "
                f"{torch.distributed.get_world_size()}) would repair each "
                "process's slice independently and diverge the replicated "
                "state. Run repair from a single-process session, or defer "
                "with recover_edges(..., repair=False).")
        outage = None if full else self._outage_log()
        seconds: dict = {}
        if self._mesh is None:
            self._state, info = _repair.repair_state(
                self._cfg, self._state, self.effective_alive, outage=outage,
                timings=seconds)
        else:
            whole, info = _repair.repair_state(
                self._cfg, gather_store(self._state), self.effective_alive,
                outage=outage, timings=seconds)
            shard_store(whole, self._mesh, into=self._state)
        swept_keys = info.pop("_swept_keys")
        self._closed_outages = []
        if (self._alive_np & self._reachable_np).all():
            self._pending_sids = set()
        else:
            self._pending_sids |= set(swept_keys)
        # A sweep that re-attempted every watched sid without dropping again
        # settles the dropped-entry debt.
        self._drain_drop_watch()
        if info.get("entries_dropped", 0) == 0:
            self._dropped_sids = set()
        self._last_repair = info
        self._last_repair_seconds = seconds
        return info

    @property
    def last_repair(self) -> Optional[dict]:
        """Telemetry of the most recent :meth:`repair` (None before)."""
        return self._last_repair

    @property
    def last_repair_seconds(self) -> Optional[dict]:
        """The most recent repair's host seconds (``repair_state``'s
        ``timings``: ``d2h_s``, ``placement_s``, ``sweep_s``, ``h2d_s``,
        and ``swept``); None before."""
        return self._last_repair_seconds
