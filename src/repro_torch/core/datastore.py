"""AerialDB datastore: insert and decentralized query (§3).

Port of ``repro.core.datastore``: the shard-local insert and query bodies
over a block of the edge axis (``edge_ids``, the whole ``range(E)`` on one
device) with their two collective hooks (``EdgeCollectives``; the identity
bundle ``LOCAL_COLLECTIVES`` on one device, in-process gathers on an edge
mesh, ``distributed.federation``). Same state layout:

  tup_f:   (E, 3+V, CAP_L) float32   COLUMN-MAJOR tuple log (tuple axis last)
  tup_sid: (E, 2, CAP_L)   int32     owning shard id rows (hi, lo)
  tup_count: (E,)          int32     total tuples ever written (monotonic)
  tup_pos: (E,)            int32     ring write cursor in [0, capacity)
  tup_overwritten, tup_dropped: (E,) retention / loss telemetry
  steps: ()                int32     insert steps executed
  latest_f: (D, 3+V)       float32   latest-per-drone cache: max-t record
  latest_seen: (D,)        int32     insert step that last wrote each row
                                     (-1 never); D = max_drones, 0 = off
  index:   IndexState                sliced distributed index (index.py)

``CAP_L`` is ``tuple_capacity`` rounded up to a multiple of 128; ring slots
are taken modulo the LOGICAL capacity and the scan admits only
``slot < min(tup_count, tuple_capacity)``. Every ``retention_every``-th
insert derives per-edge watermarks and retires + compacts index entries.
Exactness under retention holds for windows retained on every replica.

Differences from the JAX package, none visible in results:

* State is updated IN PLACE (``insert_local`` writes the log and the index
  tensors it is given and returns them): the log is the bulk of device
  memory, and a functional copy per insert would double it. Keep a clone of
  a state you still need before inserting into it.
* The retention sweep branches on ``host_step``, a host-side mirror of
  ``state.steps`` that the caller advances by one per insert, so the ingest
  loop never reads a device scalar.
* Writes avoid scatter drop sentinels (torch has none, and masking rows out
  would sync): each edge's new tuples land on a window of consecutive ring
  slots, rewritten with their old contents where no tuple arrives.
* The latest-per-drone cache (``max_drones > 0``) is updated by
  ``_update_latest`` in place, with ``host_step + 1`` as the step, and
  excluded records (non-finite t, ids outside [0, D)) go to a spill row
  that is cut off: torch's scatter and gather have no drop or fill mode,
  and an out-of-range index is a device-side assert on the card.
* The ``random`` planner's key is one key on the host (a pair of ints,
  ``core.threefry``), which ``plan_random`` folds with each query index on
  the query's device; the two other planners draw nothing and fold nothing.
* The shard-local bodies (``insert_body``, ``plan_body``, ``query_body``)
  are generators that stop at their collective: the reference's blocks
  meet at a collective under ``shard_map``, while the port's run one after
  another in one process. ``lockstep`` runs every block's body up to its
  collective, performs the collective once over all their contributions
  and runs every body on; the single-device entry points (``insert_local``,
  ``plan_subqueries``, ``query_local``) run the same bodies through it as
  a list of one. A block is a contiguous ``range`` of global edge ids (the
  layout contract's blocks), so its slices of the global masks are views.
  ``query_body`` takes the reference's ``overlap_tiles``: the batch is cut
  into tiles, every tile's index match is yielded at the one collective
  (a tuple of candidate lists, merged tile by tile, ``merge_tiles``), and
  the tiles are then planned and scanned one after another; the fleet
  mesh runs two, everything else one.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, Generator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import hashing, planner as planner_lib, threefry
from repro_torch.core.index import (IndexState, MatchedShards, QueryPred,
                                    compact_index, init_index, insert_entries,
                                    lookup, retire_entries, selected_order)
from repro_torch.core.placement import ShardMeta, place_replicas
from repro_torch.core.slicing import (SliceConfig, spatial_slice_edges,
                                      temporal_slice_edges)
from repro_torch.data.synthetic import CityConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.st_scan import ops as st_ops


def _default_site_grid(n_edges: int) -> Tuple[Tuple[float, float], ...]:
    """Deterministic lat/lon grid over the synthetic-city bbox, slightly
    inset — used when ``sites`` is left empty."""
    city = CityConfig()
    pad_lat = 0.08 * (city.lat_max - city.lat_min)
    pad_lon = 0.08 * (city.lon_max - city.lon_min)
    rows = int(np.ceil(np.sqrt(n_edges)))
    cols = int(np.ceil(n_edges / rows))
    lat = np.linspace(city.lat_min + pad_lat, city.lat_max - pad_lat, rows)
    lon = np.linspace(city.lon_min + pad_lon, city.lon_max - pad_lon, cols)
    grid = [(float(la), float(lo)) for la in lat for lo in lon]
    return tuple(grid[:n_edges])


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """Static configuration of an AerialDB deployment."""
    n_edges: int = 20
    sites: Tuple[Tuple[float, float], ...] = ()   # (E, 2) edge locations
    tau: float = 300.0
    slice_cfg: SliceConfig = SliceConfig()
    tuple_capacity: int = 1 << 14                 # ring-buffer slots per edge
    index_capacity: int = 1 << 12                 # index entries per edge
    max_shards_per_query: int = 128               # S
    records_per_shard: int = 60                   # R (paper: 60 samples / 5 min)
    n_values: int = 4                             # sensor channels per tuple
    replication: int = 3                          # 1 => Feather-like baseline
    use_index: bool = True                        # False => broadcast baseline
    planner: str = "min_shards"
    or_group: int = 150                           # paper: sub-queries split at 150 sids
    retention_every: int = 4                      # insert steps between index sweeps
    n_failure_domains: int = 1                    # contiguous device blocks to spread
                                                  # each shard's replicas across
    max_drones: int = 0                           # latest-per-drone hot-cache rows
                                                  # (0 disables the cache)

    def __post_init__(self):
        if not (1 <= self.replication <= 3):
            raise ValueError(
                f"replication={self.replication} is unsupported: index entries "
                "carry exactly 3 replica slots (paper §3.4.2); pass "
                "1 <= replication <= 3.")
        if not self.use_index and self.replication != 1:
            raise ValueError(
                f"use_index=False with replication={self.replication} would "
                f"overcount results ~{self.replication}x: the broadcast "
                "baseline has no shard scoping, so every replica edge scans "
                "every tuple. Use replication=1 for the Feather-like "
                "baseline, or keep the index enabled.")
        if self.retention_every < 1:
            raise ValueError(
                f"retention_every={self.retention_every} must be >= 1 (index "
                "retention sweeps run every retention_every insert steps).")
        if self.max_drones < 0:
            raise ValueError(
                f"max_drones={self.max_drones} must be >= 0: it sizes the "
                "latest-per-drone hot cache (0 disables it; drone ids >= "
                "max_drones are not cached).")
        if self.n_failure_domains < 1 or self.n_edges % self.n_failure_domains:
            raise ValueError(
                f"n_failure_domains={self.n_failure_domains} must be >= 1 and "
                f"divide n_edges={self.n_edges}: failure domains are the "
                "contiguous device blocks of the sharded layout contract "
                "(one block of E / n_failure_domains edges each).")
        if not self.sites:
            object.__setattr__(self, "sites", _default_site_grid(self.n_edges))
        elif len(self.sites) != self.n_edges:
            raise ValueError(
                f"sites has {len(self.sites)} entries but n_edges="
                f"{self.n_edges}; pass one (lat, lon) per edge or leave "
                "sites=() for a deterministic default grid.")

    @property
    def tuple_width(self) -> int:
        return 3 + self.n_values

    @property
    def padded_capacity(self) -> int:
        """Stored size of the tuple axis: ``tuple_capacity`` rounded up to a
        multiple of 128. Slots >= ``tuple_capacity`` are never written."""
        return -(-self.tuple_capacity // 128) * 128

    def sites_array(self, device="cpu") -> torch.Tensor:
        """(E, 2) float32 site tensor on ``device``, made once per
        (config, device): the hot paths take it without a host copy."""
        return _sites_on(self, torch.device(device))


@lru_cache(maxsize=None)
def _sites_on(cfg: StoreConfig, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(
        np.asarray(cfg.sites, np.float32).reshape(cfg.n_edges, 2),
        device=device)


class StoreState(NamedTuple):
    index: IndexState
    tup_f: torch.Tensor
    tup_sid: torch.Tensor
    tup_count: torch.Tensor
    tup_pos: torch.Tensor
    tup_overwritten: torch.Tensor
    tup_dropped: torch.Tensor
    steps: torch.Tensor
    latest_f: torch.Tensor
    latest_seen: torch.Tensor


class LatestResult(NamedTuple):
    """``AerialDB.latest()`` / ``Query().latest()`` answer: the O(drones)
    hot-cache read (paper §4.4 near-real-time shape), bypassing the log
    scan, the index and the planner.

      record:    (D, 3+V) last (max-t) record per drone id; rows of drones
                 never seen are zeros. Channels a partial payload never
                 filled are NaN (the validity mask is ``isfinite``).
      last_seen: (D,) insert step that wrote each row (-1 = never seen).
      valid:     (D,) ``last_seen >= 0``.

    The cache never forgets: each row is the max-t record ever inserted for
    that drone, even after ring retention has aged the tuple out of the
    log, and is exact the moment the insert that carried it completes.
    """
    record: torch.Tensor
    last_seen: torch.Tensor
    valid: torch.Tensor


# The monotonic counter saturates here instead of wrapping int32 negative.
_COUNT_SAT = (1 << 31) - (1 << 26)

AGG_OPS = ("count", "sum", "min", "max", "mean")


@dataclasses.dataclass(frozen=True, init=False)
class AggSpec:
    """Static aggregation spec: which sensor channel(s) to aggregate (one
    scan serves them all) and which aggregates the caller asked for. A
    single-channel spec produces (Q,)-shaped aggregates, a multi-channel
    spec (Q, K)."""
    channels: Tuple[int, ...] = (0,)
    ops: Tuple[str, ...] = AGG_OPS

    def __init__(self, channel: Optional[int] = None,
                 ops: Tuple[str, ...] = AGG_OPS,
                 channels: Optional[Tuple[int, ...]] = None):
        if channel is not None and channels is not None:
            raise ValueError(
                "pass channel= (single) OR channels= (batched), not both.")
        if channels is None:
            channels = (0 if channel is None else channel,)
        if isinstance(channels, int):
            channels = (channels,)
        channels = tuple(int(c) for c in channels)
        ops = (ops,) if isinstance(ops, str) else tuple(ops)
        object.__setattr__(self, "channels", channels)
        object.__setattr__(self, "ops", ops)
        unknown = [op for op in self.ops if op not in AGG_OPS]
        if unknown:
            raise ValueError(
                f"unknown aggregate op(s) {unknown}: pick from {AGG_OPS}.")
        if not self.ops:
            raise ValueError("AggSpec.ops is empty: request at least one of "
                             f"{AGG_OPS}.")
        if not self.channels:
            raise ValueError("AggSpec.channels is empty: select at least one "
                             "sensor channel.")
        if len(set(self.channels)) != len(self.channels):
            raise ValueError(
                f"channels={self.channels} contains duplicates: each channel "
                "is aggregated once per scan; deduplicate the request.")
        for c in self.channels:
            if c < 0:
                raise ValueError(f"channel={c} must be >= 0.")

    @property
    def channel(self) -> int:
        return self.channels[0]

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    def validate_for(self, cfg: StoreConfig) -> "AggSpec":
        for c in self.channels:
            if c >= cfg.n_values:
                raise ValueError(
                    f"channel={c} out of range: this deployment stores "
                    f"n_values={cfg.n_values} sensor channels per tuple "
                    f"(valid channels 0..{cfg.n_values - 1}).")
        return self


class QueryResult(NamedTuple):
    """Fixed-shape query answer; value aggregates are NaN for queries that
    matched nothing."""
    count: torch.Tensor    # (Q,) int32
    vsum: torch.Tensor     # (Q[, K]) float32
    vmin: torch.Tensor     # (Q[, K]) float32 (NaN when count==0)
    vmax: torch.Tensor     # (Q[, K]) float32 (NaN when count==0)
    overflow: torch.Tensor  # (Q,) bool — matched shards exceeded the budget
    vmean: torch.Tensor = None
    completeness_bound: torch.Tensor = None
    replicas_lost: torch.Tensor = None

    def view(self, agg: AggSpec) -> dict:
        """The aggregates the spec asked for plus the degradation telemetry."""
        full = {"count": self.count, "sum": self.vsum, "min": self.vmin,
                "max": self.vmax, "mean": self.vmean}
        out = {op: full[op] for op in agg.ops}
        out["completeness_bound"] = self.completeness_bound
        out["replicas_lost"] = self.replicas_lost
        return out


class QueryInfo(NamedTuple):
    """Per-query telemetry (see ``repro.core.datastore.QueryInfo``)."""
    lookup_edges: torch.Tensor
    subquery_edges: torch.Tensor
    shards_matched: torch.Tensor
    max_shards_per_edge: torch.Tensor
    broadcast: torch.Tensor
    replicas_lost: torch.Tensor
    completeness_bound: torch.Tensor


def _host(x, q):
    """Host numpy view of a make_pred input broadcast to (q,), or None for a
    CUDA tensor (validating it would sync)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            return None
        x = x.numpy()
    try:
        return np.broadcast_to(np.asarray(x), (q,))
    except ValueError:
        return None


def _check_ranges(q, pairs, enabled, is_and):
    """Reject inverted ranges under an AND predicate (they would match
    nothing, silently). OR predicates are exempt."""
    en, am = _host(enabled, q), _host(is_and, q)
    if en is None or am is None:
        return
    en = en.astype(bool) & am.astype(bool)
    if not en.any():
        return
    for name, lo, hi in pairs:
        lo, hi = _host(lo, q), _host(hi, q)
        if lo is None or hi is None:
            continue
        bad = en & (lo > hi)
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                f"inverted {name} range for query {i}: "
                f"{name}0={float(lo[i])} > {name}1={float(hi[i])}. Inverted "
                "ranges match nothing under an AND predicate; swap the "
                "bounds (ranges are inclusive [lo, hi]).")


def make_pred(q: int = 1, lat0=0.0, lat1=0.0, lon0=0.0, lon1=0.0, t0=0.0,
              t1=0.0, sid_hi=-1, sid_lo=-1, has_spatial=False,
              has_temporal=False, has_sid=False, is_and=True,
              device="cuda") -> QueryPred:
    """Batched QueryPred on ``device``, broadcasting scalars to (q,).
    Inverted ranges under an AND predicate raise; the host inputs are
    checked before anything moves to the device."""
    dev = resolve_device(device)
    _check_ranges(q, [("lat", lat0, lat1), ("lon", lon0, lon1)],
                  has_spatial, is_and)
    _check_ranges(q, [("t", t0, t1)], has_temporal, is_and)

    def arr(x, dt):
        a = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x).to(device=dev, dtype=dt)
        return a.expand(q).clone() if a.dim() == 0 else a.contiguous()
    return QueryPred(
        lat0=arr(lat0, torch.float32), lat1=arr(lat1, torch.float32),
        lon0=arr(lon0, torch.float32), lon1=arr(lon1, torch.float32),
        t0=arr(t0, torch.float32), t1=arr(t1, torch.float32),
        sid_hi=arr(sid_hi, torch.int32), sid_lo=arr(sid_lo, torch.int32),
        has_spatial=arr(has_spatial, torch.bool),
        has_temporal=arr(has_temporal, torch.bool),
        has_sid=arr(has_sid, torch.bool), is_and=arr(is_and, torch.bool))


def pred_to(pred: QueryPred, device) -> QueryPred:
    """The predicate's fields on ``device`` (no copy where already there)."""
    return QueryPred(*(f.to(device) for f in pred))


def init_store(cfg: StoreConfig, device="cuda") -> StoreState:
    dev = resolve_device(device)
    e = cfg.n_edges

    def z(shape, dt, fill=0):
        return torch.full(shape, fill, dtype=dt, device=dev)
    return StoreState(
        index=init_index(e, cfg.index_capacity, dev),
        tup_f=z((e, cfg.tuple_width, cfg.padded_capacity), torch.float32),
        tup_sid=z((e, 2, cfg.padded_capacity), torch.int32, -1),
        tup_count=z((e,), torch.int32),
        tup_pos=z((e,), torch.int32),
        tup_overwritten=z((e,), torch.int32),
        tup_dropped=z((e,), torch.int32),
        steps=z((), torch.int32),
        latest_f=z((cfg.max_drones, cfg.tuple_width), torch.float32),
        latest_seen=z((cfg.max_drones,), torch.int32, -1),
    )


def clone_state(state: StoreState) -> StoreState:
    """A copy of every leaf, on the same device: what a caller keeps before
    an in-place update (insert, repair) when it still needs the old state."""
    return StoreState(index=IndexState(*(t.clone() for t in state.index)),
                      **{f: getattr(state, f).clone()
                         for f in StoreState._fields if f != "index"})


# ---------------------------------------------------------------------------
# Collective hooks and the lockstep driver of the shard-local bodies
# ---------------------------------------------------------------------------

class EdgeCollectives(NamedTuple):
    """The two metadata-scale exchanges of the shard-local bodies (as
    ``repro.core.datastore.EdgeCollectives``), each called once on the list
    of every block's contribution, in block order:

      gather_watermark: [(E_loc,) retention watermark per block] -> (E,)
          global watermark (entries name replica edges anywhere, so
          retirement needs every edge's);
      combine_matched:  ([MatchedShards over each block's edges],
          max_shards) -> the global MatchedShards every block plans against.

    ``LOCAL_COLLECTIVES`` is the identity on a list of one (one device);
    ``distributed.federation.make_collectives`` builds a mesh's. The query
    bodies reach ``combine_matched`` once a tile, through ``merge_tiles``.
    """
    gather_watermark: Callable
    combine_matched: Callable


def _only(parts: Sequence):
    if len(parts) != 1:
        raise ValueError(f"LOCAL_COLLECTIVES takes one block, got {len(parts)}: "
                         "a mesh's blocks need distributed.federation."
                         "make_collectives")
    return parts[0]


#: Identity hooks: the one-device special case (``edge_ids == range(E)``).
LOCAL_COLLECTIVES = EdgeCollectives(
    gather_watermark=_only,
    combine_matched=lambda parts, max_shards: _only(parts))


def lockstep(bodies: Sequence[Generator], collective: Callable) -> list:
    """Run shard-local bodies as the blocks of a mesh run under
    ``shard_map``: every body up to its collective (a body yields its
    contribution there), then ``collective`` once on the list of
    contributions in block order, then every body on with the result. A
    call in which no body reaches a collective (a non-sweep insert, the
    broadcast baseline) performs none; the blocks share the decision.
    Returns the bodies' return values in block order."""
    bodies = list(bodies)
    sent, done = [], []
    for body in bodies:
        try:
            sent.append(next(body))
        except StopIteration as stop:
            done.append(stop.value)
    if not sent:
        return done
    if done:
        raise RuntimeError("the blocks disagree on whether to exchange")
    merged = collective(sent)
    out = []
    for body in bodies:
        try:
            body.send(merged)
        except StopIteration as stop:
            out.append(stop.value)
        else:
            raise RuntimeError("a shard-local body yielded twice")
    return out


def _block(cfg: StoreConfig, edge_ids: Optional[range]) -> range:
    """The block's global edge ids: ``range(E)`` by default; a block is a
    contiguous run of the edge axis (the layout contract)."""
    if edge_ids is None:
        return range(cfg.n_edges)
    if not isinstance(edge_ids, range) or edge_ids.step != 1 or \
            not 0 <= edge_ids.start <= edge_ids.stop <= cfg.n_edges:
        raise ValueError(f"edge_ids={edge_ids!r} must be a contiguous range "
                         f"of edge ids within range({cfg.n_edges})")
    return edge_ids


# ---------------------------------------------------------------------------
# Insertion (paper §3.4, Fig 2)
# ---------------------------------------------------------------------------

def _index_edge_mask(cfg: StoreConfig, meta: ShardMeta, replicas: torch.Tensor,
                     sites: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """(B, E) — edges that must hold each shard's index entry: every spatial
    and temporal slice owner plus the replica edges (§3.4.3); ranges wider
    than the slice budget broadcast their entry."""
    e = cfg.n_edges
    sm, s_ovf = spatial_slice_edges(meta.lat0, meta.lat1, meta.lon0, meta.lon1,
                                    sites, cfg.slice_cfg)
    tm, t_ovf = temporal_slice_edges(meta.t0, meta.t1, e, cfg.slice_cfg)
    eye = torch.arange(e, dtype=torch.int32, device=sites.device)
    rep_mask = (replicas[..., None] == eye).any(dim=1)
    mask = (sm | tm | rep_mask) | (s_ovf | t_ovf)[:, None]
    return mask & alive[None, :]


def _update_latest(latest_f: torch.Tensor, latest_seen: torch.Tensor,
                   payload: torch.Tensor, sid_hi: torch.Tensor, steps: int):
    """Latest-per-drone hot-cache update (the §4.4 near-real-time path), IN
    PLACE: ``latest_f`` (D, W) and ``latest_seen`` (D,) int32 take this
    batch's newest record of each drone id ``sid_hi`` (B,) from ``payload``
    (B, R, W), and ``steps`` (the insert's step) where a row changes.

    As the reference, two commutative scatter-max passes, so duplicate ids
    need no winner order: (1) max t per drone, (2) max flat record index
    among the records reaching that t (a t tie goes to the batch's last
    record). A cached row is replaced when the batch's t >= its own (a tie
    goes to the new record). Records with non-finite t or an id outside
    [0, D) are excluded: they scatter into spill row D, which is cut off
    (the reference drops them with ``mode="drop"``).
    """
    d = latest_f.shape[0]
    b, r, w = payload.shape
    if b * r == 0:
        return latest_f, latest_seen
    dev = payload.device
    flat = payload.reshape(b * r, w)                                 # (N, W)
    did = sid_hi[:, None].expand(b, r).reshape(-1)                   # (N,)
    t = flat[:, 0]
    vmask = torch.isfinite(t) & (did >= 0) & (did < d)
    slot = torch.where(vmask, did, d).long()                         # (N,)
    t_clean = torch.where(vmask, t, float("-inf"))
    cand_t = torch.full((d + 1,), float("-inf"), device=dev).scatter_reduce_(
        0, slot, t_clean, "amax")                                    # (D+1,)
    hit = vmask & (t_clean == cand_t.gather(0, slot))
    idx = torch.where(hit, torch.arange(b * r, dtype=torch.int32, device=dev),
                      -1)
    best = torch.full((d + 1,), -1, dtype=torch.int32,
                      device=dev).scatter_reduce_(0, slot, idx, "amax")[:d]
    cur_t = torch.where(latest_seen >= 0, latest_f[:, 0], float("-inf"))
    newer = (best >= 0) & (cand_t[:d] >= cur_t)
    latest_f.copy_(torch.where(newer[:, None], flat[best.clamp(min=0).long()],
                               latest_f))
    latest_seen.masked_fill_(newer, steps)
    return latest_f, latest_seen


def insert_body(cfg: StoreConfig, state: StoreState, payload: torch.Tensor,
                meta: ShardMeta, alive: torch.Tensor, host_step: int,
                edge_ids: range):
    """Shard-local insert of B shards (R tuples each) into the block of edges
    ``edge_ids`` whose state is ``state``: placement, replication, indexing.
    A generator (see ``lockstep``): on a sweep step it yields the block's
    (E_loc,) retention watermark and takes the global (E,) one back.

    ``payload`` (B, R, 3+V) float32, ``meta`` ShardMeta of (B,) tensors and
    ``alive`` (E,) bool are global; ``host_step`` is the value of
    ``state.steps`` before this insert, mirrored on the host (the retention
    cadence branches on it, and every block shares it). Placement and the
    slice masks are computed from the global inputs on every block; the
    ring write and the index writes touch only the block's edges. Updates
    ``state`` IN PLACE and returns ``(state, info dict)`` with the per-edge
    info sliced like the block; nothing is read back to the host.
    """
    cap = cfg.tuple_capacity
    dev = state.tup_f.device
    lo, hi = edge_ids.start, edge_ids.stop
    e = hi - lo
    b, r, w = payload.shape
    sites = cfg.sites_array(dev)
    alive = alive.to(device=dev, dtype=torch.bool)
    ids = torch.arange(lo, hi, dtype=torch.int32, device=dev)

    replicas = place_replicas(meta, sites, alive, cfg.tau,
                              n_domains=cfg.n_failure_domains)
    replicas = replicas[:, : cfg.replication]

    # --- tuple dispatch: shard -> replica edges, appended at each ring cursor.
    dm = (replicas[..., None] == ids).any(dim=1) & alive[None, lo:hi]  # (B, E)
    n_sel = dm.sum(dim=0, dtype=torch.int32)
    n_in = n_sel * r                                                     # (E,)
    # Slot j of edge e's write window is tuple j % R of its (j // R)-th
    # selected shard; the window spans B*R <= cap distinct ring slots.
    j = torch.arange(b * r, dtype=torch.int32, device=dev)[None, :]       # (1, J)
    k = (j // r).long()
    src = torch.gather(selected_order(dm).T, 1, k.expand(e, -1))          # (E, J)
    ok = (k < n_sel[:, None])[..., None]                                  # (E, J, 1)
    slot = ((state.tup_pos[:, None] + j) % cap).long()                    # (E, J)
    ee = torch.arange(e, device=dev)[:, None].expand(-1, b * r)
    rec = (j % r).long().expand(e, -1)
    new_f = payload[src, rec]                                             # (E, J, W)
    sid = torch.stack([meta.sid_hi, meta.sid_lo], dim=-1).to(torch.int32)
    new_sid = sid[src]                                                    # (E, J, 2)
    # Column-major write: tuple j fills the whole field column of its slot.
    state.tup_f[ee, :, slot] = torch.where(ok, new_f, state.tup_f[ee, :, slot])
    state.tup_sid[ee, :, slot] = torch.where(ok, new_sid,
                                             state.tup_sid[ee, :, slot])

    valid_before = torch.clamp(state.tup_count, max=cap)
    state.tup_pos.copy_((state.tup_pos + n_in) % cap)
    state.tup_count.copy_(torch.clamp(state.tup_count + n_in, max=_COUNT_SAT))
    valid_after = torch.clamp(state.tup_count, max=cap)
    overwritten_now = valid_before + n_in - valid_after
    state.tup_overwritten.copy_(torch.clamp(
        state.tup_overwritten + overwritten_now, max=_COUNT_SAT))
    state.steps.add_(1)
    steps = host_step + 1

    # --- index retention (cadenced), before this batch's index writes. The
    # watermark exchange happens only on a sweep step, which every block
    # shares.
    dropped_before = state.index.dropped.clone()
    retired_before = state.index.retired.clone()
    if steps % cfg.retention_every == 0:
        slots = torch.arange(cfg.padded_capacity, dtype=torch.int32, device=dev)
        retained = slots[None, :] < valid_after[:, None]
        t_oldest = torch.where(retained, state.tup_f[:, 0, :],
                               float("inf")).amin(dim=1)
        lossy = (state.tup_count > cap) | (state.tup_overwritten > 0)
        watermark = yield torch.where(lossy, t_oldest, float("-inf"))
        watermark = watermark.to(dev)                              # (E,) global
        compact_index(retire_entries(state.index, watermark))
    else:
        watermark = torch.full((cfg.n_edges,), float("-inf"), device=dev)

    # --- sliced index entries (§3.4.3), the block's columns of the mask.
    idx_mask = _index_edge_mask(cfg, meta, replicas, sites, alive)[:, lo:hi]
    reps3 = torch.nn.functional.pad(replicas, (0, 3 - cfg.replication),
                                    value=-1)
    insert_entries(state.index, meta, reps3, idx_mask, step=steps)

    # --- latest-per-drone hot cache (skipped on the host when disabled):
    # replicated, so every block updates its own copy from the same batch.
    if cfg.max_drones:
        _update_latest(state.latest_f, state.latest_seen, payload,
                       meta.sid_hi, steps)

    info = {
        "replicas": replicas,
        "intake_per_edge": n_in,
        "index_writes_per_edge": idx_mask.sum(dim=0, dtype=torch.int32),
        "tuples_overwritten": overwritten_now,
        "tuples_dropped": torch.zeros_like(n_in),
        "index_entries_dropped": state.index.dropped - dropped_before,
        "index_entries_retired": state.index.retired - retired_before,
        "retention_watermark": watermark,
    }
    return state, info


def insert_local(cfg: StoreConfig, state: StoreState, payload: torch.Tensor,
                 meta: ShardMeta, alive: torch.Tensor, host_step: int,
                 edge_ids: Optional[range] = None,
                 collectives: EdgeCollectives = LOCAL_COLLECTIVES):
    """Insert B shards into one block (``insert_body``, run through
    ``lockstep`` as a list of one): the whole store on one device, where
    ``edge_ids`` is ``range(E)`` and the hooks are the identity. Updates
    ``state`` IN PLACE; returns ``(state, info dict)``."""
    return lockstep([insert_body(cfg, state, payload, meta, alive, host_step,
                                 _block(cfg, edge_ids))],
                    collectives.gather_watermark)[0]


def check_batch_fits(cfg: StoreConfig, payload_shape) -> None:
    """Reject batches that could wrap one edge's ring within a single insert."""
    b, r = payload_shape[0], payload_shape[1]
    if b * r > cfg.tuple_capacity:
        raise ValueError(
            f"batch writes {b}x{r}={b * r} tuples, exceeding tuple_capacity="
            f"{cfg.tuple_capacity}: one edge could wrap its own ring within a "
            "single insert (scatter order would be undefined). Split the "
            "batch or raise tuple_capacity.")


# ---------------------------------------------------------------------------
# Query (paper §3.5, Fig 4)
# ---------------------------------------------------------------------------

def _lookup_sets(cfg: StoreConfig, pred: QueryPred, sites: torch.Tensor,
                 alive: torch.Tensor):
    """(lookup mask (Q, E), broadcast (Q,)): the candidate edge sets E_s,
    E_t, E_i (§3.5.1); AND takes the smallest failure-free set, OR the
    union; anything unusable broadcasts to the alive edges."""
    e = cfg.n_edges
    q = pred.lat0.shape[0]
    es, s_ovf = spatial_slice_edges(pred.lat0, pred.lat1, pred.lon0, pred.lon1,
                                    sites, cfg.slice_cfg)
    et, t_ovf = temporal_slice_edges(pred.t0, pred.t1, e, cfg.slice_cfg)
    eye = torch.arange(e, dtype=torch.int32, device=sites.device)
    ei = hashing.hash_shard_id(pred.sid_hi, pred.sid_lo, e)[..., None] == eye

    sets = torch.stack([es, et, ei], dim=1)                        # (Q, 3, E)
    usable = torch.stack([pred.has_spatial & ~s_ovf,
                          pred.has_temporal & ~t_ovf,
                          pred.has_sid], dim=1)                    # (Q, 3)
    has_failed = (sets & ~alive).any(dim=-1)
    sizes = sets.sum(dim=-1, dtype=torch.int32)
    big = 1 << 30
    score = torch.where(usable & ~has_failed, sizes, big)
    best = torch.argmin(score, dim=-1)                             # (Q,)
    best_ok = torch.gather(score, 1, best[:, None])[:, 0] < big
    chosen = torch.gather(sets, 1, best[:, None, None].expand(q, 1, e))[:, 0]
    union = torch.where(usable[..., None], sets, False).any(dim=1)
    union_ok = usable.any(dim=-1) & ~(union & ~alive).any(dim=-1)

    mask = torch.where(pred.is_and[:, None], chosen, union)
    ok = torch.where(pred.is_and, best_ok, union_ok)
    if not cfg.use_index:
        ok = torch.zeros_like(ok)
    broadcast = ~ok
    mask = torch.where(broadcast[:, None], alive.expand(q, e), mask & alive)
    return mask, broadcast


def scan_engine(tup_f, tup_sid, tup_count, pred: QueryPred, sublists,
                sublist_len, channels: Tuple[int, ...] = (0,),
                valid_c: Optional[int] = None):
    """Per-edge predicate scan (the InfluxDB role): the ``st_scan`` kernel on
    CUDA tensors, its plain version on CPU tensors. Returns count (Q, E)
    int32 and vsum/vmin/vmax (Q, K, E) float32 partials."""
    return st_ops.st_scan(tup_f, tup_sid, tup_count, pred, sublists,
                          sublist_len, channels=channels, valid_c=valid_c)


def _tile_slices(q: int, n_tiles: int):
    """Split the query-batch dim into ``min(n_tiles, q)`` contiguous slices,
    as evenly as possible (sizes differ by at most 1)."""
    n = max(1, min(n_tiles, q))
    base, rem = divmod(q, n)
    out, start = [], 0
    for i in range(n):
        size = base + (1 if i < rem else 0)
        out.append(slice(start, start + size))
        start += size
    return out


def _tile(x, sl: slice, tiles: Sequence[slice]):
    """A NamedTuple of (Q, ...) tensors sliced to one tile (itself when the
    batch is one tile)."""
    return x if len(tiles) == 1 else type(x)(*(f[sl] for f in x))


def merge_tiles(collectives: EdgeCollectives, max_shards: int) -> Callable:
    """The query bodies' collective for ``lockstep``: every block yields the
    tuple of its tiles' candidate lists; ``combine_matched`` merges each
    tile over the blocks. Returns the tuple of merged tiles."""
    def merge(parts):
        return tuple(collectives.combine_matched(list(tile), max_shards)
                     for tile in zip(*parts))
    return merge


def _match_tiles(cfg: StoreConfig, state: StoreState, pred: QueryPred,
                 alive: torch.Tensor, edge_ids: range, overlap_tiles: int):
    """Phase 1 of a shard-local query: the lookup sets from the global
    inputs, then the block's index match for EVERY tile of the batch before
    any tile is planned; one yield (see ``lockstep``) of the tuple of the
    tiles' MatchedShards, which takes the merged tiles back. Returns
    (tiles, merged MatchedShards per tile or None without the index,
    lookup_mask, broadcast)."""
    q = pred.lat0.shape[0]
    dev = state.tup_f.device
    lo, hi = edge_ids.start, edge_ids.stop
    sites = cfg.sites_array(dev)
    lookup_mask, broadcast = _lookup_sets(cfg, pred, sites, alive)
    if not cfg.use_index:
        # Broadcast baseline (Feather-like): every alive edge scans all; no
        # candidate merge, nothing to tile.
        return [slice(0, q)], None, lookup_mask, broadcast
    tiles = _tile_slices(q, overlap_tiles)
    mine = [lookup(state.index, _tile(pred, sl, tiles),
                   lookup_mask[sl, lo:hi], cfg.max_shards_per_query)
            for sl in tiles]
    merged = yield tuple(mine)
    merged = [MatchedShards(*(t.to(dev) for t in m)) for m in merged]
    return tiles, merged, lookup_mask, broadcast


def _plan_tile(cfg: StoreConfig, matched: Optional[MatchedShards],
               alive: torch.Tensor, key, edge_ids: range, q: int,
               dev: torch.device):
    """Phase 2's planning of one tile of ``q`` queries: the assignment and
    the block's per-edge shard OR-lists. ``key`` is the ``random``
    planner's (one key, or the tile's rows of the (Q, 2) folded keys).
    Returns (sublists (q, E_loc, S, 2), sublist_len (q, E_loc), (overflow,
    shards_matched, replicas_lost, completeness_bound))."""
    s = cfg.max_shards_per_query
    lo, hi = edge_ids.start, edge_ids.stop
    e = hi - lo
    if matched is None:
        sublists = torch.zeros((q, e, 1, 2), dtype=torch.int32, device=dev)
        sublist_len = torch.where(alive[lo:hi].expand(q, e), -1,
                                  0).to(torch.int32)
        return sublists, sublist_len, (
            torch.zeros((q,), dtype=torch.bool, device=dev),
            torch.full((q,), -1, dtype=torch.int32, device=dev),
            torch.zeros((q,), dtype=torch.int32, device=dev),
            torch.full((q,), float("nan"), device=dev))
    assignment = planner_lib.plan(cfg.planner, matched, alive, key)  # (q, S)
    # Per-edge OR-lists: entry k of (q, e) is the k-th shard (in matched
    # order) assigned to e — a gather through the stable selection order.
    ids = torch.arange(lo, hi, dtype=torch.int32, device=dev)
    am = assignment[..., None] == ids                               # (q, S, E)
    sublist_len = am.sum(dim=1, dtype=torch.int32)                  # (q, E)
    src = selected_order(am, dim=1).transpose(1, 2)                 # (q, E, S)
    sidv = torch.stack([matched.sid_hi, matched.sid_lo], dim=-1)    # (q, S, 2)
    sidv = torch.gather(sidv[:, None].expand(q, e, s, 2), 2,
                        src[..., None].expand(q, e, s, 2))
    kk = torch.arange(s, dtype=torch.int32, device=dev)
    sublists = torch.where((kk < sublist_len[..., None])[..., None], sidv, -1)

    ovf = matched.overflow
    shards_matched = matched.valid.sum(dim=-1, dtype=torch.int32)
    reps = matched.replicas
    dead_slot = (matched.valid[..., None] & (reps >= 0)
                 & ~alive[reps.clamp(min=0).long()])
    replicas_lost = dead_slot.sum(dim=(1, 2), dtype=torch.int32)
    assigned_n = (matched.valid & (assignment >= 0)).sum(dim=-1,
                                                        dtype=torch.int32)
    bound = torch.where(shards_matched > 0,
                        assigned_n / torch.clamp(shards_matched, min=1), 1.0)
    bound = torch.where(ovf, float("nan"), bound).to(torch.float32)
    return sublists, sublist_len, (ovf, shards_matched, replicas_lost, bound)


def _tile_keys(cfg: StoreConfig, key, q: int, tiles, dev: torch.device):
    """The planner key of each tile: with more than one tile, the
    ``random`` planner's key folded with the GLOBAL query index and sliced
    per tile, so a tile's gumbels are the untiled batch's rows; otherwise
    the key itself (``plan_random`` folds it with the row index)."""
    if len(tiles) == 1 or cfg.planner != "random" or key is None:
        return [key] * len(tiles)
    if not isinstance(key, torch.Tensor):
        key = threefry.fold_in(key, torch.arange(q, device=dev))
    return [key[sl] for sl in tiles]


def plan_body(cfg: StoreConfig, state: StoreState, pred: QueryPred,
              alive: torch.Tensor, key: threefry.Key | None,
              edge_ids: range):
    """Shard-local planning of the untiled batch: index lookup over the
    block's edges, then the candidate merge (a generator, see ``lockstep``:
    it yields the one-tile tuple of the block's MatchedShards and takes the
    merged tuple back), planning and the block's per-edge shard OR-lists —
    everything of a query but the scan. Lookup sets and planning are
    computed from the global ``pred``/``alive`` on every block. ``key`` is
    the ``random`` planner's (the others take none). Returns (sublists (Q,
    E_loc, S, 2), sublist_len (Q, E_loc), (lookup_mask, broadcast,
    overflow, shards_matched, replicas_lost, completeness_bound)); the
    metadata is global and equal on every block.
    """
    dev = state.tup_f.device
    alive = alive.to(device=dev, dtype=torch.bool)
    pred = pred_to(pred, dev)
    _, merged, lookup_mask, broadcast = yield from _match_tiles(
        cfg, state, pred, alive, edge_ids, 1)
    sublists, sublist_len, tail = _plan_tile(
        cfg, None if merged is None else merged[0], alive, key, edge_ids,
        pred.lat0.shape[0], dev)
    return sublists, sublist_len, (lookup_mask, broadcast) + tail


def plan_subqueries(cfg: StoreConfig, state: StoreState, pred: QueryPred,
                    alive: torch.Tensor, key: threefry.Key | None = None,
                    edge_ids: Optional[range] = None,
                    collectives: EdgeCollectives = LOCAL_COLLECTIVES):
    """Index lookup -> planning -> per-edge shard OR-lists of one block
    (``plan_body`` through ``lockstep`` as a list of one; on one device the
    whole store). Returns ``plan_body``'s (sublists, sublist_len,
    metadata)."""
    return lockstep([plan_body(cfg, state, pred, alive, key,
                               _block(cfg, edge_ids))],
                    merge_tiles(collectives, cfg.max_shards_per_query))[0]


def query_body(cfg: StoreConfig, state: StoreState, pred: QueryPred,
               alive: torch.Tensor, agg: AggSpec, key: threefry.Key | None,
               edge_ids: range, overlap_tiles: int = 1):
    """Shard-local query. Phase 1: the lookup sets, then the block's index
    match for every one of ``min(overlap_tiles, Q)`` contiguous tiles of the
    batch, and ONE yield (see ``lockstep``) of the tuple of their candidate
    lists, which the collective merges tile by tile. Phase 2, tile by tile:
    planning, the per-edge OR-lists and ONE scan of the block's log for the
    tile and every channel of ``agg``. With ``overlap_tiles > 1`` the
    ``random`` planner's key is folded with the global query index before
    it is sliced, so the answers do not depend on the tiling. Returns
    (partials — count (Q, E_loc) and vsum/vmin/vmax (Q, K, E_loc) —
    sublist_len (Q, E_loc), metadata), the tiles concatenated along Q, for
    ``finalize_query`` once the blocks' per-edge pieces are concatenated
    back to full E."""
    dev = state.tup_f.device
    alive = alive.to(device=dev, dtype=torch.bool)
    pred = pred_to(pred, dev)
    q = pred.lat0.shape[0]
    tiles, merged, lookup_mask, broadcast = yield from _match_tiles(
        cfg, state, pred, alive, edge_ids, overlap_tiles)
    keys = _tile_keys(cfg, key, q, tiles, dev)
    outs = []
    for i, sl in enumerate(tiles):
        p = _tile(pred, sl, tiles)
        sublists, sublist_len, tail = _plan_tile(
            cfg, None if merged is None else merged[i], alive, keys[i],
            edge_ids, p.lat0.shape[0], dev)
        partials = scan_engine(state.tup_f, state.tup_sid, state.tup_count,
                               p, sublists, sublist_len,
                               channels=agg.channels,
                               valid_c=cfg.tuple_capacity)
        outs.append((partials, sublist_len) + tail)
    if len(outs) == 1:
        partials, sublist_len, *tail = outs[0]
    else:
        partials = tuple(torch.cat([o[0][i] for o in outs])
                         for i in range(4))
        sublist_len, *tail = (torch.cat([o[j] for o in outs])
                              for j in range(1, 6))
    return partials, sublist_len, (lookup_mask, broadcast, *tail)


def query_local(cfg: StoreConfig, state: StoreState, pred: QueryPred,
                alive: torch.Tensor, agg: AggSpec = AggSpec(),
                key: threefry.Key | None = None,
                edge_ids: Optional[range] = None,
                collectives: EdgeCollectives = LOCAL_COLLECTIVES,
                overlap_tiles: int = 1):
    """One block's query (``query_body`` through ``lockstep`` as a list of
    one; on one device the whole store), the batch in ``overlap_tiles``
    tiles. Returns (partials, sublist_len, metadata) for
    ``finalize_query``."""
    return lockstep([query_body(cfg, state, pred, alive, agg, key,
                                _block(cfg, edge_ids), overlap_tiles)],
                    merge_tiles(collectives, cfg.max_shards_per_query))[0]


def finalize_query(partials, sublist_len, lookup_mask, broadcast, overflow,
                   shards_matched, replicas_lost, completeness_bound):
    """Final (Q, K, E) -> (Q[, K]) combine. Zero-match queries get NaN
    min/max/mean; single-channel specs squeeze to (Q,)."""
    count, vsum, vmin, vmax = partials
    total = count.sum(dim=-1, dtype=torch.int32)
    vsum_total = vsum.sum(dim=-1)
    some = (total > 0)[:, None]
    nan = float("nan")
    vmin_total = torch.where(some, vmin.amin(dim=-1), nan)
    vmax_total = torch.where(some, vmax.amax(dim=-1), nan)
    vmean = torch.where(some, vsum_total / torch.clamp(total, min=1)[:, None],
                        nan)
    if vsum_total.shape[-1] == 1:
        vsum_total, vmin_total, vmax_total, vmean = (
            a[:, 0] for a in (vsum_total, vmin_total, vmax_total, vmean))
    result = QueryResult(count=total, vsum=vsum_total, vmin=vmin_total,
                         vmax=vmax_total, overflow=overflow, vmean=vmean,
                         completeness_bound=completeness_bound,
                         replicas_lost=replicas_lost)
    info = QueryInfo(
        lookup_edges=lookup_mask.sum(dim=-1, dtype=torch.int32),
        subquery_edges=(sublist_len != 0).sum(dim=-1, dtype=torch.int32),
        shards_matched=shards_matched,
        max_shards_per_edge=sublist_len.abs().amax(dim=-1),
        broadcast=broadcast,
        replicas_lost=replicas_lost,
        completeness_bound=completeness_bound)
    return result, info


def run_query(cfg: StoreConfig, state: StoreState, pred: QueryPred,
              alive: torch.Tensor, agg: AggSpec = AggSpec(),
              key: threefry.Key | None = None):
    """Single-device query: ``query_local`` then ``finalize_query``.
    Returns (QueryResult, QueryInfo)."""
    agg.validate_for(cfg)
    partials, sublist_len, meta_info = query_local(cfg, state, pred, alive, agg,
                                                   key)
    return finalize_query(partials, sublist_len, *meta_info)
