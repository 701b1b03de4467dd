"""The federated runtime on a datastore mesh (port of
``repro.distributed.federation``).

The store is split over an ``EdgeMesh`` (``launch.mesh.make_edge_mesh``,
the 1-D ``("edge",)`` mesh, or ``make_fleet_mesh``, the 2-D ``("fleet",
"edge")`` mesh): each block holds exactly its edges' slice of every
``StoreState`` tensor (``distributed.sharding.shard_store``), in storage of
its own. The shard-local bodies of ``core.datastore`` (``insert_body``,
``query_body``) run on every block of the process in lockstep
(``core.datastore.lockstep``) with the collectives built here
(``make_collectives``), so the ring write, the index writes, the index
match and the scan touch only a block's edges, and what crosses blocks is
metadata-scale:

  * insert — the (E,) retention watermark, gathered in flat block order on
    a sweep step only;
  * query  — each block's top-S candidate shards, merged innermost axis
    first: on the 1-D mesh one flat level over the blocks; on the 2-D mesh
    each fleet's blocks first, then the fleets' S-wide lists, each level
    re-deduplicated to S (``index.dedup_matched``: a distributed top-k,
    bit-identical to the single-device lookup); then the final (Q, E) ->
    (Q,) combine of the blocks' per-edge partials. On the 2-D mesh the
    batch is split into two tiles (``query_body``'s ``overlap_tiles=2``):
    every tile's candidate merge is issued before any tile is planned or
    scanned, and the answers are the untiled plan's bit for bit.

Placement, slice masks and planning are recomputed on every block from the
global inputs, as the reference recomputes them replicated under
``shard_map``. Collective inputs go to block 0's device (on one device
nothing moves). Under a ``torch.distributed`` world of one process a fleet
(``launch.mesh.init_fleet_processes``), each hook runs its in-process level
over the process's blocks, then one gloo ``all_gather`` over the world, in
rank (fleet) order: the watermark, the fleets' S-wide lists, and at the
final combine the (Q, E_fleet) and (Q, K, E_fleet) partials, so that every
process computes the same answer. No tuple crosses a process; each
exchange is staged through one host buffer (``exchanges`` counts them).
``traffic`` records what every exchange moves, by kind, dtype and shape:
the collective contract (``repro_torch.analysis.collective_contract``)
holds it to its kinds and to independence from ``tuple_capacity``.
``tests/test_torch_federation.py`` holds this bitwise to the JAX package's
4-device ``("edge",)`` and ``(2, 2) ("fleet", "edge")`` meshes and to the
port's single-device path; ``tests/test_torch_multihost.py`` holds two gloo
processes to the JAX package's ``(2, 2)`` mesh.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.datastore import (AggSpec, EdgeCollectives, StoreConfig,
                                        StoreState, check_batch_fits,
                                        finalize_query, insert_body,
                                        insert_local, lockstep, merge_tiles,
                                        query_body)
from repro_torch.core.index import MatchedShards, QueryPred, dedup_matched
from repro_torch.core.placement import ShardMeta
from repro_torch.core import threefry
from repro_torch.distributed.sharding import (check_edge_partition,
                                              gather_store, mesh_edge_axes,
                                              mesh_edge_devices, shard_store,
                                              store_partition_specs)

__all__ = ["check_edge_mesh", "exchanges", "federated_insert_step",
           "federated_query_step", "gather_store", "ingest_rounds",
           "make_collectives", "shard_store", "store_partition_specs"]

#: The multi-process mesh's gloo exchanges in this process: ``calls``,
#: ``syncs`` (on the card, the blocking copy of each exchange's buffer to
#: the host) and the host ``seconds`` spent from that copy to the result's
#: return to the device. Callers zero the entries to start a count.
exchanges = {"calls": 0, "syncs": 0, "seconds": 0.0}

#: What crosses blocks in this process, one count an exchange, keyed by
#: (kind, ((dtype, shape), ...) of the tensors it gathers). Kinds:
#: "watermark" (an insert's sweep step), "merge1" and "merge2" (a candidate
#: merge over a fleet's blocks and over the fleets), "combine" (a query's
#: per-edge partials) and "world" (a gloo exchange's byte buffer). Callers
#: clear it to start a record.
traffic: Counter = Counter()

Blocks = Tuple[StoreState, ...]

# Insert info entries per edge (concatenated in block order); the others
# (``replicas``, ``retention_watermark``) are the same on every block.
_PER_EDGE_INFO = ("intake_per_edge", "index_writes_per_edge",
                  "tuples_overwritten", "tuples_dropped",
                  "index_entries_dropped", "index_entries_retired")


def check_edge_mesh(cfg: StoreConfig, mesh) -> int:
    """Validate the mesh against the deployment; returns its number of edge
    partitions (blocks)."""
    n_dev = mesh_edge_devices(mesh)  # raises without an "edge" axis
    check_edge_partition(cfg.n_edges, n_dev,
                         f"the edge mesh {dict(mesh.shape)}")
    if cfg.n_failure_domains > 1 and n_dev % cfg.n_failure_domains:
        raise ValueError(
            f"n_failure_domains={cfg.n_failure_domains} is incompatible with "
            f"an edge mesh of {n_dev} devices: each failure domain must be a "
            "whole number of device blocks (n_devices % n_failure_domains "
            "== 0), or two 'spread' replicas can silently share one device "
            "and a single device loss still takes out every copy. Use "
            f"n_failure_domains == {n_dev} (one domain per device), a "
            "divisor of it, or 1 to disable spreading.")
    return n_dev


def _record(kind: str, tensors: Sequence[torch.Tensor]) -> None:
    traffic[(kind, tuple((str(t.dtype).removeprefix("torch."), tuple(t.shape))
                         for t in tensors))] += 1


def _gather_watermark(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """[(E_loc,)] -> (E_loc * n,) in block order, on block 0's device."""
    dev = parts[0].device
    out = torch.cat([w.to(dev) for w in parts])
    _record("watermark", (out,))
    return out


def _world_gather(tensors: Sequence[torch.Tensor]) -> list:
    """Every process's ``tensors`` (the same shapes and dtypes on every
    rank) gathered over the ``torch.distributed`` world: for each, the
    ranks' copies stacked in rank (fleet) order along a new leading dim, on
    the tensor's device. The lot crosses as one byte buffer: one copy to the
    host, one gloo ``all_gather`` and one copy back (gloo takes no CUDA
    tensors, and no bool)."""
    dist = torch.distributed
    t0 = time.perf_counter()
    dev = tensors[0].device
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    host = torch.cat(flat).cpu()
    _record("world", (host,))
    got = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(got, host)
    every = torch.stack(got).to(dev)
    out, off = [], 0
    for t, f in zip(tensors, flat):
        part = every[:, off:off + f.numel()].contiguous()
        out.append(part.view(t.dtype).reshape(len(got), *t.shape))
        off += f.numel()
    exchanges["calls"] += 1
    exchanges["syncs"] += dev.type == "cuda"
    exchanges["seconds"] += time.perf_counter() - t0
    return out


def _merge_level(parts: Sequence[MatchedShards], max_shards: int,
                 level: int = 1) -> MatchedShards:
    """One merge level: concatenate the participants' top-S candidate lists
    along S in their order and re-deduplicate to the S smallest distinct
    sids; overflow is the OR of the participants' and the merged count test
    (``federation._merge_axis`` of the reference). Exact: a sid missing
    from a participant's list is preceded by >= S smaller sids on that
    participant alone. ``level`` names the exchange in ``traffic`` (1 a
    fleet's blocks, 2 the fleets)."""
    dev = parts[0].valid.device

    def cat(name):
        return torch.cat([getattr(p, name).to(dev) for p in parts], dim=1)
    lists = [cat(f) for f in ("valid", "sid_hi", "sid_lo", "replicas")]
    ovf = torch.stack([p.overflow.to(dev) for p in parts])
    _record(f"merge{level}", (*lists, ovf))
    merged = dedup_matched(*lists, max_shards)
    return merged._replace(overflow=merged.overflow | ovf.any(dim=0))


def make_collectives(mesh=None) -> EdgeCollectives:
    """The mesh's collective hooks, each over the contributions of the
    process's blocks in block order (the identity bundle of one device is
    ``datastore.LOCAL_COLLECTIVES``).

    On the 1-D mesh (``None`` too): the watermark gather and one flat
    merge level. On the 2-D mesh, innermost axis first, as the reference's
    ``_merge_matched(..., reversed(axes))``: each fleet's N blocks merged,
    then the fleets' S-wide lists; in a multi-process world, the process's
    fleet list and the watermark cross once over gloo in between."""
    if mesh is None or len(mesh_edge_axes(mesh)) == 1:
        return EdgeCollectives(gather_watermark=_gather_watermark,
                               combine_matched=_merge_level)
    n = mesh.n_edge_per_fleet

    def gather_watermark(parts):
        mine = _gather_watermark(parts)
        if not mesh.multi_process:
            return mine
        return _world_gather([mine])[0].reshape(-1)

    def combine_matched(parts, max_shards):
        fleets = [_merge_level(parts[i:i + n], max_shards)
                  for i in range(0, len(parts), n)]
        if mesh.multi_process:      # every process's fleet list, in order
            got = _world_gather(fleets[0])
            fleets = [MatchedShards(*(x[r] for x in got))
                      for r in range(len(got[0]))]
        return _merge_level(fleets, max_shards, level=2)
    return EdgeCollectives(gather_watermark=gather_watermark,
                           combine_matched=combine_matched)


def _merge_info(infos: Sequence[dict]) -> dict:
    """The blocks' insert infos as the reference's out_specs give them: the
    per-edge entries concatenated to (E,) in block order (on block 0's
    device), ``replicas`` and ``retention_watermark`` from block 0."""
    dev = infos[0]["intake_per_edge"].device
    out = dict(infos[0])
    for k in _PER_EDGE_INFO:
        out[k] = torch.cat([inf[k].to(dev) for inf in infos], dim=-1)
    return out


def federated_insert_step(cfg: StoreConfig, blocks: Sequence[StoreState],
                          payload: torch.Tensor, meta: ShardMeta,
                          alive: torch.Tensor, mesh, host_step: int
                          ) -> Tuple[Blocks, dict]:
    """An insert over the mesh: the semantics of ``insert_local``, every
    local block's ``insert_body`` in lockstep, the blocks updated IN PLACE.
    ``host_step`` is the steps before this insert (the blocks share it).
    Returns (blocks, info) with the per-edge info of the process's blocks
    concatenated in block order: (E,) in one process, the fleet's edges
    in a multi-process world (the reference's addressable shards)."""
    check_edge_mesh(cfg, mesh)
    check_batch_fits(cfg, payload.shape)
    ranges = mesh.blocks(cfg.n_edges)
    outs = lockstep(
        [insert_body(cfg, blk, payload.to(dev),
                     ShardMeta(*(f.to(dev) for f in meta)), alive, host_step,
                     ids)
         for blk, ids, dev in zip(blocks, ranges, mesh.devices)],
        make_collectives(mesh).gather_watermark)
    return tuple(s for s, _ in outs), _merge_info([i for _, i in outs])


def ingest_rounds(cfg: StoreConfig, state, payloads: torch.Tensor,
                  metas: ShardMeta, alive: torch.Tensor, mesh=None, *,
                  host_step: int):
    """Multi-round ingest: N rounds inserted one after another with no host
    sync, into one store (``mesh=None``: ``insert_local``) or the mesh's
    blocks (``federated_insert_step``), IN PLACE.

    Args:
      state:     a StoreState, or the mesh's blocks.
      payloads:  (N, B, R, 3+V) on the state's device.
      metas:     ShardMeta with (N, B) fields, on the same device.
      alive:     (E,) availability mask, held fixed across the N rounds.
      host_step: the steps before the first round, mirrored on the host.

    Returns (state, info) with every info entry stacked over the N rounds
    (an empty dict for N = 0).
    """
    check_batch_fits(cfg, tuple(payloads.shape)[1:])
    if mesh is not None:
        check_edge_mesh(cfg, mesh)
    infos = []
    for i in range(payloads.shape[0]):
        meta = ShardMeta(*(f[i] for f in metas))
        if mesh is None:
            state, info = insert_local(cfg, state, payloads[i], meta, alive,
                                       host_step + i)
        else:
            state, info = federated_insert_step(
                cfg, state, payloads[i], meta, alive, mesh, host_step + i)
        infos.append(info)
    if not infos:
        return state, {}
    return state, {k: torch.stack([inf[k] for inf in infos])
                   for k in infos[0]}


def federated_query_step(cfg: StoreConfig, blocks: Sequence[StoreState],
                         pred: QueryPred, alive: torch.Tensor,
                         key: Optional[threefry.Key], mesh,
                         agg: AggSpec = AggSpec()):
    """A query over the mesh: every local block's ``query_body`` in
    lockstep (the block's index match, the candidate merge, planning from
    the global inputs, the block's scan for every channel of ``agg``; in
    two tiles on a mesh with the fleet axis, as the reference), then the
    blocks' (Q, E_loc) count and (Q, K, E_loc) value partials and
    ``sublist_len`` concatenated along the edge axis in flat block order
    (across the world's processes too) and combined once by
    ``finalize_query``. Returns (QueryResult, QueryInfo) on block 0's
    device."""
    check_edge_mesh(cfg, mesh)
    agg.validate_for(cfg)
    overlap_tiles = 2 if len(mesh_edge_axes(mesh)) > 1 else 1
    outs = lockstep(
        [query_body(cfg, blk, pred, alive, agg, key, ids, overlap_tiles)
         for blk, ids in zip(blocks, mesh.blocks(cfg.n_edges))],
        merge_tiles(make_collectives(mesh), cfg.max_shards_per_query))
    dev = outs[0][1].device

    def cat(xs):
        return torch.cat([x.to(dev) for x in xs], dim=-1)
    per_edge = [cat([o[0][i] for o in outs]) for i in range(4)]
    per_edge.append(cat([o[1] for o in outs]))
    _record("combine", per_edge)
    if mesh.multi_process:
        per_edge = [torch.cat(list(x), dim=-1)
                    for x in _world_gather(per_edge)]
    return finalize_query(tuple(per_edge[:4]), per_edge[4], *outs[0][2])
