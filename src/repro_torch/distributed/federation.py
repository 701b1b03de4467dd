"""The federated runtime on a one-process edge mesh (port of the 1-D part of
``repro.distributed.federation``).

The store is split over an ``EdgeMesh`` (``launch.mesh.make_edge_mesh``):
each block holds exactly its edges' slice of every ``StoreState`` tensor
(``distributed.sharding.shard_store``), in storage of its own. The
shard-local bodies of ``core.datastore`` (``insert_body``, ``query_body``)
run on every block in lockstep (``core.datastore.lockstep``) with the
in-process collectives built here (``make_collectives``), so the ring
write, the index writes, the index match and the scan touch only a block's
edges, and what crosses blocks is metadata-scale:

  * insert — the (E,) retention watermark, gathered in block order on a
    sweep step only;
  * query  — each block's top-S candidate shards, concatenated in block
    order and re-deduplicated to S (``index.dedup_matched``: a distributed
    top-k, bit-identical to the single-device lookup), then the final
    (Q, E) -> (Q,) combine of the blocks' per-edge partials.

Placement, slice masks and planning are recomputed on every block from the
global inputs, as the reference recomputes them replicated under
``shard_map``. Collective inputs go to block 0's device (on one device
nothing moves). The mesh is 1-D and the batch untiled (the reference tiles
only on its 2-D fleet mesh). ``tests/test_torch_federation.py`` holds this
bitwise to the JAX package's 4-device ``("edge",)`` mesh and to the port's
single-device path.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.datastore import (AggSpec, EdgeCollectives, StoreConfig,
                                        StoreState, check_batch_fits,
                                        finalize_query, insert_body,
                                        insert_local, lockstep, query_body)
from repro_torch.core.index import MatchedShards, QueryPred, dedup_matched
from repro_torch.core.placement import ShardMeta
from repro_torch.core import threefry
from repro_torch.distributed.sharding import (check_edge_partition,
                                              gather_store, mesh_edge_devices,
                                              shard_store,
                                              store_partition_specs)

__all__ = ["check_edge_mesh", "federated_insert_step", "federated_query_step",
           "gather_store", "ingest_rounds", "make_collectives", "shard_store",
           "store_partition_specs"]

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


def _gather_watermark(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """[(E_loc,)] -> (E,) in block order, on block 0's device."""
    dev = parts[0].device
    return torch.cat([w.to(dev) for w in parts])


def _merge_matched(parts: Sequence[MatchedShards],
                   max_shards: int) -> MatchedShards:
    """Concatenate every block's top-S candidate list along S in block order
    and re-deduplicate to the S smallest distinct sids; overflow is the OR
    of the blocks' and the merged count test (``federation._merge_axis`` of
    the reference, one level). Exact: a sid missing from a block's list is
    preceded by >= S smaller sids on that block alone."""
    dev = parts[0].valid.device

    def cat(name):
        return torch.cat([getattr(p, name).to(dev) for p in parts], dim=1)
    merged = dedup_matched(cat("valid"), cat("sid_hi"), cat("sid_lo"),
                           cat("replicas"), max_shards)
    any_ovf = torch.stack([p.overflow.to(dev) for p in parts]).any(dim=0)
    return merged._replace(overflow=merged.overflow | any_ovf)


def make_collectives() -> EdgeCollectives:
    """The edge mesh's collective hooks: the watermark gather and the
    candidate merge, each over every block's contribution in block order
    (the identity bundle of one device is ``datastore.LOCAL_COLLECTIVES``)."""
    return EdgeCollectives(gather_watermark=_gather_watermark,
                           combine_matched=_merge_matched)


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
    """An insert over the edge mesh: the semantics of ``insert_local``, every
    block's ``insert_body`` in lockstep, the blocks updated IN PLACE.
    ``host_step`` is the steps before this insert (the blocks share it).
    Returns (blocks, info) with the per-edge info concatenated to (E,)."""
    check_edge_mesh(cfg, mesh)
    check_batch_fits(cfg, payload.shape)
    ranges = mesh.blocks(cfg.n_edges)
    outs = lockstep(
        [insert_body(cfg, blk, payload.to(dev),
                     ShardMeta(*(f.to(dev) for f in meta)), alive, host_step,
                     ids)
         for blk, ids, dev in zip(blocks, ranges, mesh.devices)],
        make_collectives().gather_watermark)
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
    """A query over the edge mesh: every block's ``query_body`` in lockstep
    (the block's index match, the candidate merge, planning from the global
    inputs, the block's scan for every channel of ``agg``), then the
    blocks' (Q, E_loc) count and (Q, K, E_loc) value partials and
    ``sublist_len`` concatenated along the edge axis in block order and
    combined once by ``finalize_query``. Returns (QueryResult, QueryInfo)
    on block 0's device."""
    check_edge_mesh(cfg, mesh)
    agg.validate_for(cfg)
    outs = lockstep(
        [query_body(cfg, blk, pred, alive, agg, key, ids)
         for blk, ids in zip(blocks, mesh.blocks(cfg.n_edges))],
        partial(make_collectives().combine_matched,
                max_shards=cfg.max_shards_per_query))
    dev = outs[0][1].device

    def cat(xs):
        return torch.cat([x.to(dev) for x in xs], dim=-1)
    partials = tuple(cat([o[0][i] for o in outs]) for i in range(4))
    sublist_len = cat([o[1] for o in outs])
    return finalize_query(partials, sublist_len, *outs[0][2])
