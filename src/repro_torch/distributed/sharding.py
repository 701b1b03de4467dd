"""The edge axis's contiguous blocks (port of the datastore half of
``repro.distributed.sharding``).

Every per-edge ``StoreState`` leaf carries the logical edge axis E in
front, split into equal contiguous blocks, one per mesh block
(``launch.mesh.EdgeMesh``): over the 1-D ``("edge",)`` mesh's blocks, or
over the product of the 2-D ``("fleet", "edge")`` mesh's axes, fleet-major,
so that a 2-D mesh's blocks are the ranges of an edge mesh of F * N
blocks. The step counter and the latest-per-drone cache are replicated, a
copy on every block. ``store_partition_specs`` is that
contract as a ``StoreState``-shaped tree of markers, and ``shard_store`` /
``gather_store`` split a logical store into blocks and put it back
together by reading it. The blocks are also the failure domains:
``AerialDB.fail_device`` takes out exactly one block
(``device_edge_block``). On a multi-process mesh a process holds only
its fleet's blocks.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.datastore import StoreState
from repro_torch.core.index import IndexState

__all__ = ["EDGE_AXIS", "FLEET_AXIS", "check_edge_partition",
           "device_edge_block", "gather_store", "mesh_edge_axes",
           "mesh_edge_devices", "shard_store", "store_partition_specs"]

EDGE_AXIS = "edge"
FLEET_AXIS = "fleet"


def check_edge_partition(n_edges: int, n_blocks: int,
                         what: str = "the edge mesh") -> int:
    """The one divisibility check of the sharded-state layout contract: the
    logical edge axis splits into equal contiguous blocks, one per
    partition. Returns the block size ``n_edges // n_blocks``."""
    if n_blocks < 1 or n_edges % n_blocks:
        raise ValueError(
            f"n_edges={n_edges} is not divisible by {what} size {n_blocks}: "
            "every device must host the same number of edges (equal "
            "contiguous blocks of the leading E axis). Pick an edge/device "
            "count pair with n_edges % n_devices == 0.")
    return n_edges // n_blocks


def mesh_edge_axes(mesh) -> tuple:
    """The mesh's edge-bearing axes, fleet-major: ``("edge",)`` for the 1-D
    mesh, ``("fleet", "edge")`` for the 2-D fleet mesh. A mesh without an
    ``"edge"`` axis raises."""
    axes = tuple(n for n in mesh.axis_names if n in (FLEET_AXIS, EDGE_AXIS))
    if EDGE_AXIS not in axes:
        raise ValueError(
            f"mesh axes {tuple(mesh.axis_names)} lack the '{EDGE_AXIS}' "
            "axis; build the datastore mesh with launch.mesh.make_edge_mesh "
            "or launch.mesh.make_fleet_mesh.")
    return axes


def mesh_edge_devices(mesh) -> int:
    """Number of edge partitions a mesh carries: the product of its
    edge-bearing axis sizes (its block count)."""
    n = 1
    for ax in mesh_edge_axes(mesh):
        n *= mesh.shape[ax]
    return n


def store_partition_specs() -> StoreState:
    """``StoreState``-shaped tree of the layout contract's markers: every
    per-edge leaf (leading logical-E dim, the nested ``IndexState``
    included) is ``EDGE_AXIS``, split into the mesh's contiguous blocks
    (over the edge-bearing axes' product, fleet-major, on the 2-D mesh);
    the step counter and the latest-per-drone cache (leading dim drones,
    not edges) are ``None``, replicated on every block."""
    edge = EDGE_AXIS
    return StoreState(
        index=IndexState(*(edge for _ in IndexState._fields)),
        tup_f=edge, tup_sid=edge, tup_count=edge, tup_pos=edge,
        tup_overwritten=edge, tup_dropped=edge, steps=None,
        latest_f=None, latest_seen=None)


def _flat(state: StoreState) -> list:
    return list(state.index) + [getattr(state, f) for f in StoreState._fields
                                if f != "index"]


def _unflat(leaves: Sequence) -> StoreState:
    n = len(IndexState._fields)
    rest = [f for f in StoreState._fields if f != "index"]
    return StoreState(index=IndexState(*leaves[:n]),
                      **dict(zip(rest, leaves[n:])))


def shard_store(state: StoreState, mesh,
                into: Optional[Sequence[StoreState]] = None
                ) -> Tuple[StoreState, ...]:
    """Split a logical store into the mesh's blocks per
    ``store_partition_specs``: flat block ``b`` takes rows ``b * E / n ..
    (b + 1) * E / n - 1`` of every per-edge leaf and a copy of every
    replicated leaf, in storage of its own on its device (the port updates
    state in place, so a block is never a view of another store). On a
    multi-process mesh only this process's blocks are built. With ``into``,
    the blocks' existing tensors are overwritten instead, in place. Returns
    the (local) blocks in block order."""
    ranges = mesh.blocks(state.tup_f.shape[0])
    specs = _flat(store_partition_specs())
    leaves = _flat(state)
    if into is not None:
        for blk, ids in zip(into, ranges):
            for dst, src, spec in zip(_flat(blk), leaves, specs):
                dst.copy_(src[ids.start:ids.stop] if spec else src)
        return tuple(into)
    return tuple(
        _unflat([(src[ids.start:ids.stop] if spec else src).to(
            dev, copy=True) for src, spec in zip(leaves, specs)])
        for ids, dev in zip(ranges, mesh.devices))


def gather_store(blocks: Sequence[StoreState]) -> StoreState:
    """The logical ``(E, ...)`` store from its blocks, on block 0's device,
    in storage of its own: the per-edge leaves concatenated in block order,
    the replicated leaves copied from block 0. One process's blocks only:
    they must be every block of the mesh."""
    dev = blocks[0].tup_f.device
    specs = _flat(store_partition_specs())
    cols = zip(*(_flat(b) for b in blocks))
    return _unflat([torch.cat([x.to(dev) for x in col]) if spec
                    else col[0].clone() for col, spec in zip(cols, specs)])


def device_edge_block(n_edges: int, n_devices: int, device: int) -> range:
    """Global edge ids hosted by device ``device`` under the layout contract
    (contiguous blocks of ``E / n_devices`` along the leading edge axis):
    the failure-domain resolution of ``AerialDB.fail_device``, since a
    device loss takes out exactly this block. On the 2-D fleet mesh,
    ``device`` is the flat (fleet-major) block index and ``n_devices`` the
    axis product: block d of fleet f is flat block ``f * N + d``."""
    block = check_edge_partition(n_edges, n_devices, "the device block count")
    if not 0 <= device < n_devices:
        raise ValueError(
            f"device={device} out of range: the edge mesh has {n_devices} "
            f"devices (valid ids 0..{n_devices - 1}).")
    return range(device * block, (device + 1) * block)
