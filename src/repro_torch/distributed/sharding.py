"""The edge axis's contiguous device blocks (port of the layout-contract
half of ``repro.distributed.sharding``).

Every per-edge ``StoreState`` leaf carries the logical edge axis E in
front, split into equal contiguous blocks, one per device. The single-device
port places nothing, but the blocks are also the failure domains:
``AerialDB.fail_device`` takes out exactly one block. The mesh helpers
(``mesh_edge_axes``, ``store_partition_specs``, ``shard_store``) come with
the federated runtime.
"""

from __future__ import annotations

__all__ = ["check_edge_partition", "device_edge_block"]


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


def device_edge_block(n_edges: int, n_devices: int, device: int) -> range:
    """Global edge ids hosted by device ``device`` under the layout contract
    (contiguous blocks of ``E / n_devices`` along the leading edge axis):
    the failure-domain resolution of ``AerialDB.fail_device``, since a
    device loss takes out exactly this block."""
    block = check_edge_partition(n_edges, n_devices, "the device block count")
    if not 0 <= device < n_devices:
        raise ValueError(
            f"device={device} out of range: the edge mesh has {n_devices} "
            f"devices (valid ids 0..{n_devices - 1}).")
    return range(device * block, (device + 1) * block)
