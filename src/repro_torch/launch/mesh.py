"""The datastore's edge mesh in one process (port of
``repro.launch.mesh.make_edge_mesh``).

The reference's 1-D ``("edge",)`` mesh puts one contiguous block of the
edge axis on each of ``n`` devices of one process, and its shard-local
bodies meet at their collectives under ``shard_map``. The port's
``EdgeMesh`` is a list of ``n`` blocks, each with its own ``torch.device``;
the blocks may share one device (four blocks on ``cuda:0``, or on the
CPU), since NCCL takes no two ranks on one card. Every block holds its own
store tensors (``distributed.sharding.shard_store``), and
``distributed.federation`` runs the blocks' bodies in lockstep with
in-process collectives.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import EDGE_AXIS, check_edge_partition

__all__ = ["EdgeMesh", "make_edge_mesh"]


@dataclasses.dataclass(frozen=True)
class EdgeMesh:
    """A 1-D ``("edge",)`` datastore mesh of one process: block ``d`` hosts
    the edges ``d * E / n .. (d + 1) * E / n - 1`` on ``devices[d]``."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (EDGE_AXIS,)

    @property
    def shape(self) -> dict:
        return {EDGE_AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def blocks(self, n_edges: int) -> Tuple[range, ...]:
        """Each block's global edge ids, in block order (the layout
        contract's contiguous blocks of the leading E axis)."""
        n = check_edge_partition(n_edges, self.size,
                                 f"the edge mesh {self.shape}")
        return tuple(range(d * n, (d + 1) * n) for d in range(self.size))


def make_edge_mesh(n_devices: int, n_edges: int | None = None, *,
                   device: Union[str, torch.device,
                                 Sequence[Union[str, torch.device]]] = "cuda"
                   ) -> EdgeMesh:
    """A 1-D edge mesh of ``n_devices`` blocks, the federation story at
    device scale: each block plays a contiguous block of ``E / n_devices``
    ground edge servers. ``n_edges``, when given, is checked for
    divisibility here, at construction, instead of later inside the
    runtime.

    ``device`` is one device, which takes every block (the default: the
    card), or a sequence of ``n_devices`` devices. Without CUDA a card
    device raises: pass ``device="cpu"`` for the plain versions on the host.
    The blocks double as failure domains: ``AerialDB.fail_device(d)`` takes
    out exactly block ``d``'s edges."""
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices} must be >= 1.")
    if n_edges is not None:
        check_edge_partition(n_edges, n_devices, "the 1-D edge mesh")
    if isinstance(device, (str, torch.device)):
        devices = (resolve_device(device),) * n_devices
    else:
        devices = tuple(resolve_device(d) for d in device)
        if len(devices) != n_devices:
            raise ValueError(f"{len(devices)} devices given for an edge mesh "
                             f"of {n_devices} blocks: pass one device, or "
                             "one a block.")
    return EdgeMesh(devices)
