"""The datastore's edge meshes (port of ``repro.launch.mesh``'s
``make_edge_mesh``, ``make_fleet_mesh`` and ``init_fleet_processes``).

The reference's 1-D ``("edge",)`` mesh puts one contiguous block of the
edge axis on each of ``n`` devices of one process; its 2-D ``("fleet",
"edge")`` mesh splits the edge axis over the axis product, fleet-major, so
that each host (one process under ``jax.distributed``) owns one fleet's
blocks and only the narrow inter-fleet merge crosses hosts. Its
shard-local bodies meet at their collectives under ``shard_map``.

The port's ``EdgeMesh`` is one design for both: a list of blocks, each
with its own ``torch.device``; the blocks may share one device (four blocks
on ``cuda:0``, or on the CPU), since NCCL takes no two ranks on one card.
Every block holds its own store tensors (``distributed.sharding.
shard_store``), and ``distributed.federation`` runs the blocks' bodies in
lockstep with in-process collectives. Under a ``torch.distributed`` world
of F processes (``init_fleet_processes``, gloo), ``make_fleet_mesh(F, N)``
gives process ``p`` the N blocks of fleet ``p``; the collectives add one
gloo exchange over the world after their in-process level.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (EDGE_AXIS, FLEET_AXIS,
                                              check_edge_partition)

__all__ = ["EdgeMesh", "init_fleet_processes", "make_edge_mesh",
           "make_fleet_mesh", "world_size"]

Devices = Union[str, torch.device, Sequence[Union[str, torch.device]]]


def world_size() -> int:
    """Processes in the ``torch.distributed`` world (1 when none is
    initialised)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


@dataclasses.dataclass(frozen=True)
class EdgeMesh:
    """A datastore mesh: ``n_fleet`` fleets of ``n_edge_per_fleet`` blocks,
    block ``f * n_edge_per_fleet + d`` (fleet-major) hosting the edges
    ``b * E / size .. (b + 1) * E / size - 1`` of flat block ``b``.

    ``devices`` are this process's blocks' devices, in block order: every
    block of the mesh in one process (``fleet`` None), or the blocks of
    fleet ``fleet`` in a multi-process world of one process a fleet. The
    1-D ``("edge",)`` mesh is the one-fleet case; its ``axis_names`` stay
    ``("edge",)``."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (EDGE_AXIS,)
    n_fleet: int = 1
    fleet: Optional[int] = None

    @property
    def n_edge_per_fleet(self) -> int:
        return len(self.devices) // (self.n_fleet if self.fleet is None else 1)

    @property
    def shape(self) -> dict:
        if FLEET_AXIS in self.axis_names:
            return {FLEET_AXIS: self.n_fleet, EDGE_AXIS: self.n_edge_per_fleet}
        return {EDGE_AXIS: self.n_edge_per_fleet}

    @property
    def size(self) -> int:
        """Blocks of the whole mesh, every process's."""
        return self.n_fleet * self.n_edge_per_fleet

    @property
    def multi_process(self) -> bool:
        return self.fleet is not None

    def blocks(self, n_edges: int) -> Tuple[range, ...]:
        """This process's blocks' global edge ids, in block order (the
        layout contract's contiguous blocks of the leading E axis)."""
        n = check_edge_partition(n_edges, self.size,
                                 f"the edge mesh {self.shape}")
        first = (self.fleet or 0) * self.n_edge_per_fleet
        return tuple(range(b * n, (b + 1) * n)
                     for b in range(first, first + len(self.devices)))


def _devices(device: Devices, n: int, what: str) -> Tuple[torch.device, ...]:
    if isinstance(device, (str, torch.device)):
        return (resolve_device(device),) * n
    devices = tuple(resolve_device(d) for d in device)
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices given for {what} of {n} "
                         "blocks: pass one device, or one a block.")
    return devices


def make_edge_mesh(n_devices: int, n_edges: int | None = None, *,
                   device: Devices = "cuda") -> EdgeMesh:
    """A 1-D edge mesh of ``n_devices`` blocks in one process, the
    federation story at device scale: each block plays a contiguous block
    of ``E / n_devices`` ground edge servers. ``n_edges``, when given, is
    checked for divisibility here, at construction, instead of later inside
    the runtime.

    ``device`` is one device, which takes every block (the default: the
    card), or a sequence of ``n_devices`` devices. Without CUDA a card
    device raises: pass ``device="cpu"`` for the plain versions on the host.
    The blocks double as failure domains: ``AerialDB.fail_device(d)`` takes
    out exactly block ``d``'s edges."""
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices} must be >= 1.")
    if n_edges is not None:
        check_edge_partition(n_edges, n_devices, "the 1-D edge mesh")
    return EdgeMesh(_devices(device, n_devices, "an edge mesh"))


def make_fleet_mesh(n_fleet: int, n_edge_per_fleet: int | None = None,
                    n_edges: int | None = None, *,
                    device: Devices = "cuda") -> EdgeMesh:
    """A 2-D ``("fleet", "edge")`` mesh: ``n_fleet`` fleets of
    ``n_edge_per_fleet`` blocks, the edge axis split over the product,
    fleet-major (fleet f's blocks host the contiguous edge blocks ``f * N ..
    (f + 1) * N - 1``). The in-fleet merge runs first and only the
    S-wide inter-fleet merge crosses fleets.

    ``device`` is one device, which takes every block (then
    ``n_edge_per_fleet`` is required), or the sequence of the mesh's
    devices, fleet-major, one a block (``n_edge_per_fleet`` defaults to
    ``len(device) // n_fleet``). In a ``torch.distributed`` world
    (``init_fleet_processes``) of ``n_fleet`` processes, process ``p``
    keeps the N blocks of fleet ``p``. Pass ``n_edges`` to validate
    divisibility at construction. Without CUDA a card device raises."""
    if n_fleet < 1:
        raise ValueError(f"n_fleet={n_fleet} must be >= 1.")
    if n_edge_per_fleet is None:
        if isinstance(device, (str, torch.device)):
            raise ValueError(
                "n_edge_per_fleet is required with a single device: pass "
                "it, or the sequence of the mesh's devices.")
        n_dev = len(device)
        if n_dev % n_fleet:
            raise ValueError(
                f"n_fleet={n_fleet} does not divide the available "
                f"{n_dev} devices; pass n_edge_per_fleet explicitly.")
        n_edge_per_fleet = n_dev // n_fleet
    if n_edge_per_fleet < 1:
        raise ValueError(f"n_edge_per_fleet={n_edge_per_fleet} must be >= 1.")
    if n_edges is not None:
        check_edge_partition(n_edges, n_fleet * n_edge_per_fleet,
                             "the (fleet, edge) mesh")
    devices = _devices(device, n_fleet * n_edge_per_fleet, "a fleet mesh")
    world = world_size()
    fleet = None
    if world > 1:
        if world != n_fleet:
            raise ValueError(
                f"a torch.distributed world of {world} processes runs one "
                f"fleet a process: make_fleet_mesh({world}, ...), not "
                f"n_fleet={n_fleet}.")
        fleet = torch.distributed.get_rank()
        devices = devices[fleet * n_edge_per_fleet:
                          (fleet + 1) * n_edge_per_fleet]
    return EdgeMesh(devices, (FLEET_AXIS, EDGE_AXIS), n_fleet, fleet)


def init_fleet_processes(coordinator_address: str, num_processes: int,
                         process_id: int, *, timeout_s: float = 60.0) -> None:
    """``torch.distributed`` wiring for a multi-process fleet runtime: one
    OS process per fleet partition (paper scale: one physical host per edge
    cluster). After this, ``make_fleet_mesh(num_processes, N)`` gives each
    process its fleet's N blocks, and the collectives exchange over the
    world in rank (fleet) order.

    ``coordinator_address`` is ``host:port`` of process 0's rendezvous.
    The exchanges are host tensors over gloo, as the reference selects
    gloo for its CPU collectives (NCCL takes no two ranks on one card, and
    what crosses is metadata-scale). A peer that does not arrive within
    ``timeout_s`` makes this raise instead of waiting forever."""
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator_address={coordinator_address!r} is "
                         "not host:port")
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{host}:{port}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
