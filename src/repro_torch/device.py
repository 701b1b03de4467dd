"""Device resolution for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    Raises when a CUDA device is asked for (the default) and CUDA is not
    available: the port never falls back to the CPU silently. Pass
    ``device="cpu"`` to run the plain PyTorch versions on the host.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs CUDA, but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions "
            "on the host.")
    return dev


def reciprocal_like(c: float, like: torch.Tensor) -> torch.Tensor:
    """0-d float32 tensor on ``like``'s device holding ``float32(1) /
    float32(c)``.

    The JAX reference divides by a constant (a slice cell's width, the
    temporal bucket width) inside ``jit``, which XLA compiles as a multiply
    by the constant's float32 reciprocal: at exact boundaries such as a
    longitude of 77.45 (the city's edge, where drones clamp) the product
    floors one cell below the true quotient. Multiplying by this tensor
    repeats that float32 product on either device; a Python scalar would
    enter the CUDA kernel through a double.
    """
    return torch.full((), float(np.float32(1) / np.float32(c)),
                      dtype=torch.float32, device=like.device)
