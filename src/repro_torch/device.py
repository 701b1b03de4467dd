"""Device resolution for the port's entry points."""

from __future__ import annotations

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


def scalar_like(x: float, like: torch.Tensor) -> torch.Tensor:
    """0-d float32 tensor on ``like``'s device.

    Dividing a CUDA tensor by a Python float makes PyTorch multiply by the
    reciprocal instead (one ulp away from the true quotient); dividing by a
    device tensor keeps IEEE division, which the hashes' bucket boundaries
    need to agree with the JAX reference bit for bit.
    """
    return torch.full((), x, dtype=torch.float32, device=like.device)
