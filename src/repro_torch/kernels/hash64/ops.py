"""Wrapper of the ``hash64`` CUDA kernel (``csrc/hash64.cu``).

``xxh64_mod(hi, lo, n_edges)``: xxHash64 (seed 0) of the 64-bit key
``(uint32(hi) << 32) | uint32(lo)``, reduced mod ``n_edges``, as int32. ``hi``
may be None (a zero high word: the H_t key of a bucket id). CPU tensors take
the plain limb version (``repro_torch.core.hashing.xxh64_mod_plain``); CUDA
tensors launch the kernel, which adds one to ``launches`` per launch.

The kernel reduces mod n without a 64-bit division: ``mod_constants(n)``
gives it ``m = ceil(2^64 / n) mod 2^64`` and ``2^32 mod n``, made once per
``n`` (see ``csrc/hash64.cu`` for why the reduction is exact). Inputs that
are already int32 and contiguous, views at any offset included, go to the
kernel as they are; anything else is converted to a contiguous int32 copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

# hashing imports this module at its top, and this module uses hashing only
# inside calls, so either may be imported first.
from repro_torch.core import hashing
from repro_torch.kernels import build

launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("hash64")
    lib.hash64_mod_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_void_p]
    lib.hash64_mod_launch.restype = ctypes.c_int
    lib.hash64_empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.hash64_empty_launch.restype = ctypes.c_int
    return lib


@functools.cache
def mod_constants(n_edges: int) -> Tuple[int, int]:
    """``(m, r)`` the kernel reduces with: ``m = ceil(2^64 / n) mod 2^64``
    (0 for n = 1) and ``r = 2^32 mod n``."""
    hashing.check_n_edges(n_edges)
    m = (((1 << 64) - 1) // n_edges + 1) & ((1 << 64) - 1)
    return m, (1 << 32) % n_edges


def _int32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.int32 and x.is_contiguous():
        return x
    return x.to(torch.int32).contiguous()


def xxh64_mod(hi: Optional[torch.Tensor], lo: torch.Tensor,
              n_edges: int) -> torch.Tensor:
    hashing.check_n_edges(n_edges)
    if hi is not None and hi.shape != lo.shape:
        raise ValueError(f"hi {tuple(hi.shape)} and lo {tuple(lo.shape)} "
                         "must have one shape")
    if not lo.is_cuda:
        return hashing.xxh64_mod_plain(hi, lo, n_edges)
    return xxh64_mod_cuda(hi, lo, n_edges)


def xxh64_mod_cuda(hi: Optional[torch.Tensor], lo: torch.Tensor,
                   n_edges: int) -> torch.Tensor:
    """Launch the kernel (CUDA tensors only)."""
    global launches
    if not lo.is_cuda or (hi is not None and hi.device != lo.device):
        raise ValueError("xxh64_mod_cuda takes CUDA tensors on one device")
    m, r = mod_constants(n_edges)
    n = lo.numel()
    if n >= 1 << 31:                    # the kernel's count is a C int
        raise ValueError(f"xxh64_mod_cuda takes fewer than 2^31 keys, got {n}")
    lo_c = _int32(lo)
    out = torch.empty_like(lo_c)        # contiguous int32, cheaper than empty
    if n == 0:
        return out
    hi_c = None if hi is None else _int32(hi)
    err = _lib().hash64_mod_launch(
        None if hi_c is None else hi_c.data_ptr(), lo_c.data_ptr(),
        out.data_ptr(), n, n_edges, m, r,
        torch._C._cuda_getCurrentRawStream(lo.device.index))
    build.check("hash64", err)
    launches += 1
    return out


def launch_floor(n: int, device: torch.device) -> None:
    """Launch the empty kernel on the grid ``xxh64_mod_cuda`` takes for ``n``
    keys: a yardstick of the launch for timing, called by no path of the
    port, and not counted in ``launches``."""
    build.check("hash64", _lib().hash64_empty_launch(
        n, torch.cuda.current_stream(device).cuda_stream))
