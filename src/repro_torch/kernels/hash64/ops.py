"""Wrapper of the ``hash64`` CUDA kernel (``csrc/hash64.cu``).

``xxh64_mod(hi, lo, n_edges)``: xxHash64 (seed 0) of the 64-bit key
``(uint32(hi) << 32) | uint32(lo)``, reduced mod ``n_edges``, as int32. ``hi``
may be None (a zero high word: the H_t key of a bucket id). CPU tensors take
the plain limb version (``repro_torch.core.hashing.xxh64_mod_plain``); CUDA
tensors launch the kernel, which adds one to ``launches`` per launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0


def _lib():
    lib = build.load("hash64")
    fn = lib.hash64_mod_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def xxh64_mod(hi: Optional[torch.Tensor], lo: torch.Tensor,
              n_edges: int) -> torch.Tensor:
    from repro_torch.core import hashing
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
    lo_c = lo.to(torch.int32).contiguous()
    hi_c = None if hi is None else hi.to(torch.int32).contiguous()
    out = torch.empty(lo.shape, dtype=torch.int32, device=lo.device)
    n = lo_c.numel()
    if n == 0:
        return out
    fn = _lib()
    stream = torch.cuda.current_stream(lo.device).cuda_stream
    err = fn(None if hi_c is None else hi_c.data_ptr(), lo_c.data_ptr(),
             out.data_ptr(), n, n_edges, stream)
    build.check("hash64", err)
    launches += 1
    return out
