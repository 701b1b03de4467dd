"""Wrapper of the ``voronoi_assign`` CUDA kernel (``csrc/voronoi_assign.cu``).

``hash_spatial_kernel(lat, lon, sites)``: H_s, the nearest edge site of each
(lat, lon) point, int32, shaped like ``lat``. CPU tensors take the plain
version (``repro_torch.core.voronoi.voronoi_assign``); CUDA tensors launch
the kernel, which adds one to ``launches`` per launch. The centroid, centred
sites and squared norms come from the plain version's own
``centred_sites``, so kernel and plain version share every input bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0


def _lib():
    lib = build.load("voronoi_assign")
    fn = lib.voronoi_assign_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hash_spatial_kernel(lat: torch.Tensor, lon: torch.Tensor,
                        sites: torch.Tensor) -> torch.Tensor:
    from repro_torch.core import voronoi
    if lat.shape != lon.shape:
        raise ValueError(f"lat {tuple(lat.shape)} and lon {tuple(lon.shape)} "
                         "must have one shape")
    if not lat.is_cuda:
        pts = torch.stack([lat.reshape(-1), lon.reshape(-1)], dim=-1)
        return voronoi.voronoi_assign(pts, sites).reshape(lat.shape)
    return voronoi_assign_cuda(lat, lon, sites)


def voronoi_assign_cuda(lat: torch.Tensor, lon: torch.Tensor,
                        sites: torch.Tensor) -> torch.Tensor:
    """Launch the kernel (CUDA tensors only)."""
    global launches
    from repro_torch.core import voronoi
    dev = lat.device
    if not lat.is_cuda or lon.device != dev or sites.device != dev:
        raise ValueError("voronoi_assign_cuda takes CUDA tensors on one device")
    if sites.dim() != 2 or sites.shape[1] != 2 or sites.shape[0] < 1:
        raise ValueError(f"sites must be (E, 2), got {tuple(sites.shape)}")
    c, s, snorm = voronoi.centred_sites(sites)
    la = lat.to(torch.float32).reshape(-1).contiguous()
    lo = lon.to(torch.float32).reshape(-1).contiguous()
    s = s.contiguous()
    out = torch.empty(la.shape, dtype=torch.int32, device=dev)
    n = la.numel()
    if n == 0:
        return out.reshape(lat.shape)
    fn = _lib()
    err = fn(la.data_ptr(), lo.data_ptr(), c.data_ptr(), s.data_ptr(),
             snorm.data_ptr(), out.data_ptr(), n, s.shape[0],
             torch.cuda.current_stream(dev).cuda_stream)
    build.check("voronoi_assign", err)
    launches += 1
    return out.reshape(lat.shape)
