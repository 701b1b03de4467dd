"""Wrapper of the ``voronoi_assign`` CUDA kernel (``csrc/voronoi_assign.cu``).

``hash_spatial_kernel(lat, lon, sites)``: H_s, the nearest edge site of each
(lat, lon) point, int32, shaped like ``lat``. CPU tensors take the plain
version (``repro_torch.core.voronoi.voronoi_assign``); CUDA tensors launch
the kernel, which adds one to ``launches`` per launch.

The kernel reads its sites packed (``packed_sites``): the plain version's
own ``centred_sites``, so kernel and plain version share every input bit,
with a grid of cells over the sites and, for each cell, the sites that may
be nearest to one of its points. They are made once per site set: a call
with the same ``sites`` tensor, unedited, reuses them; an in-place edit (the
tensor's ``_version`` moves) or another tensor packs afresh. The cache holds
the site tensor only weakly, so it keeps nothing alive that the caller
dropped.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build

launches = 0

# The cell lists' rounding margin (see csrc/voronoi_assign.cu): 2^-12 of a
# pair's magnitude is 1024 times the float32 evaluation's error bound.
_SLACK = 2.0 ** -12
_TINY = 2.0 ** -100
_WIDEN = 1e-3           # a cell's box is widened by this share of its width
_HUGE = 2.0 ** 60       # sites at or beyond this (centred) get no grid
_MAX_SIDE = 256

# id(sites) -> (weak reference to sites, its _version when packed, packed).
_PACKED: Dict[int, Tuple[weakref.ref, int, Tuple[torch.Tensor, torch.Tensor]]] = {}


@functools.cache
def _launch():
    fn = build.load("voronoi_assign").voronoi_assign_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _grid_side(e: int) -> int:
    """Cells along each axis of the grid for ``e`` sites: about 100 cells a
    site, which lists some 1.7 sites a point of the D400 deployment's slice
    grid (80 sites)."""
    return min(_MAX_SIDE, max(4, math.ceil(10 * math.sqrt(e))))


def _cell_lists(s: torch.Tensor, sn: torch.Tensor, corner: torch.Tensor,
                inv: torch.Tensor, side: int) -> torch.Tensor:
    """(side * side, E) bool, cell ix * side + iy: the sites that may be
    nearest to a point of the cell, in float64, by the witness test of
    csrc/voronoi_assign.cu on the cell widened by ``_WIDEN`` of its width."""
    s64, sn64 = s.double(), sn.double()
    sx, sy = s64[:, 0], s64[:, 1]
    width = 1.0 / inv.double()
    k = torch.arange(side, dtype=torch.float64, device=s.device)
    lo = corner.double()[:, None] + (k - _WIDEN)[None, :] * width[:, None]
    hi = corner.double()[:, None] + (k + 1 + _WIDEN)[None, :] * width[:, None]
    x0, x1 = lo[0].repeat_interleave(side), hi[0].repeat_interleave(side)
    y0, y1 = lo[1].repeat(side), hi[1].repeat(side)
    keep = []
    step = max(1, (1 << 20) // s.shape[0])
    for a in range(0, side * side, step):
        b0, b1, c0, c1 = (v[a:a + step, None] for v in (x0, x1, y0, y1))
        mx = torch.maximum(b0.abs(), b1.abs())
        my = torch.maximum(c0.abs(), c1.abs())
        m = _SLACK * (sn64 + 2 * (mx * sx.abs() + my * sy.abs())) + _TINY
        w = torch.argmin(sn64 - 2 * (0.5 * (b0 + b1) * sx + 0.5 * (c0 + c1) * sy), 1)
        da, db = sx - sx[w][:, None], sy - sy[w][:, None]
        g = (sn64 - sn64[w][:, None]) - 2 * (torch.maximum(b0 * da, b1 * da)
                                             + torch.maximum(c0 * db, c1 * db))
        keep.append(~(g > m + m.gather(1, w[:, None])))
    return torch.cat(keep)


def _pack(sites: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    from repro_torch.core import voronoi
    with torch.no_grad():
        c, s, snorm = voronoi.centred_sites(sites)
        e, dev = s.shape[0], s.device
        rows = torch.zeros(e, 4, dtype=torch.float32, device=dev)
        rows[:, :2] = s
        rows[:, 2] = snorm
        rows.view(torch.int32)[:, 3] = torch.arange(e, dtype=torch.int32,
                                                    device=dev)
        head = torch.zeros(2, 4, dtype=torch.float32, device=dev)
        head[0, :2] = c
        ok = bool(torch.isfinite(snorm).all() & (s.abs() < _HUGE).all())
        if not ok:      # no grid: every point visits every site
            return torch.cat([rows, head]), torch.zeros(1, dtype=torch.int32,
                                                        device=dev)
        side = _grid_side(e)
        lo, hi = s.double().min(0).values, s.double().max(0).values
        span = float((hi - lo).max()) or 1.0
        corner = (lo - span).float()
        inv = (side / (hi - lo + 2 * span)).float()
        head.view(torch.int32)[0, 2:] = side
        head[1, :2] = corner
        head[1, 2:] = inv
        keep = _cell_lists(s, snorm, corner, inv, side)
        cells = torch.zeros(side * side + 1, dtype=torch.int32, device=dev)
        cells[1:] = keep.sum(1).cumsum(0)
        lists = rows[keep.nonzero()[:, 1]]
    return torch.cat([rows, head, lists]), cells


def _forget(key: int, ref: weakref.ref) -> None:
    hit = _PACKED.get(key)
    if hit is not None and hit[0] is ref:
        del _PACKED[key]


def packed_sites(sites: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's inputs for ``sites``, on its device, made once per site
    set: ``packed``, float32 rows of 4: row e < E is ``(sx, sy, snorm)`` of
    ``centred_sites(sites)`` and e's bits as int32; row E the centroid and
    the grid's cells across and down (int32 bits); row E + 1 the grid's
    corner and inverse cell width and height (centred coordinates); then each
    cell's sites, rows as above, in ascending index order. ``cells``, int32:
    each cell's first row in those lists, then their end. A site set with a
    NaN or a centred coordinate of 2^60 or more gets no grid (0 cells)."""
    key = id(sites)
    hit = _PACKED.get(key)
    if hit is not None and hit[0]() is sites and hit[1] == sites._version:
        return hit[2]
    packed = _pack(sites)
    _PACKED[key] = (weakref.ref(sites, functools.partial(_forget, key)),
                    sites._version, packed)
    return packed


class Grid(NamedTuple):
    """The cell grid of a packed site set (``packed_sites``), decoded."""
    centre: torch.Tensor    # (2,) the sites' centroid
    corner: torch.Tensor    # (2,) the grid's corner, centred coordinates
    inv: torch.Tensor       # (2,) 1 / cell width, 1 / cell height
    across: int             # cells along x (0: no grid)
    down: int               # cells along y
    lists: torch.Tensor     # (R, 4) float32: the cells' list rows
    cells: torch.Tensor     # int32: each cell's first list row, then the end


def grid(sites: torch.Tensor) -> Grid:
    """The grid of ``packed_sites(sites)``: its header rows E and E + 1
    decoded, its list rows and its cell offsets."""
    packed, cells = packed_sites(sites)
    e = sites.shape[0]
    across, down = packed.view(torch.int32)[e, 2:].tolist()
    return Grid(packed[e, :2], packed[e + 1, :2], packed[e + 1, 2:], across,
                down, packed[e + 2:], cells)


def locate(lat: torch.Tensor, lon: torch.Tensor, sites: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's float32 cell arithmetic for points shaped like ``lat``:
    (px, py) the centred point, ``inside`` whether its cell indices fall in
    the grid, and ``cell`` (int64, 0 for a point outside)."""
    g = grid(sites)
    px, py = lat.float() - g.centre[0], lon.float() - g.centre[1]
    tx = (px - g.corner[0]) * g.inv[0]
    ty = (py - g.corner[1]) * g.inv[1]
    inside = (tx >= 0) & (tx < g.across) & (ty >= 0) & (ty < g.down)
    cell = (tx.nan_to_num(0.0).clamp(0, max(g.across - 1, 0)).long() * g.down
            + ty.nan_to_num(0.0).clamp(0, max(g.down - 1, 0)).long())
    return px, py, inside, torch.where(inside, cell, 0)


def listed_sites(lat: torch.Tensor, lon: torch.Tensor,
                 sites: torch.Tensor) -> torch.Tensor:
    """The sites on each point's cell list, int32 shaped like ``lat``, or E
    for a point outside the grid (it visits every site). A count for reports
    and tests; it waits on the device."""
    _, _, inside, cell = locate(lat, lon, sites)
    cells = packed_sites(sites)[1]
    listed = cells[cell + inside.long()] - cells[cell]
    return torch.where(inside, listed, sites.shape[0]).to(torch.int32)


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


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as contiguous float32, without a copy where it is one."""
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    return x if x.is_contiguous() else x.contiguous()


def voronoi_assign_cuda(lat: torch.Tensor, lon: torch.Tensor,
                        sites: torch.Tensor) -> torch.Tensor:
    """Launch the kernel (CUDA tensors only)."""
    global launches
    dev = lat.device
    if not lat.is_cuda or lon.device != dev or sites.device != dev:
        raise ValueError("voronoi_assign_cuda takes CUDA tensors on one device")
    if sites.dim() != 2 or sites.shape[1] != 2 or sites.shape[0] < 1:
        raise ValueError(f"sites must be (E, 2), got {tuple(sites.shape)}")
    if lat.shape != lon.shape:
        raise ValueError(f"lat {tuple(lat.shape)} and lon {tuple(lon.shape)} "
                         "must have one shape")
    packed, cells = packed_sites(sites)
    la, lo = _f32(lat), _f32(lon)
    out = torch.empty(lat.shape, dtype=torch.int32, device=dev)
    n = la.numel()
    if n == 0:
        return out
    err = _launch()(la.data_ptr(), lo.data_ptr(), packed.data_ptr(),
                    cells.data_ptr(), out.data_ptr(), n, sites.shape[0],
                    torch.cuda.current_stream(dev).cuda_stream)
    build.check("voronoi_assign", err)
    launches += 1
    return out
