"""Wrapper of the ``st_scan`` CUDA kernel (``csrc/st_scan.cu``).

``st_scan`` takes the store's native column-major log (``(E, 3+V, C)`` /
``(E, 2, C)``) and a ``QueryPred`` batch, exactly like the JAX package's
``repro.kernels.st_scan.ops.st_scan``, and returns
``(count (Q, E) int32, vsum/vmin/vmax (Q, K, E) float32)``. CPU tensors take
the plain version (``ref.st_scan_ref``); CUDA tensors launch the kernel,
which adds one to ``launches`` per launch.

Wrapper contract (as in the JAX package): ``valid_c = min(valid_c, C)`` is
forwarded so lane-padding slots above the logical ring capacity are never
admitted. The kernel takes any batch size (one pass over the log per 64
queries) and aggregates at most ``MAX_K`` channels per launch; a larger
channel set runs one launch per group of channels. Each edge's live slots
are split among ``scan_splits(valid_c)`` blocks of one thread-block
cluster, whose partials the cluster merges in rank order.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.st_scan.ref import check_channels, st_scan_ref

MAX_K = 4
BLOCK_SLOTS = 1024   # slots a block's eight warps take at a time
MAX_SPLITS = 8       # blocks of one edge's cluster (the portable cluster size)

launches = 0


def _lib():
    lib = build.load("st_scan")
    fn = lib.st_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * (7 + MAX_K)
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def scan_splits(valid_c: int) -> int:
    """Blocks that share one edge's live slots: one per ``BLOCK_SLOTS`` of
    the ring's capacity, at most ``MAX_SPLITS``."""
    return max(1, min(MAX_SPLITS, -(-valid_c // BLOCK_SLOTS)))


def pack_pred(pred) -> Tuple[torch.Tensor, torch.Tensor]:
    """QueryPred -> (Q, 8) float32 + (Q, 8) int32 arrays for the kernel."""
    zf = torch.zeros_like(pred.lat0, dtype=torch.float32)
    pred_f = torch.stack([pred.lat0, pred.lat1, pred.lon0, pred.lon1,
                          pred.t0, pred.t1, zf, zf], dim=-1).to(torch.float32)
    zi = torch.zeros_like(pred.sid_hi, dtype=torch.int32)
    pred_i = torch.stack([pred.sid_hi.to(torch.int32),
                          pred.sid_lo.to(torch.int32),
                          pred.has_spatial.to(torch.int32),
                          pred.has_temporal.to(torch.int32),
                          pred.has_sid.to(torch.int32),
                          pred.is_and.to(torch.int32), zi, zi], dim=-1)
    return pred_f, pred_i


def st_scan(tup_f, tup_sid, tup_count, pred, sublists, sublist_len,
            channels: Tuple[int, ...] = (0,),
            valid_c: Optional[int] = None):
    """Per-edge predicate scan + fused multi-channel aggregation."""
    e, w, c = tup_f.shape
    value_rows = check_channels(channels, w)
    if not tup_f.is_cuda:
        return st_scan_ref(tup_f, tup_sid, tup_count, pred, sublists,
                           sublist_len, channels=channels, valid_c=valid_c)
    return st_scan_cuda(tup_f, tup_sid, tup_count, pred, sublists,
                        sublist_len, value_rows,
                        c if valid_c is None else min(valid_c, c))


def st_scan_cuda(tup_f, tup_sid, tup_count, pred, sublists, sublist_len,
                 value_rows: Tuple[int, ...], valid_c: int):
    """Launch the kernel (CUDA tensors only); ``value_rows`` are log rows
    ``3 + channel``, ``valid_c`` is already clamped to C."""
    global launches
    dev = tup_f.device
    e, w, c = tup_f.shape
    q, _, l, _ = sublists.shape
    for name, t, dt, shape in (("tup_f", tup_f, torch.float32, (e, w, c)),
                               ("tup_sid", tup_sid, torch.int32, (e, 2, c))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} {shape} "
                             f"tensor on {dev}")
    if sublists.shape[:2] != (q, e) or tuple(sublist_len.shape) != (q, e):
        raise ValueError(f"sublists {tuple(sublists.shape)} / sublist_len "
                         f"{tuple(sublist_len.shape)} do not match Q={q}, E={e}")
    k_total = len(value_rows)
    count = torch.empty((q, e), dtype=torch.int32, device=dev)
    vsum = torch.empty((q, k_total, e), dtype=torch.float32, device=dev)
    vmin = torch.empty_like(vsum)
    vmax = torch.empty_like(vsum)
    if q == 0 or e == 0:
        return count, vsum, vmin, vmax
    pred_f, pred_i = pack_pred(pred)
    pred_f = pred_f.to(dev).contiguous()
    pred_i = pred_i.to(dev).contiguous()
    subl = sublists.to(device=dev, dtype=torch.int32).contiguous()
    slen = sublist_len.to(device=dev, dtype=torch.int32).contiguous()
    cnt = tup_count.to(device=dev, dtype=torch.int32).contiguous()
    splits = scan_splits(valid_c)
    fn = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for k_off in range(0, k_total, MAX_K):
        rows = list(value_rows[k_off:k_off + MAX_K])
        rows += [0] * (MAX_K - len(rows))
        err = fn(tup_f.data_ptr(), tup_sid.data_ptr(), cnt.data_ptr(),
                 pred_f.data_ptr(), pred_i.data_ptr(), subl.data_ptr(),
                 slen.data_ptr(), e, w, c, q, l, valid_c,
                 min(MAX_K, k_total - k_off), *rows,
                 count.data_ptr(), vsum.data_ptr(), vmin.data_ptr(),
                 vmax.data_ptr(), k_total, k_off, splits, stream)
        build.check("st_scan", err)
        launches += 1
    return count, vsum, vmin, vmax
