"""Wrapper of the ``flash_attention`` CUDA kernels.

``flash_attention(q, k, v, *, causal, q_offset=0, chunk_kv=1024)``:
FlashAttention-2 forward over the model's own layout, q (B, Sq, H, d_qk),
k (B, Skv, KV, d_qk) and v (B, Skv, KV, d_v), giving (B, Sq, H, d_v).
CPU tensors take the plain version (``ref.py``, chunked by ``chunk_kv``);
CUDA tensors launch a kernel, which adds one to ``launches`` and to
``launches_by_variant[variant]`` per launch. The kernels read their inputs
through their strides, so a slice of the KV cache (or MLA's v, a strided
view of its K/V expansion) is passed as it lies; they take bf16 and fp32
with d_qk == d_v in ``HEAD_DIMS`` or a (d_qk, d_v) pair of
``MLA_HEAD_DIMS``, and the wrapper raises on anything else. The scale is
d_qk ** -0.5.

Three kernels, chosen by shape and dtype alone (``_variant``), never on a
failure:

- ``"sm90"`` (``csrc/flash_attention_sm90.cu``): wgmma fed by a TMA K/V
  ring, for bf16 with d in ``SM90_HEAD_DIMS`` (64, 128 and 160) or (d_qk,
  d_v) in ``SM90_MLA_KEYS`` (deepseek-v2-236b's (192, 128)) and Sq >= 64
  (the prefill; zamba2-1.2b's shared block at d 64);
- ``"decode"`` (``csrc/flash_attention_decode.cu``): split-KV decoding for
  bf16 with Sq == 1 and a GQA group H / KV of at most 16 (every decode
  step); one one-warp block per (batch, kv head, key split) with the
  group's query heads as its rows, the ``decode_splits`` splits of a kv
  head merged in a fixed order inside a thread-block cluster;
- ``"mma_sync"`` (``csrc/flash_attention.cu``): every other shape (fp32,
  bf16 d 32 at Sq > 1, bf16 with 1 < Sq < 64, Sq 1 with a group over 16,
  and every MLA pair the sm90 kernel does not take: (48, 32), and (192,
  128) in fp32 or with Sq < 64). MLA's decode attends in the latent space
  with torch ops and launches no flash kernel (``models/attention.py``).

``flash_attention_cuda(..., variant=...)`` forces one of them, for tests
and timing only; forcing ``"sm90"`` or ``"decode"`` on a shape it does not
take raises.

Under grad (grad enabled and any input requiring it, on either device)
``flash_attention`` goes through ``FlashAttentionFn``, a
``torch.autograd.Function`` that saves q, k, v and the output. Its
backward calls ``flash_attention_bwd_cuda`` on CUDA tensors and runs its
plain version (``ref.flash_attention_bwd_ref``) on CPU tensors. A CUDA call
under grad therefore never returns an output cut off from the graph, and a
failure to build or launch raises. Under ``no_grad`` the wrapper takes the
forward path above, with its launch counts, and builds no graph.

Two backward kernels, each two launches a call (the dq pass, then the
dk/dv pass), chosen by shape and dtype alone (``_bwd_variant``):

- ``"sm90"`` (``csrc/flash_attention_bwd_sm90.cu``): wgmma fed by TMA, for
  bf16 with (d_qk, d_v) in ``SM90_BWD_HEAD_DIMS`` and at least
  ``SM90_BWD_MIN_LEN`` (64) query rows and keys: (128, 128), every
  training call of internlm2-1.8b, and MLA's (192, 128), every training
  call of deepseek-v2-236b;
- ``"mma_sync"`` (``csrc/flash_attention_bwd.cu``): every other shape
  (fp32, d 32, 64 and 160, shorter calls), and MLA's pairs of
  ``MLA_HEAD_DIMS`` the sm90 kernel does not take: (192, 128) in fp32 or
  with fewer than 64 query rows or keys, and (48, 32) (deepseek-v2's smoke
  config).

At an MLA pair dq is d_qk wide, dk d_qk and dv d_v, o and do d_v.

``flash_attention_bwd_cuda(..., variant=...)`` forces one, for tests and
timing only; forcing ``"sm90"`` on a shape it lacks raises. A call adds one
to ``launches_by_variant["bwd"]`` and to
``bwd_launches_by_variant[variant]``; ``launches`` counts forward launches
only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

VARIANTS = ("sm90", "decode", "mma_sync")
launches = 0
launches_by_variant = dict.fromkeys(VARIANTS + ("bwd",), 0)
HEAD_DIMS = (32, 64, 128, 160)
DTYPES = (torch.float32, torch.bfloat16)
MAX_Q_TILES = 65535          # the grid's y extent
SM90_HEAD_DIMS = (64, 128, 160)
# Keys a K/V tile of the sm90 kernel (and its probe's k, v rows), by head
# dim: d 160 takes three 64-column slabs a row, so 64-key tiles fit; d 64's
# tile is the one timing chose (the kernel's D64_BK).
SM90_KEYS = {64: 128, 128: 128, 160: 64}
# The (d_qk, d_v) pairs of MLA (deepseek-v2-236b's q/k 192 = nope 128 +
# rope 64 and v 128; its smoke config's 48 and 32), every one on the
# mma_sync kernel; and those the sm90 kernel takes, with its keys a K/V
# tile: at (192, 128) a 128-key stage is K 48 KB + V 32 KB, so two stages
# and Q's 48 KB fit.
MLA_HEAD_DIMS = ((192, 128), (48, 32))
SM90_MLA_KEYS = {(192, 128): 128}
SM90_MIN_SQ = 64             # one warpgroup's rows
DECODE_MAX_GROUP = 16        # query heads a block's rows
DECODE_MAX_SPLITS = 8        # blocks of a cluster (the portable limit)
# One-warp blocks a decode launch aims for, about two an SM of the H100's
# 132. Over the serve shapes' 64 (batch, kv head) pairs, 4 splits timed
# best on the card at 192 and at 4096 keys, 3 to 8 within 13 %, 2 and 1
# far slower (PERF.md, H100 80GB HBM3 at 700 W).
DECODE_TARGET_BLOCKS = 256
BWD_VARIANTS = ("sm90", "mma_sync")
bwd_launches_by_variant = dict.fromkeys(BWD_VARIANTS, 0)
# The (d_qk, d_v) pairs of the sm90 backward: d 128 and MLA's (192, 128).
SM90_BWD_HEAD_DIMS = ((128, 128), (192, 128))
# The sm90 backward's least query rows and keys: one warpgroup's 64 rows
# and one streamed 64-key tile. Shorter calls would be mostly TMA's zero
# fill, so they stay on the mma_sync kernel.
SM90_BWD_MIN_LEN = 64
SM90_BWD_BLOCK_ROWS = 128    # a dq block's query rows; the scratch rows' padding


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p] + [ctypes.c_int] * 8 + [
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _sm90_lib():
    lib = build.load("flash_attention_sm90")
    lib.flash_attention_sm90_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    lib.flash_attention_sm90_probe.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    lib.flash_attention_sm90_launch.restype = ctypes.c_int
    lib.flash_attention_sm90_probe.restype = ctypes.c_int
    return lib


@functools.cache
def _decode_fn():
    fn = build.load("flash_attention_decode").flash_attention_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_longlong] * 10 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_splits(b: int, kv: int, n_keys: int) -> int:
    """Key splits of a decode launch: enough that the ``b * kv * n_split``
    blocks reach ``DECODE_TARGET_BLOCKS``, at most ``DECODE_MAX_SPLITS``
    and no more than there are keys."""
    want = -(-DECODE_TARGET_BLOCKS // (b * kv))
    return max(1, min(DECODE_MAX_SPLITS, want, n_keys))


@functools.cache
def _bwd_fn():
    fn = build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_sm90_fn():
    fn = build.load("flash_attention_bwd_sm90").flash_attention_bwd_sm90_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _forward(q, k, v, causal: bool, q_offset: int, chunk_kv: int):
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   chunk_kv=chunk_kv)
    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel (or its plain version on the CPU) with the
    backward kernel (or ``flash_attention_bwd_ref``) as its gradient. Saves
    only tensors; ``causal``, ``q_offset`` and ``chunk_kv`` are constants of
    the call, so a remat recompute sees the same ones."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int, chunk_kv: int):
        o = _forward(q, k, v, causal, q_offset, chunk_kv)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        bwd = flash_attention_bwd_cuda if q.is_cuda else flash_attention_bwd_ref
        dq, dk, dv = bwd(q, k, v, o, do, causal=ctx.causal,
                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0,
                    chunk_kv: int = 1024) -> torch.Tensor:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, int(q_offset), chunk_kv)
    return _forward(q, k, v, causal, q_offset, chunk_kv)


def _variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel for these inputs, from their shapes and dtype only:
    ``"decode"`` for bf16 with Sq == 1, d_qk == d_v in ``HEAD_DIMS`` and H
    / KV <= ``DECODE_MAX_GROUP``; ``"sm90"`` for bf16 with Sq >= 64 and d
    in ``SM90_HEAD_DIMS`` or (d_qk, d_v) in ``SM90_MLA_KEYS``; else
    ``"mma_sync"``."""
    dk, dv = q.shape[-1], v.shape[-1]
    if q.dtype == k.dtype == v.dtype == torch.bfloat16:
        if (dk == dv and q.shape[1] == 1 and dk in HEAD_DIMS
                and q.shape[2] // k.shape[2] <= DECODE_MAX_GROUP):
            return "decode"
        sm90 = dk in SM90_HEAD_DIMS if dk == dv else (dk, dv) in SM90_MLA_KEYS
        if sm90 and q.shape[1] >= SM90_MIN_SQ:
            return "sm90"
    return "mma_sync"


def resolve_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    variant: str | None = None) -> str:
    """``_variant(q, k, v)``, or the forced ``variant`` where that kernel
    takes these inputs; raises ``ValueError`` otherwise."""
    chosen = _variant(q, k, v)
    if variant is None:
        return chosen
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if variant == "sm90" and chosen != "sm90":
        raise ValueError(
            f"the sm90 kernel takes bf16 with d in {SM90_HEAD_DIMS} or (d_qk, "
            f"d_v) in {tuple(SM90_MLA_KEYS)} and Sq >= {SM90_MIN_SQ}; got "
            f"{q.dtype}, q {tuple(q.shape)}, v {tuple(v.shape)}")
    if variant == "decode" and chosen != "decode":
        raise ValueError(
            f"the decode kernel takes bf16 with Sq == 1, d_qk == d_v in "
            f"{HEAD_DIMS} and H / KV <= {DECODE_MAX_GROUP}; got {q.dtype}, q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    return variant


def _bwd_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The backward kernel for these inputs, from their shapes and dtype
    only: ``"sm90"`` for bf16 with (d_qk, d_v) in ``SM90_BWD_HEAD_DIMS``
    and Sq, Skv >= ``SM90_BWD_MIN_LEN``; else ``"mma_sync"``."""
    if q.dtype == k.dtype == v.dtype == torch.bfloat16 \
            and (q.shape[-1], v.shape[-1]) in SM90_BWD_HEAD_DIMS \
            and q.shape[1] >= SM90_BWD_MIN_LEN and k.shape[1] >= SM90_BWD_MIN_LEN:
        return "sm90"
    return "mma_sync"


def resolve_bwd_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        variant: str | None = None) -> str:
    """``_bwd_variant(q, k, v)``, or the forced ``variant`` where that
    kernel takes these inputs; raises ``ValueError`` otherwise."""
    chosen = _bwd_variant(q, k, v)
    if variant is None:
        return chosen
    if variant not in BWD_VARIANTS:
        raise ValueError(f"backward variant {variant!r} not in {BWD_VARIANTS}")
    if variant == "sm90" and chosen != "sm90":
        raise ValueError(
            f"the sm90 backward takes bf16 with (d_qk, d_v) in "
            f"{SM90_BWD_HEAD_DIMS} and Sq, Skv >= {SM90_BWD_MIN_LEN}; got "
            f"{q.dtype}, q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}")
    return variant


def tma_map_geometry(x: torch.Tensor) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The TMA tensor map of a (B, S, heads, d) tensor: its dims innermost
    first, (d, S, heads, B), and the byte strides of the outer three,
    (seq, heads, batch). The head dim is contiguous (its stride is
    implicit)."""
    b, s, n, d = x.shape
    es = x.element_size()
    return (d, s, n, b), (x.stride(1) * es, x.stride(2) * es, x.stride(0) * es)


def _geometry(*xs: torch.Tensor) -> list:
    out = []
    for x in xs:
        dims, strides = tma_map_geometry(x)
        out += [*dims, *strides]
    return out


def head_dims_supported(d_qk: int, d_v: int) -> bool:
    """Whether a forward kernel takes q/k heads of ``d_qk`` and v heads of
    ``d_v``: equal dims in ``HEAD_DIMS``, or a pair of ``MLA_HEAD_DIMS``."""
    return d_qk in HEAD_DIMS if d_qk == d_v else (d_qk, d_v) in MLA_HEAD_DIMS


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int) -> None:
    dev = q.device
    if not q.is_cuda or k.device != dev or v.device != dev:
        raise ValueError("flash_attention_cuda takes CUDA tensors on one device")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"q (B, Sq, H, d_qk), k (B, Skv, KV, d_qk) and v (B, "
                         f"Skv, KV, d_v) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "on batch or head dim, or H % KV != 0")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel "
                         "takes one of float32 and bfloat16 for all three")
    if not head_dims_supported(dh, v.shape[3]):
        raise ValueError(f"head dims (q/k {dh}, v {v.shape[3]}): no kernel "
                         f"takes them (equal dims in {HEAD_DIMS}, or (d_qk, "
                         f"d_v) in {MLA_HEAD_DIMS})")
    if sq < 1 or k.shape[1] < 1 or q_offset < 0 or sq > MAX_Q_TILES * 8:
        raise ValueError(f"Sq={sq}, Skv={k.shape[1]}, q_offset={q_offset}: "
                         "need Sq, Skv >= 1, q_offset >= 0 and Sq <= "
                         f"{MAX_Q_TILES * 8}")
    vec = 16 // q.element_size()        # 16-byte loads and TMA strides
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(s % vec for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name}: head dim must be contiguous, the other "
                             f"strides multiples of {vec} elements and the "
                             "data 16-byte aligned")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool, q_offset: int = 0,
                         variant: str | None = None) -> torch.Tensor:
    """Launch the kernel ``_variant`` names, or the forced ``variant``
    (CUDA tensors only)."""
    global launches
    q_offset = int(q_offset)
    _check(q, k, v, q_offset)
    variant = resolve_variant(q, k, v, variant)
    b, sq, h, dh = q.shape
    dv = v.shape[3]
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if variant == "sm90":
        geo = (ctypes.c_longlong * 24)(*_geometry(q, k, v), *out.stride()[:3])
        err = _sm90_lib().flash_attention_sm90_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), geo,
            int(causal), q_offset, dh ** -0.5, stream)
        build.check("flash_attention_sm90", err)
    elif variant == "decode":
        _, skv, kv, _ = k.shape
        n_keys = min(skv, q_offset + 1) if causal else skv
        qs, ks, vs = q.stride(), k.stride(), v.stride()
        err = _decode_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dh, b, h,
            kv, n_keys, decode_splits(b, kv, n_keys), qs[0], qs[2], *ks[:3],
            *vs[:3], h * dh, dh, dh ** -0.5, stream)
        build.check("flash_attention_decode", err)
    else:
        strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                           *v.stride()[:3], *out.stride()[:3])
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     int(q.dtype == torch.bfloat16), dh, dv, b, h, k.shape[2],
                     sq, k.shape[1], strides, int(causal), q_offset,
                     dh ** -0.5, stream)
        build.check("flash_attention", err)
    launches += 1
    launches_by_variant[variant] += 1
    return out


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` where the kernels can read it through its strides (head dim
    contiguous, the other strides whole 16-byte vectors, the data 16-byte
    aligned), else a contiguous copy."""
    vec = 16 // x.element_size()
    if x.stride(3) == 1 and not any(s % vec for s in x.stride()[:3]) \
            and x.data_ptr() % 16 == 0:
        return x
    return x.contiguous()


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool,
                             q_offset: int = 0, variant: str | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel ``_bwd_variant`` names, or the forced
    ``variant`` (CUDA tensors only): (dq, dk, dv) of the forward's output
    ``o`` (B, Sq, H, d_v) given its gradient ``do``, in the inputs' dtype;
    dv has v's head dim. Two launches on the current stream, the dq pass
    (which also writes the row statistics) and then the dk/dv pass;
    ``launches_by_variant["bwd"]`` and ``bwd_launches_by_variant[variant]``
    grow by one."""
    q_offset = int(q_offset)
    _check(q, k, v, q_offset)
    b, sq, h, dh = q.shape
    skv, kv, d_v = k.shape[1], k.shape[2], v.shape[3]
    if o.shape != (b, sq, h, d_v) or do.shape != o.shape \
            or o.device != q.device or do.device != q.device:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"be (B, Sq, H, d_v) = {(b, sq, h, d_v)} on q's device")
    variant = resolve_bwd_variant(q, k, v, variant)
    o, do = _aligned(o.to(q.dtype)), _aligned(do.to(q.dtype))
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, skv, kv, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, skv, kv, d_v), dtype=q.dtype, device=q.device)
    # Scratch for the row statistics (LSE, D); the sm90 kernel's rows are
    # padded to whole dq blocks.
    rows = -(-sq // SM90_BWD_BLOCK_ROWS) * SM90_BWD_BLOCK_ROWS if variant == "sm90" else sq
    lse = torch.empty((b, h, rows), dtype=torch.float32, device=q.device)
    dsum = torch.empty((b, h, rows), dtype=torch.float32, device=q.device)
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    if variant == "sm90":
        geo = (ctypes.c_longlong * 43)(
            *_geometry(q, k, v, do),
            *(s for x in (o, do, dq, dk, dv) for s in x.stride()[:3]))
        err = _bwd_sm90_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), geo, int(causal), q_offset, rows,
            dh ** -0.5, stream)
        build.check("flash_attention_bwd_sm90", err)
    else:
        strides = (ctypes.c_longlong * 24)(*(s for x in (q, k, v, o, do, dq, dk, dv)
                                             for s in x.stride()[:3]))
        err = _bwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        lse.data_ptr(), dsum.data_ptr(),
                        int(q.dtype == torch.bfloat16), dh, d_v, b, h, kv, sq, skv,
                        strides, int(causal), q_offset, dh ** -0.5, stream)
        build.check("flash_attention_bwd", err)
    launches_by_variant["bwd"] += 1
    bwd_launches_by_variant[variant] += 1
    return dq, dk, dv


def sm90_probe(q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One warpgroup of the sm90 kernel's products, alone: S = q k^T and
    O = bf16(S) v in fp32, for bf16 CUDA q (64, d_qk), k (keys, d_qk) and v
    (keys, d_v), d_qk == d_v in ``SM90_HEAD_DIMS`` with keys
    ``SM90_KEYS[d]``, or (d_qk, d_v) in ``SM90_MLA_KEYS`` with keys its
    value, through the same TMA maps and shared-memory descriptors.
    Returns S (64, keys) and O (64, d_v). A check of the layouts, not on
    any path; it counts no launch."""
    dk = q.shape[-1] if q.dim() == 2 else None
    dv = v.shape[-1] if v.dim() == 2 else None
    keys = SM90_KEYS.get(dk) if dk == dv else SM90_MLA_KEYS.get((dk, dv))
    if not q.is_cuda or keys is None or q.shape != (64, dk) \
            or k.shape != (keys, dk) or v.shape != (keys, dv) \
            or {q.dtype, k.dtype, v.dtype} != {torch.bfloat16}:
        raise ValueError("sm90_probe takes bf16 CUDA q (64, d_qk), k (keys, "
                         "d_qk) and v (keys, d_v), (d, keys) in "
                         f"{sorted(SM90_KEYS.items())} or ((d_qk, d_v), keys) "
                         f"in {sorted(SM90_MLA_KEYS.items())}")
    q4, k4, v4 = (x.contiguous()[None, :, None, :] for x in (q, k, v))
    s = torch.empty((64, keys), dtype=torch.float32, device=q.device)
    o = torch.empty((64, dv), dtype=torch.float32, device=q.device)
    geo = (ctypes.c_longlong * 21)(*_geometry(q4, k4, v4))
    err = _sm90_lib().flash_attention_sm90_probe(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), s.data_ptr(),
        o.data_ptr(), geo, torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention_sm90", err)
    return s, o
