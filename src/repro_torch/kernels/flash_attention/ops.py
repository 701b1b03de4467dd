"""Wrapper of the ``flash_attention`` CUDA kernel (``csrc/flash_attention.cu``).

``flash_attention(q, k, v, *, causal, q_offset=0, chunk_kv=1024)``:
FlashAttention-2 forward over the model's own layout, q (B, Sq, H, d) and
k, v (B, Skv, KV, d). CPU tensors take the plain version (``ref.py``,
chunked by ``chunk_kv``); CUDA tensors launch the kernel, which adds one to
``launches`` per launch. The kernel reads its inputs through their strides,
so a slice of the KV cache is passed as it lies; it takes bf16 and fp32 and
d in ``HEAD_DIMS``, and the wrapper raises on anything else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

launches = 0
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_Q_TILES = 65535          # the grid's y extent


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0,
                    chunk_kv: int = 1024) -> torch.Tensor:
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   chunk_kv=chunk_kv)
    return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int) -> None:
    dev = q.device
    if not q.is_cuda or k.device != dev or v.device != dev:
        raise ValueError("flash_attention_cuda takes CUDA tensors on one device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, Sq, H, d) and k, v (B, Skv, KV, d) expected, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "on batch or head dim, or H % KV != 0")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel "
                         "takes one of float32 and bfloat16 for all three")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if sq < 1 or k.shape[1] < 1 or q_offset < 0 or sq > MAX_Q_TILES * 8:
        raise ValueError(f"Sq={sq}, Skv={k.shape[1]}, q_offset={q_offset}: "
                         "need Sq, Skv >= 1, q_offset >= 0 and Sq <= "
                         f"{MAX_Q_TILES * 8}")
    vec = 16 // q.element_size()        # the bf16 kernel loads 16 bytes
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(s % vec for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name}: head dim must be contiguous, the other "
                             f"strides multiples of {vec} elements and the "
                             "data 16-byte aligned")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Launch the kernel (CUDA tensors only)."""
    global launches
    q_offset = int(q_offset)
    _check(q, k, v, q_offset)
    b, sq, h, dh = q.shape
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 int(q.dtype == torch.bfloat16), dh, b, h, k.shape[2], sq,
                 k.shape[1], strides, int(causal), q_offset, dh ** -0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention", err)
    launches += 1
    return out
