"""Attention: GQA (+qk-norm, RoPE) over the flash_attention kernel.

Port of ``repro.models.attention``. ``flash_attention(q, k, v, *, causal,
q_offset=0, chunk_kv=1024)`` is the kernel wrapper
(``kernels/flash_attention/ops.py``) under the JAX package's name,
signature and (B, S, H, d) layout: CPU tensors run the plain chunked online
softmax (``ref.py``, chunked by ``chunk_kv``), CUDA tensors one of the
hand-written kernels (``csrc/flash_attention*.cu``, chosen by shape and
dtype), or the call raises. ``q_offset`` is the absolute position of q[0]
(decode: the cache position). The JAX package computes decode (Sq == 1)
with ``naive_attention``; here it goes through the split-KV decode kernel
(``csrc/flash_attention_decode.cu``), which computes the same function. ``naive_attention`` is the oracle. MLA and the mesh-only K/V gather are not
ported (ROADMAP Queue 1, LM scaffold item 10.3).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models import layers
from repro_torch.models.layers import apply_rope, rms_norm


def naive_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """Reference O(S^2)-memory attention (oracle for flash and the kernel)."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    qr = q.reshape(b, sq, kv, h // kv, dh)
    s = torch.einsum("bqkgd,bckd->bqkgc", qr, k) * dh ** -0.5
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        mask = q_pos[:, None] >= torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s.to(torch.float32), dim=-1).to(v.dtype)
    return torch.einsum("bqkgc,bckd->bqkgd", p, v).reshape(b, sq, h, v.shape[-1])


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def init_gqa(gen: torch.Generator, cfg):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    pd = cfg.param_dtype
    p = {"wq": layers.dense_init(gen, (d, h * dh), pd),
         "wk": layers.dense_init(gen, (d, kv * dh), pd),
         "wv": layers.dense_init(gen, (d, kv * dh), pd),
         "wo": layers.dense_init(gen, (h * dh, d), pd)}
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rms(gen, dh, pd)
        p["k_norm"] = layers.init_rms(gen, dh, pd)
    return p


def gqa_project_qkv(p, x, cfg, positions):
    """x: (B, S, D) -> q (B,S,H,dh), k/v (B,S,KV,dh) with rope applied."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    cd = cfg.compute_dtype
    q = (x @ p["wq"].to(cd)).reshape(b, s, h, dh)
    k = (x @ p["wk"].to(cd)).reshape(b, s, kv, dh)
    v = (x @ p["wv"].to(cd)).reshape(b, s, kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_apply(p, x, cfg, positions, *, causal=True):
    """Full-sequence GQA: project, attend, output projection."""
    b, s, _ = x.shape
    q, k, v = gqa_project_qkv(p, x, cfg, positions)
    out = flash_attention(q, k, v, causal=causal, chunk_kv=cfg.attn_chunk_kv)
    return out.reshape(b, s, -1) @ p["wo"].to(cfg.compute_dtype)
