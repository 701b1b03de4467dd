"""Attention: GQA (+qk-norm, RoPE) and MLA over the flash_attention kernel.

Port of ``repro.models.attention``. ``flash_attention(q, k, v, *, causal,
q_offset=0, chunk_kv=1024)`` is the kernel wrapper
(``kernels/flash_attention/ops.py``) under the JAX package's name,
signature and (B, S, H, d) layout: CPU tensors run the plain chunked online
softmax (``ref.py``, chunked by ``chunk_kv``), CUDA tensors one of the
hand-written kernels (``csrc/flash_attention*.cu``, chosen by shape and
dtype), or the call raises. ``q_offset`` is the absolute position of q[0]
(decode: the cache position). The JAX package computes decode (Sq == 1)
with ``naive_attention``; here it goes through the split-KV decode kernel
(``csrc/flash_attention_decode.cu``), which computes the same function. ``naive_attention`` is the oracle. The mesh-only K/V gather is not
ported (ROADMAP Queue 1, LM scaffold item 10.3).

MLA (DeepSeek-V2): ``mla_latent`` compresses x into the latent cache,
``c_kv`` (B, S, kv_lora) and a shared rope key ``k_rope`` (B, S, 1, rope);
``mla_attend`` expands it to per-head K (nope + rope columns) and V
(``mla_v_dim``) and attends through ``flash_attention`` with q/k and v of
unequal head dims (deepseek-v2-236b: 192 and 128), v passed as the strided
view of the expansion it is; ``mla_decode_absorbed`` is the serving form:
``wkv_b``'s K half absorbed into the query and its V half applied after
the context, so the decode attends in the latent space over the whole
cache (``arange(smax) <= pos``) with torch ops and launches no flash
kernel, as the reference computes it outside any Pallas kernel.
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent-compressed K/V with a decoupled rope key
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg):
    d, h = cfg.d_model, cfg.n_heads
    nope, rph, vdim = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    kvl, pd = cfg.kv_lora, cfg.param_dtype
    return {"wq": layers.dense_init(gen, (d, h * (nope + rph)), pd),
            "wkv_a": layers.dense_init(gen, (d, kvl + rph), pd),
            "kv_norm": layers.init_rms(gen, kvl, pd),
            "wkv_b": layers.dense_init(gen, (kvl, h * (nope + vdim)), pd),
            "wo": layers.dense_init(gen, (h * vdim, d), pd)}


def mla_latent(p, x, cfg, positions):
    """Compress x into the MLA latent cache: (c_kv (B,S,kvl), k_rope (B,S,1,rph))."""
    kvl = cfg.kv_lora
    a = x @ p["wkv_a"].to(cfg.compute_dtype)
    c_kv = rms_norm(a[..., :kvl], p["kv_norm"])
    k_rope = apply_rope(a[..., kvl:][..., None, :], positions, cfg.rope_theta)
    return c_kv, k_rope


def _mla_query(p, x, cfg, positions):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rph)) with rope applied."""
    b, s, _ = x.shape
    nope, rph = cfg.mla_nope_dim, cfg.mla_rope_dim
    q = (x @ p["wq"].to(cfg.compute_dtype)).reshape(b, s, cfg.n_heads, nope + rph)
    return q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)


def mla_attend(p, x, cfg, positions, c_kv, k_rope, *, causal=True, q_offset=0):
    """Attention over the latent cache (expanded per-head K/V)."""
    b, s, _ = x.shape
    cd, h = cfg.compute_dtype, cfg.n_heads
    nope, rph, vdim = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    q_nope, q_rope = _mla_query(p, x, cfg, positions)
    skv = c_kv.shape[1]
    kvb = (c_kv @ p["wkv_b"].to(cd)).reshape(b, skv, h, nope + vdim)
    k_nope, v = kvb[..., :nope], kvb[..., nope:]
    k = torch.cat([k_nope, k_rope.expand(b, skv, h, rph)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    out = flash_attention(qf, k, v, causal=causal, q_offset=q_offset,
                          chunk_kv=cfg.attn_chunk_kv)
    return out.reshape(b, s, -1) @ p["wo"].to(cd)


def mla_apply(p, x, cfg, positions, *, causal=True):
    c_kv, k_rope = mla_latent(p, x, cfg, positions)
    return mla_attend(p, x, cfg, positions, c_kv, k_rope, causal=causal)


def mla_decode_absorbed(p, x, cfg, positions, c_kv, k_rope, pos: int):
    """Decode-time MLA with the w_kv_b absorption trick (DeepSeek-V2 §2.1.2
    serving form): attention runs in the latent space, so the cache stays
    (S, kv_lora + rope_dim) and is never expanded to per-head K/V.

    x: (B, 1, D); c_kv: (B, S, kvl); k_rope: (B, S, 1, rph); pos: int.
    """
    b, s1, _ = x.shape
    cd, h = cfg.compute_dtype, cfg.n_heads
    nope, rph, vdim = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    smax = c_kv.shape[1]
    q_nope, q_rope = _mla_query(p, x, cfg, positions)
    wkv_b = p["wkv_b"].to(cd).reshape(cfg.kv_lora, h, nope + vdim)
    wk_b, wv_b = wkv_b[..., :nope], wkv_b[..., nope:]
    # absorb K expansion into the query
    q_lat = torch.einsum("bshn,lhn->bshl", q_nope, wk_b)            # (B,1,H,kvl)
    scores = (torch.einsum("bshl,btl->bhst", q_lat, c_kv) +
              torch.einsum("bshr,btr->bhst", q_rope, k_rope[:, :, 0, :]))
    scores = scores * (nope + rph) ** -0.5
    mask = torch.arange(smax, device=x.device)[None, None, None, :] <= pos
    scores = torch.where(mask, scores, NEG_INF)
    attn = torch.softmax(scores.to(torch.float32), dim=-1).to(cd)
    ctx_lat = torch.einsum("bhst,btl->bshl", attn, c_kv)             # (B,1,H,kvl)
    out = torch.einsum("bshl,lhv->bshv", ctx_lat, wv_b)              # (B,1,H,v)
    return out.reshape(b, s1, h * vdim) @ p["wo"].to(cd)
