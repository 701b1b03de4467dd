"""Plain PyTorch version of the flash_attention kernel.

The same chunked online softmax as the Pallas kernel and the CUDA kernel
(``csrc/flash_attention.cu``): scores ``(q . k^T) * d^-0.5`` in fp32,
causal positions masked to ``NEG_INF = -1e30`` where
``q_offset + q_row < k_col``, running max / sum / accumulator in fp32,
``p`` cast to v's dtype before the PV product, output
``acc / max(l, 1e-30)`` cast to q's dtype. Keys go in chunks of
``chunk_kv`` (the last one may be short); a causal call stops after the
chunk holding key ``q_offset + Sq - 1``, since later chunks add exactly 0.

Layout (B, S, H, d) for q and (B, S, KV, d) for k and v, H % KV == 0: query
head h reads kv head h // (H // KV). The CPU path of
``repro_torch.models.attention.flash_attention`` runs this; on the card it
is only the yardstick the kernel is held against.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, q_offset: int = 0,
                        chunk_kv: int = 1024) -> torch.Tensor:
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    f32 = torch.float32
    qr = q.reshape(b, sq, kv, g, dh).to(f32)
    scale = dh ** -0.5
    q_pos = q_offset + torch.arange(sq, device=q.device)
    end = min(skv, q_offset + sq) if causal else skv

    m = torch.full((b, sq, kv, g), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, sq, kv, g), dtype=f32, device=q.device)
    acc = torch.zeros((b, sq, kv, g, v.shape[-1]), dtype=f32, device=q.device)
    for c0 in range(0, end, chunk_kv):
        c1 = min(c0 + chunk_kv, skv)
        s = torch.einsum("bqkgd,bckd->bqkgc", qr, k[:, c0:c1].to(f32)) * scale
        if causal:
            k_pos = torch.arange(c0, c1, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]               # (Sq, c)
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bqkgc,bckd->bqkgd", p.to(v.dtype).to(f32),
                          v[:, c0:c1].to(f32))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype).reshape(b, sq, h, v.shape[-1])
