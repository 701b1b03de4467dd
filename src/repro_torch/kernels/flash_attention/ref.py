"""Plain PyTorch version of the flash_attention kernel.

The same chunked online softmax as the Pallas kernel and the CUDA kernels
(``csrc/flash_attention*.cu``): scores ``(q . k^T) * d^-0.5`` in fp32,
causal positions masked to ``NEG_INF = -1e30`` where
``q_offset + q_row < k_col``, running max / sum / accumulator in fp32,
``p`` cast to v's dtype before the PV product, output
``acc / max(l, 1e-30)`` cast to q's dtype. Keys go in chunks of
``chunk_kv`` (the last one may be short); a causal call stops after the
chunk holding key ``q_offset + Sq - 1``, since later chunks add exactly 0.

Layout (B, S, H, d) for q and (B, S, KV, d) for k and v, H % KV == 0: query
head h reads kv head h // (H // KV). The CPU path of
``repro_torch.models.attention.flash_attention`` runs this; on the card it
is only the yardstick the kernels are held against.

``flash_decode_split_ref`` is the plain version of the split-KV decode
kernel (``csrc/flash_attention_decode.cu``) for Sq == 1: the populated
prefix cut into ``n_split`` contiguous ranges (``decode_partition``), each
range an online softmax over tiles of ``DECODE_TILE`` keys, and the
ranges' partial (m, l, acc) merged in rank order. The CPU tests hold it to
``flash_attention_ref`` and to the JAX package; it is not on any path.

``flash_attention_bwd_ref`` is the plain version of the backward kernel
(``csrc/flash_attention_bwd.cu``): the gradient of the function above with
respect to q, k and v, by the FlashAttention-2 backward formula. It
recomputes the row statistics (``LSE = logsumexp`` of the masked scores),
forms ``D = rowsum(dO * O)`` with O as the forward stored it, and then
``P = exp(S - LSE)``, ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P * (dP -
D)``, ``dQ = scale * dS K``, ``dK = scale * dS^T Q``, dK and dV summed over
the GQA group's query heads. Arithmetic in fp32 (float64 inputs in
float64), outputs in the inputs' dtype. Query rows go in chunks of
``chunk_q``, so no score matrix larger than ``chunk_q`` x Skv a head is
held. On the CPU it is the autograd backward of ``flash_attention``.
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


DECODE_TILE = 32        # keys a tile of the decode kernel (four mma n-tiles)


def decode_partition(n_keys: int, n_split: int) -> list[tuple[int, int]]:
    """The key ranges [k0, k1) of the ``n_split`` splits of a prefix of
    ``n_keys`` keys: ceil(n_keys / n_split) keys each, the last ones short
    or empty."""
    per = -(-n_keys // n_split)
    return [(min(r * per, n_keys), min(r * per + per, n_keys))
            for r in range(n_split)]


def flash_decode_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool, q_offset: int,
                           n_split: int) -> torch.Tensor:
    b, sq, h, dh = q.shape
    if sq != 1:
        raise ValueError(f"flash_decode_split_ref takes Sq == 1, got {sq}")
    skv, kv = k.shape[1], k.shape[2]
    g, dv = h // kv, v.shape[-1]
    f32 = torch.float32
    qr = q.reshape(b, kv, g, dh).to(f32)
    scale = dh ** -0.5
    n_keys = min(skv, q_offset + 1) if causal else skv

    def empty():
        return (torch.full((b, kv, g), NEG_INF, dtype=f32, device=q.device),
                torch.zeros((b, kv, g), dtype=f32, device=q.device),
                torch.zeros((b, kv, g, dv), dtype=f32, device=q.device))

    m, l, acc = empty()
    for k0, k1 in decode_partition(n_keys, n_split):
        ms, ls, accs = empty()
        for c0 in range(k0, k1, DECODE_TILE):
            c1 = min(c0 + DECODE_TILE, k1)
            s = torch.einsum("bkgd,bckd->bkgc", qr, k[:, c0:c1].to(f32)) * scale
            m_new = torch.maximum(ms, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(ms - m_new)
            ls = ls * corr + p.sum(dim=-1)
            accs = accs * corr[..., None] + torch.einsum(
                "bkgc,bckd->bkgd", p.to(v.dtype).to(f32), v[:, c0:c1].to(f32))
            ms = m_new
        m_new = torch.maximum(m, ms)
        c_old, c_new = torch.exp(m - m_new), torch.exp(ms - m_new)
        l = l * c_old + ls * c_new
        acc = acc * c_old[..., None] + accs * c_new[..., None]
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype).reshape(b, 1, h, dv)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, do: torch.Tensor, *,
                            causal: bool, q_offset: int = 0,
                            chunk_q: int = 1024
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g, dv_ = h // kv, v.shape[-1]
    ct = torch.promote_types(q.dtype, torch.float32)
    scale = dh ** -0.5
    kf, vf = k.to(ct), v.to(ct)
    dk = torch.zeros((b, skv, kv, dh), dtype=ct, device=q.device)
    dv = torch.zeros((b, skv, kv, dv_), dtype=ct, device=q.device)
    dq = torch.empty((b, sq, kv, g, dh), dtype=ct, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    for r0 in range(0, sq, chunk_q):
        r1 = min(r0 + chunk_q, sq)
        qc = q[:, r0:r1].reshape(b, r1 - r0, kv, g, dh).to(ct)
        doc = do[:, r0:r1].reshape(b, r1 - r0, kv, g, dv_).to(ct)
        oc = o[:, r0:r1].reshape(b, r1 - r0, kv, g, dv_).to(ct)
        s = torch.einsum("bqkgd,bckd->bqkgc", qc, kf) * scale
        if causal:
            q_pos = q_offset + torch.arange(r0, r1, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]               # (rows, Skv)
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None])
        d_row = (doc * oc).sum(dim=-1)
        dv += torch.einsum("bqkgc,bqkgd->bckd", p, doc)
        dp = torch.einsum("bqkgd,bckd->bqkgc", doc, vf)
        ds = p * (dp - d_row[..., None])
        dq[:, r0:r1] = torch.einsum("bqkgc,bckd->bqkgd", ds, kf) * scale
        dk += torch.einsum("bqkgc,bqkgd->bckd", ds, qc) * scale
    return (dq.reshape(b, sq, h, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
