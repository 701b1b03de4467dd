"""Shared model layers: norms, rotary embeddings, MLPs, embeddings.

Port of ``repro.models.layers``. Parameters are plain nested dicts of
tensors, leaf for leaf the JAX package's tree, so weights convert by copying
leaves (``repro_torch.convert.params_from_numpy``). Compute runs in
``cfg.compute_dtype``; parameters live in ``cfg.param_dtype`` and are cast
at use, as the JAX package does with ``.astype``. Initialisers draw from an
explicit ``torch.Generator`` (they give other numbers than ``jax.random``
from the same seed; tests convert the JAX package's weights instead).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def init_rms(gen: torch.Generator, d: int, dtype: torch.dtype):
    return torch.ones((d,), dtype=dtype, device=gen.device)


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype, in_axis=0):
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w / math.sqrt(shape[in_axis])).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(dh: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=device) / dh))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, dh); positions: (..., S) int32. Half-split rotation."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                   # (dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, f: int, dtype: torch.dtype):
    return {"wi": dense_init(gen, (d, f), dtype),
            "wg": dense_init(gen, (d, f), dtype),
            "wo": dense_init(gen, (f, d), dtype, in_axis=0)}


def mlp_apply(p, x: torch.Tensor, compute_dtype: torch.dtype):
    h = x @ p["wi"].to(compute_dtype)
    g = x @ p["wg"].to(compute_dtype)
    h = F.silu(g) * h
    return h @ p["wo"].to(compute_dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype):
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return {"tok": (w * 0.02).to(dtype)}


def embed_apply(p, tokens: torch.Tensor, compute_dtype: torch.dtype):
    # Gather, then cast: the same bits as casting the table first (the cast
    # is elementwise), without converting the whole table on every call.
    # ``F.embedding`` gathers the rows ``p["tok"][tokens]`` does; its
    # gradient sums a token's rows in a fixed order on either device (the
    # indexing gradient accumulates in threads on the CPU).
    return F.embedding(tokens, p["tok"]).to(compute_dtype)
