"""Mixture-of-Experts FFN: top-k routing, optional shared experts and the
GShard capacity dispatch in the reference's two modes (port of
``repro.models.moe``).

Both modes give every (token, choice) pair a slot in its expert's
``(E, C, D)`` buffer: its rank among the pairs routed to that expert, in
token order (an exclusive cumsum over the tokens). Pairs ranked at or past
the capacity ``C`` are dropped: their token gets nothing from that expert.
The reference's ``einsum`` mode moves tokens in and out with one-hot
matmuls; here both modes move them by index (a scatter into a spill row
that is cut off, then gathers), which gives the one-hot products' bits,
since each of their sums has one nonzero term. The modes differ only in
the combine, and each keeps the reference's rounding there:

  * ``einsum``: the reference's ``tec,ecd->td`` product sums a token's k
    weighted expert outputs in float32 and rounds once to the compute
    dtype; so does this one.
  * ``scatter``: the reference rounds each weighted output to the compute
    dtype, then scatter-adds them in choice order; so does this one.

Shapes stay static (``_capacity`` is a Python int of the token count) and
nothing reads a tensor back to the host. The grouped dispatch
(``moe_group_tokens``) is not ported (``configs.base.check_supported``
refuses it), nor the mesh shardings.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def init_moe(gen: torch.Generator, cfg):
    """The reference's leaves: ``gate (D, E)``, ``wi``/``wg (E, D, F)`` and
    ``wo (E, F, D)``, each normal over the square root of its fan-in, and
    with ``n_shared`` a gated MLP of width ``F * n_shared``."""
    d, fe, e, dt = cfg.d_model, cfg.d_ff_expert, cfg.n_experts, cfg.param_dtype
    p = {"gate": layers.dense_init(gen, (d, e), dt),
         "wi": layers.dense_init(gen, (e, d, fe), dt, in_axis=1),
         "wg": layers.dense_init(gen, (e, d, fe), dt, in_axis=1),
         "wo": layers.dense_init(gen, (e, fe, d), dt, in_axis=1)}
    if cfg.n_shared:
        p["shared"] = layers.init_mlp(gen, d, fe * cfg.n_shared, dt)
    return p


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis in descending
    order, the lower index first among equal values. ``torch.topk`` breaks
    ties another way, and bf16 gate logits tie often; a stable descending
    sort breaks them as JAX does."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, x, cfg):
    """Top-k routing of x (T, D): (idx (T, k) int64, weights (T, k) in the
    compute dtype, the Switch load-balance aux loss)."""
    cd = cfg.compute_dtype
    logits = (x @ p["gate"].to(cd)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, cfg.top_k)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    e = cfg.n_experts
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(idx[:, 0], e).to(torch.float32), dim=0)
    aux = e * torch.sum(me * ce)
    return idx, w.to(cd), aux


def _capacity(t: int, cfg) -> int:
    c = int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, (c + 127) // 128 * 128)  # lane-aligned


def slots(idx: torch.Tensor, n_experts: int, cap: int):
    """(rank (T, k), keep (T, k)): each pair's rank among the pairs routed
    to its expert, in token order (a token's k experts are distinct, so it
    counts the earlier tokens routed there), and whether it is below
    ``cap``."""
    onehot = F.one_hot(idx, n_experts).sum(1)                  # (T, E)
    pos = torch.cumsum(onehot, dim=0) - onehot
    rank = torch.gather(pos, 1, idx)
    return rank, rank < cap


def _expert_outputs(p, x2d, cfg):
    """Route x2d (T, D), dispatch the kept pairs into (E, C, D) buffers and
    run the three batched expert products. Returns (the pairs' outputs
    (T, k, D), their weights with dropped pairs zeroed (T, k), aux)."""
    t, d = x2d.shape
    e, k, cd = cfg.n_experts, cfg.top_k, cfg.compute_dtype
    idx, w, aux = _route(p, x2d, cfg)
    cap = _capacity(t, cfg)
    rank, keep = slots(idx, e, cap)
    # Dropped pairs go to the spill row e * cap, cut off below.
    dest = torch.where(keep, idx * cap + rank, e * cap).reshape(-1)
    xin = x2d.new_zeros((e * cap + 1, d), dtype=cd)
    xin.index_copy_(0, dest, x2d.to(cd).repeat_interleave(k, dim=0))
    xin = xin[:-1].view(e, cap, d)
    h = torch.bmm(xin, p["wi"].to(cd))
    g = torch.bmm(xin, p["wg"].to(cd))
    ho = torch.bmm(F.silu(g) * h, p["wo"].to(cd))              # (E, C, D)
    out = ho[idx, torch.clamp(rank, max=cap - 1)]              # (T, k, D)
    return out, w * keep, aux


def moe_apply_einsum(p, x2d, cfg):
    """GShard dispatch, the reference's ``einsum`` mode. x2d: (T, D) ->
    ((T, D), aux): a token's weighted outputs summed in float32, rounded
    once."""
    out, w, aux = _expert_outputs(p, x2d, cfg)
    y = torch.sum(out.to(torch.float32) * w.to(torch.float32)[..., None], dim=1)
    return y.to(cfg.compute_dtype), aux


def moe_apply_scatter(p, x2d, cfg):
    """The reference's ``scatter`` mode: each weighted output rounded to
    the compute dtype, then added in choice order."""
    out, w, aux = _expert_outputs(p, x2d, cfg)
    y_tok = out * w[..., None]
    y = torch.zeros_like(x2d, dtype=cfg.compute_dtype)
    for j in range(cfg.top_k):
        y = y + y_tok[:, j]
    return y, aux


def moe_apply(p, x, cfg):
    """x: (B, S, D) -> ((B, S, D), aux). Routed experts, then the shared
    experts when ``n_shared``."""
    b, s, d = x.shape
    fn = moe_apply_scatter if cfg.moe_dispatch == "scatter" else moe_apply_einsum
    y, aux = fn(p, x.reshape(b * s, d), cfg)
    y = y.reshape(b, s, d)
    if cfg.n_shared:
        y = y + layers.mlp_apply(p["shared"], x, cfg.compute_dtype)
    return y, aux
