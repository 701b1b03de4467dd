"""Decoder-only layer stacks: dense or MoE, hybrid (Mamba2 with a shared
attention block) and Mamba1 (port of ``repro.models.transformer``).

Per-layer parameters are stacked on a leading L axis, as in the JAX
package, and the ``lax.scan`` over layers becomes a Python loop over that
axis; the stack is cut into its layers once a call (``unbind_layers``), so
the gradient of each stacked leaf is one stack-sized tensor and not one a
layer. Remat: when grad is enabled and ``cfg.remat != "none"`` each layer
runs under ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``
and is recomputed in the backward. ``"dots"`` (the JAX package's
``checkpoint_dots`` policy, which saves the matmul outputs) recomputes the
whole layer like ``"full"`` here; the values are the same, only the memory
and time differ. The sharding constraints have no meaning on one device
and are left out. In the moe family (``cfg.n_experts > 0``) every layer's
FFN of ``layers`` is ``models/moe.py``'s (leaf ``moe`` in place of
``mlp``) and the stack returns the sum of those layers' load-balance aux
losses, as the reference's ``jnp.sum(auxs)``; ``first_dense`` leading
dense-FFN layers (deepseek-v2: 1) are their own stacked leaf ``first``,
run ahead of ``layers`` and adding no aux loss. With ``cfg.mla`` every
layer's attention is MLA (``attention.init_mla`` / ``mla_apply``).
The ssm stack (falcon-mamba) is a pre-norm residual Mamba1 block a
layer, under the same remat. The hybrid stack (zamba2) is a pre-norm
residual Mamba2 block a layer, with one shared attention + MLP block, its
weights unstacked beside the stacked ``layers``, applied after every
``attn_every``-th layer (``hybrid_groups``); each Mamba2 layer and each
application of the shared block is one remat unit.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, layers, mamba, moe


def unbind_layers(tree) -> list:
    """The per-layer trees of a stacked tree, one ``unbind(0)`` a leaf."""
    if isinstance(tree, dict):
        parts = {k: unbind_layers(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_decoder_layer(gen: torch.Generator, cfg, *, use_moe: bool):
    p = {"ln1": layers.init_rms(gen, cfg.d_model, cfg.param_dtype),
         "ln2": layers.init_rms(gen, cfg.d_model, cfg.param_dtype),
         "attn": (attention.init_mla if cfg.mla else attention.init_gqa)(gen, cfg)}
    if use_moe:
        p["moe"] = moe.init_moe(gen, cfg)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype)
    return p


def apply_decoder_layer(p, x, cfg, positions, *, use_moe: bool, causal=True):
    """Returns (x, aux_loss); aux_loss is 0.0 for a dense layer."""
    h = layers.rms_norm(x, p["ln1"])
    attend = attention.mla_apply if cfg.mla else attention.gqa_apply
    x = x + attend(p["attn"], h, cfg, positions, causal=causal)
    h = layers.rms_norm(x, p["ln2"])
    if use_moe:
        f, aux = moe.moe_apply(p["moe"], h, cfg)
    else:
        f, aux = layers.mlp_apply(p["mlp"], h, cfg.compute_dtype), 0.0
    return x + f, aux


def init_decoder_stack(gen: torch.Generator, cfg):
    """``first`` (``first_dense`` dense layers, where there are any), then
    ``layers`` (the rest: MoE in the moe family). A stack cut to its
    leading dense layers has no ``layers`` leaf."""
    p, n_main = {}, cfg.n_layers - cfg.first_dense
    if cfg.first_dense:
        p["first"] = _stack([init_decoder_layer(gen, cfg, use_moe=False)
                             for _ in range(cfg.first_dense)])
    if n_main:
        p["layers"] = _stack([init_decoder_layer(gen, cfg, use_moe=cfg.n_experts > 0)
                              for _ in range(n_main)])
    return p


def decoder_layers(p, cfg) -> list:
    """``(layer params, use_moe)`` of every layer of a decoder stack in
    order: the ``first`` leaf's, then ``layers``'."""
    out = [(lp, False) for lp in unbind_layers(p["first"])] if cfg.first_dense else []
    if "layers" in p:
        out += [(lp, cfg.n_experts > 0) for lp in unbind_layers(p["layers"])]
    return out


def _remat(cfg) -> bool:
    return torch.is_grad_enabled() and cfg.remat != "none"


def apply_decoder_stack(p, x, cfg, positions, *, causal=True):
    """-> (x, aux_loss) after every layer of ``p["first"]`` and
    ``p["layers"]`` in turn; aux_loss is the sum of the MoE layers' (0.0 in
    a dense stack)."""
    remat = _remat(cfg)
    auxs = []
    for lp, use_moe in decoder_layers(p, cfg):
        if remat:
            x, aux = checkpoint(apply_decoder_layer, lp, x, cfg, positions,
                                use_moe=use_moe, causal=causal,
                                use_reentrant=False)
        else:
            x, aux = apply_decoder_layer(lp, x, cfg, positions,
                                         use_moe=use_moe, causal=causal)
        if use_moe:
            auxs.append(aux)
    return x, (torch.sum(torch.stack(auxs)) if auxs else 0.0)


# ---------------------------------------------------------------------------
# Hybrid stack (zamba2): Mamba2 layers + one shared attention block applied
# every ``attn_every`` layers (weights shared across applications).
# ---------------------------------------------------------------------------

def init_hybrid_stack(gen: torch.Generator, cfg):
    return {"layers": _stack([
                {"ln": layers.init_rms(gen, cfg.d_model, cfg.param_dtype),
                 "mamba": mamba.init_mamba2(gen, cfg)}
                for _ in range(cfg.n_layers)]),
            "shared_attn": {
                "ln": layers.init_rms(gen, cfg.d_model, cfg.param_dtype),
                "attn": attention.init_gqa(gen, cfg),
                "ln2": layers.init_rms(gen, cfg.d_model, cfg.param_dtype),
                "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                       cfg.param_dtype)}}


def hybrid_attn_sites(cfg) -> list:
    """Layer indices after which the shared attention block runs."""
    if not cfg.attn_every:
        return []
    return [l for l in range(cfg.n_layers) if (l + 1) % cfg.attn_every == 0]


def hybrid_groups(cfg):
    """``(groups, n_sites)``: ``n_layers`` cut into contiguous ``(lo, hi)``
    groups, each of the first ``n_sites`` followed by one application of
    the shared block; a trailing remainder group has none (zamba2-1.2b: 38
    layers at ``attn_every`` 6 give sites 5, 11, ..., 35 and a last group
    of layers 36-37)."""
    sites = hybrid_attn_sites(cfg)
    bounds = [0] + [s + 1 for s in sites]
    if bounds[-1] != cfg.n_layers:
        bounds.append(cfg.n_layers)
    return list(zip(bounds[:-1], bounds[1:])), len(sites)


def _shared_attn_block(shared, x, cfg, positions):
    h = layers.rms_norm(x, shared["ln"])
    x = x + attention.gqa_apply(shared["attn"], h, cfg, positions, causal=True)
    h = layers.rms_norm(x, shared["ln2"])
    return x + layers.mlp_apply(shared["mlp"], h, cfg.compute_dtype)


def apply_hybrid_layer(lp, x, cfg):
    h = layers.rms_norm(x, lp["ln"])
    y, _ = mamba.mamba2_apply(lp["mamba"], h, cfg)
    return x + y


def apply_hybrid_stack(p, x, cfg, positions):
    """-> (x, aux_loss 0.0): each group's Mamba2 layers in turn, then the
    shared block after each of the first ``n_sites`` groups."""
    groups, n_sites = hybrid_groups(cfg)
    shared = p["shared_attn"]
    lps = unbind_layers(p["layers"])
    remat = _remat(cfg)
    for gi, (lo, hi) in enumerate(groups):
        for lp in lps[lo:hi]:
            x = (checkpoint(apply_hybrid_layer, lp, x, cfg, use_reentrant=False)
                 if remat else apply_hybrid_layer(lp, x, cfg))
        if gi < n_sites:
            x = (checkpoint(_shared_attn_block, shared, x, cfg, positions,
                            use_reentrant=False)
                 if remat else _shared_attn_block(shared, x, cfg, positions))
    return x, 0.0


# ---------------------------------------------------------------------------
# SSM stack (falcon-mamba)
# ---------------------------------------------------------------------------

def init_ssm_stack(gen: torch.Generator, cfg):
    return {"layers": _stack([
        {"ln": layers.init_rms(gen, cfg.d_model, cfg.param_dtype),
         "mamba": mamba.init_mamba1(gen, cfg)} for _ in range(cfg.n_layers)])}


def apply_ssm_layer(lp, x, cfg):
    h = layers.rms_norm(x, lp["ln"])
    y, _ = mamba.mamba1_apply(lp["mamba"], h, cfg)
    return x + y


def apply_ssm_stack(p, x, cfg, positions=None):
    """-> (x, aux_loss 0.0) after every Mamba1 layer in turn; ``positions``
    is unused (the reference's signature)."""
    remat = _remat(cfg)
    for lp in unbind_layers(p["layers"]):
        x = (checkpoint(apply_ssm_layer, lp, x, cfg, use_reentrant=False)
             if remat else apply_ssm_layer(lp, x, cfg))
    return x, 0.0
