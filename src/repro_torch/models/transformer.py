"""Decoder-only layer stack, dense (port of ``repro.models.transformer``).

Per-layer parameters are stacked on a leading L axis, as in the JAX
package, and the ``lax.scan`` over layers becomes a Python loop over that
axis. Remat and the sharding constraints have no meaning for serving and
are left out; MoE layers raise (ROADMAP Queue 1, LM scaffold item
10.3).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import NOT_PORTED
from repro_torch.models import attention, layers


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _no_moe(use_moe: bool) -> None:
    if use_moe:
        raise NotImplementedError(f"MoE decoder layers: {NOT_PORTED}")


def init_decoder_layer(gen: torch.Generator, cfg, *, use_moe: bool):
    _no_moe(use_moe)
    return {"ln1": layers.init_rms(gen, cfg.d_model, cfg.param_dtype),
            "ln2": layers.init_rms(gen, cfg.d_model, cfg.param_dtype),
            "attn": attention.init_gqa(gen, cfg),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype)}


def apply_decoder_layer(p, x, cfg, positions, *, use_moe: bool, causal=True):
    """Returns (x, aux_loss); aux_loss is 0.0 for a dense layer."""
    _no_moe(use_moe)
    h = layers.rms_norm(x, p["ln1"])
    x = x + attention.gqa_apply(p["attn"], h, cfg, positions, causal=causal)
    h = layers.rms_norm(x, p["ln2"])
    return x + layers.mlp_apply(p["mlp"], h, cfg.compute_dtype), 0.0


def init_decoder_stack(gen: torch.Generator, cfg):
    return {"layers": _stack([init_decoder_layer(gen, cfg, use_moe=False)
                              for _ in range(cfg.n_layers)])}


def apply_decoder_stack(p, x, cfg, positions, *, causal=True):
    """-> (x, aux_loss) after every layer of ``p["layers"]`` in turn."""
    stack = p["layers"]
    for i in range(cfg.n_layers):
        lp = tree_map(lambda a: a[i], stack)
        x, _ = apply_decoder_layer(lp, x, cfg, positions, use_moe=False,
                                   causal=causal)
    return x, 0.0
