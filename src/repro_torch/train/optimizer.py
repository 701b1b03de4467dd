"""AdamW (port of ``repro.train.optimizer``): bf16 or fp32 moments,
global-norm clipping, linear warmup then cosine decay, and an optional
fp32 master copy of bf16 params (``keep_master``).

Every step follows the reference's float32 arithmetic op for op, in its
order, on 0-d float32 tensors on the params' device (so nothing syncs);
``global_norm`` sums the leaves in JAX's flatten order (dict keys sorted).
Unlike the reference, which returns new arrays (its train step donates the
old ones), ``adamw_update`` writes the new params, moments and master copy
into the tensors it was given, under ``torch.no_grad``, and returns them:
keep a clone of anything the caller still needs. ``opt_state_pspecs`` is
mesh-only and is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype_str: str = "bfloat16"
    # Keep an fp32 master copy in the optimizer state when model params are
    # bf16 (updates accumulate in fp32).
    keep_master: bool = False

    @property
    def moment_dtype(self) -> torch.dtype:
        return getattr(torch, self.moment_dtype_str)


class OptState(NamedTuple):
    step: torch.Tensor     # 0-d int32
    mu: Any
    nu: Any
    master: Any = None     # fp32 master params (keep_master) or None


# Elements a slice of a leaf is updated in (see ``adamw_update``).
_CHUNK_ELEMS = 1 << 24


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The reference's schedule on an int32 step tensor, in float32."""
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), _f32(1.0, step))
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    # cos in float64, rounded once: XLA's float32 cos is correctly rounded
    # at the schedule's points where torch's float32 cos is an ulp off.
    cos = 0.5 * (1.0 + torch.cos((_f32(math.pi, step) * prog).double()).float())
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(cfg: OptConfig, params) -> OptState:
    some = tree_leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                  device=p.device)
    master = (tree_map(lambda p: p.to(torch.float32, copy=True), params)
              if cfg.keep_master else None)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=some.device),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    master=master)


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state: OptState, params):
    """Returns (params, state, metrics {"grad_norm", "lr"}), the params and
    the state's trees updated in place."""
    step = state.step + 1
    gnorm = global_norm(grads)
    # A Python number over a tensor would run as reciprocal-then-multiply.
    scale = torch.minimum(_f32(1.0, gnorm), _f32(cfg.clip_norm, gnorm)
                          / torch.maximum(gnorm, _f32(1e-12, gnorm)))
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(b1, stepf), stepf)
    bc2 = 1.0 - torch.pow(_f32(b2, stepf), stepf)

    def upd_chunk(p, g, m, v, pm, decay: bool):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        step_dir = mhat / (torch.sqrt(vhat) + cfg.eps)
        src32 = (pm if pm is not None else p).to(torch.float32)
        upd_dir = step_dir + cfg.weight_decay * src32 if decay \
            else step_dir + 0.0
        p32 = src32 - lr * upd_dir
        p.copy_(p32)
        m.copy_(m32)
        v.copy_(v32)
        if pm is not None:
            pm.copy_(p32)

    def upd(p, g, m, v, pm):
        # Elementwise, so a leaf goes in slices of _CHUNK_ELEMS elements of
        # its flattened view: the float32 temporaries stay a slice's size,
        # not a leaf's (a routed-expert leaf of deepseek-v2-236b is 1.26e9
        # elements, 5 GB in float32). The tensors written in place are
        # flattened by ``view``, which raises where a copy would lose the
        # writes.
        ps, ms, vs = (x.view(-1).split(_CHUNK_ELEMS) for x in (p, m, v))
        gs = g.reshape(-1).split(_CHUNK_ELEMS)
        pms = pm.view(-1).split(_CHUNK_ELEMS) if pm is not None else [None] * len(ps)
        for chunk in zip(ps, gs, ms, vs, pms):
            upd_chunk(*chunk, decay=p.dim() >= 2)

    masters = state.master if state.master is not None else \
        tree_map(lambda p: None, params)
    tree_map(upd, params, grads, state.mu, state.nu, masters)
    return params, OptState(step, state.mu, state.nu, state.master), {
        "grad_norm": gnorm, "lr": lr}
