#!/usr/bin/env python3
"""Replay, on the CPU, what the bf16 gradient gate of ``chip_smoke.py``'s
``train_vs_cpu`` phase compares, to size its limit.

    PYTHONPATH=src python tools/bf16_grad_replay.py [--seed 4]

examples/train_lm.py's lm-8m config, weights from
``Generator().manual_seed(0)``, one batch of 8 x 64 random tokens. The
gradient of the mean loss is taken in bf16 compute four ways, all through
the port's plain flash forward, and differing only in the attention
backward:

- ``plain``: ``flash_attention_bwd_ref`` (P and dS kept in fp32);
- ``rounded``: the same formula with P and dS rounded to bf16 before their
  products, as the backward kernel rounds them before ``mma.sync``;
- ``dk_swapped``: the plain backward with dk's kv heads swapped, the fault
  the gate's control injects;

and once in float64. Prints, for each pair, the largest over the leaves
of ||a - b|| / ||b|| (the gate's measure) and of max|a - b| / max|b|.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.examples.train_lm import LM_8M
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
from repro_torch.models.model import Model
from repro_torch.train.train_loop import value_and_grad
from repro_torch.tree import tree_leaves, tree_map


def rounded_bwd(q, k, v, o, do, *, causal, q_offset=0):
    """``flash_attention_bwd_ref`` with P and dS rounded to bf16."""
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    f, scale = torch.float32, dh ** -0.5
    split = lambda x: x.reshape(b, sq, kv, h // kv, dh).to(f)
    qf, dof, of = split(q), split(do), split(o)
    kf, vf = k.to(f), v.to(f)
    s = torch.einsum("bqkgd,bckd->bqkgc", qf, kf) * scale
    if causal:
        mask = (q_offset + torch.arange(sq))[:, None] >= torch.arange(skv)[None]
        s = torch.where(mask[None, :, None, None, :], s, float("-inf"))
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    d_row = (dof * of).sum(-1, keepdim=True)
    dp = torch.einsum("bqkgd,bckd->bqkgc", dof, vf)
    ds = (p * (dp - d_row)).bfloat16().float()
    p = p.bfloat16().float()
    dv = torch.einsum("bqkgc,bqkgd->bckd", p, dof)
    dq = torch.einsum("bqkgc,bckd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bqkgc,bqkgd->bckd", ds, qf) * scale
    return dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def dk_swapped_bwd(q, k, v, o, do, *, causal, q_offset=0):
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                         q_offset=q_offset)
    return dq, dk.roll(1, 2), dv


def grads(params, batch, compute, bwd=flash_attention_bwd_ref):
    model = Model(LM_8M.replace(compute_dtype_str=compute), device="cpu")
    fops.flash_attention_bwd_ref = bwd        # FlashAttentionFn's CPU backward
    try:
        _, g = value_and_grad(model, tree_map(torch.clone, params), batch)
    finally:
        fops.flash_attention_bwd_ref = flash_attention_bwd_ref
    return [x.double() for x in tree_leaves(g)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=4, help="the batch's seed")
    args = ap.parse_args(argv)
    params = Model(LM_8M, device="cpu").init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, LM_8M.vocab, (8, 65)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    runs = {"float64": grads(params, batch, "float64"),
            "plain": grads(params, batch, "bfloat16"),
            "rounded": grads(params, batch, "bfloat16", rounded_bwd),
            "dk_swapped": grads(params, batch, "bfloat16", dk_swapped_bwd)}
    for a, b in (("plain", "float64"), ("rounded", "float64"),
                 ("rounded", "plain"), ("dk_swapped", "plain")):
        l2 = max(float((x - y).norm() / y.norm())
                 for x, y in zip(runs[a], runs[b]))
        mx = max(float((x - y).abs().max() / y.abs().max())
                 for x, y in zip(runs[a], runs[b]))
        print(f"{a} vs {b}: l2 {l2!r}, max {mx!r}")


if __name__ == "__main__":
    main()
