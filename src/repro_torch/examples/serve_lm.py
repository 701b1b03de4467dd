"""Serve a small LM with batched requests through the decode engine (port of
``examples/serve_lm.py``).

    python -m repro_torch.examples.serve_lm [--device cuda|cpu]

The reference's lm-serve config (4 layers, d_model 128, 4 query heads over
2 KV heads, d_head 32, bf16 compute), 8 requests of 12 prompt tokens and 24
new ones, greedy. The weights come from a seeded generator on the device,
or from ``params`` (for example the JAX package's, converted with
``repro_torch.convert.params_from_numpy``). On the card every step's
attention is a flash kernel (bf16 with one query row: the split-KV decode
kernel); the returned launches say which.

Two runs whose bf16 logits round at different places part where the two
largest logits are a near tie, and then go on from different histories.
So ``compare`` holds a run on the card to a run on the CPU fed the card's
ids (``forced``): both runs' logits along one sequence.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.examples._common import (launch_counts, launches_since,
                                          run_cli, sync)
from repro_torch.models.model import Model
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.tree import tree_map

LM_SERVE = ModelConfig(name="lm-serve", family="dense", n_layers=4,
                       d_model=128, n_heads=4, n_kv=2, d_head=32, d_ff=512,
                       vocab=512, attn_chunk_kv=64)


class _Recorder(Engine):
    """The engine, keeping every step's logits; with ``forced`` (B, N) ids,
    it feeds those to the steps after the prompt in place of its own picks
    (teacher forcing), and its picks are then each step's argmax along that
    sequence."""

    def __init__(self, *args, prompt_len: int, forced=None):
        super().__init__(*args)
        self.prompt_len, self.logits = prompt_len, []
        self.forced = None if forced is None else torch.as_tensor(
            np.asarray(forced, np.int32), device=self.model.device)

    def _step(self, cache, tokens, pos):
        if self.forced is not None and pos >= self.prompt_len:
            tokens = self.forced[:, pos - self.prompt_len, None]
        cache, logits = super()._step(cache, tokens, pos)
        self.logits.append(logits)
        return cache, logits


def paired_kwargs(dev):
    """The arguments of a run on the card ``dev`` and, from its result, of
    the CPU run it is held to (``examples._common.card_vs_cpu``): the
    card's seeded weights, copied to the host for the CPU, and the card's
    ids fed to the CPU run."""
    params = Model(LM_SERVE, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    host = tree_map(lambda a: a.cpu(), params)
    return {"params": params}, lambda card: {"params": host, "forced": card["ids"]}


# Two runs' bf16 logits along one sequence are held to LOGIT_TOL, set from
# the largest differences read: the card (the decode kernel, the card's
# matmuls) against the CPU, 0.0625 on an H100 (chip_smoke.py's examples
# phase), and the port against the JAX package on the CPU, 0.078
# (tests/test_torch_examples.py).
LOGIT_TOL = 0.1


def compare(got: dict, want: dict) -> dict:
    """``got``'s run against ``want``'s, a run fed ``got``'s ids (so that
    both logits follow one sequence): the prompts equal, every logit
    finite and within ``LOGIT_TOL`` of ``want``'s, and the ids equal
    wherever ``want``'s two largest logits lie more than twice that apart
    (only there can no difference within it reorder them). Returns the
    mismatches, the largest logit difference, the ids held, the ids that
    differ and the largest gap of ``want``'s at an id that differs."""
    out = {"mismatches": [] if np.array_equal(got["prompts"], want["prompts"])
           else [".prompts"]}
    if got["logits"].shape != want["logits"].shape or got["ids"].shape != want["ids"].shape:
        return {"mismatches": out["mismatches"] + [".logits: shapes differ"]}
    worst = float(np.abs(got["logits"] - want["logits"]).max())
    top2 = np.sort(want["logits"], -1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    held, parted = gap > 2 * LOGIT_TOL, got["ids"] != want["ids"]
    if not worst <= LOGIT_TOL:
        out["mismatches"].append(f".logits: largest difference {worst} > {LOGIT_TOL}")
    out["mismatches"] += [f".ids{list(map(int, i))}"
                          for i in np.argwhere(parted & held)]
    return {**out, "logits_max_diff": worst, "ids_held": int(held.sum()),
            "ids_parted": int(parted.sum()),
            "parted_max_gap": float(gap[parted].max(initial=0.0))}


def main(device="cuda", log=print, params=None, forced=None) -> dict:
    """Serve the 8 requests; returns the generated ids (8, 24), the logits
    each was picked from (8, 24, vocab, float32), the prompts, the sample
    continuation it prints and the kernels' launches. With ``forced`` (8,
    24) ids, the steps after the prompt are fed those instead of the
    engine's picks (``_Recorder``)."""
    dev = resolve_device(device)
    before = launch_counts()
    cfg = LM_SERVE
    model = Model(cfg, device=dev)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))

    rng = np.random.default_rng(0)
    batch = rng.integers(1, cfg.vocab, (8, 12)).astype(np.int32)  # 8 requests
    engine = _Recorder(model, params, ServeConfig(max_new_tokens=24, max_seq=128),
                       prompt_len=batch.shape[1], forced=forced)
    sync(dev)
    t0 = time.perf_counter()
    out = engine.generate(batch)         # ids read back: the queue has drained
    dt = time.perf_counter() - t0
    n_tok = out.size
    log(f"served 8 requests x 24 new tokens in {dt:.2f}s "
        f"({n_tok/dt:.0f} tok/s on {dev})")
    log(f"sample continuation ids: {out[0][:12].tolist()}")
    logits = torch.stack(engine.logits[batch.shape[1] - 1:-1], 1)
    return {"ids": out, "logits": logits.float().cpu().numpy(), "prompts": batch,
            "sample": out[0][:12].tolist(), "launches": launches_since(before)}


if __name__ == "__main__":
    run_cli(main, __doc__)
