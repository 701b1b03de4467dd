"""Train a small LM end to end on the AerialDB-backed data pipeline, with
checkpointing and a simulated restart (port of ``examples/train_lm.py``).

    python -m repro_torch.examples.train_lm [--steps 200] [--device cuda]

The reference's lm-8m config, pipeline (8 sequences of 64 tokens a step,
drawn by store queries), AdamW settings and checkpoint cadence. A run that
finds a checkpoint under ``--ckpt-dir`` resumes from its step: batches are
a pure function of the step, so a restarted run continues the same stream
(the fault-tolerance path). On the card the ingest and every batch run the
datastore's kernels, and the model the flash forward (``mma_sync`` at d 32)
and backward kernels; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import AerialPipeline, PipelineConfig
from repro_torch.models.model import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as optlib
from repro_torch.train.train_loop import make_train_step
from repro_torch.tree import tree_leaves

LM_8M = ModelConfig(name="lm-8m", family="dense", n_layers=4, d_model=128,
                    n_heads=4, n_kv=2, d_head=32, d_ff=512, vocab=512,
                    loss_chunk=512, attn_chunk_kv=64)


def run(steps: int, ckpt_dir, ckpt_every: int, device="cuda", *,
        stop: int | None = None, log=print) -> dict:
    """Train for ``steps`` steps (the schedule's length), or until ``stop``,
    resuming from the latest checkpoint under ``ckpt_dir`` (None: no
    checkpoints). Returns the final params, optimizer state, the losses of
    the steps this run took and the step it started from."""
    cfg = LM_8M
    model = Model(cfg, device=device)
    pipe = AerialPipeline(PipelineConfig(vocab=cfg.vocab, batch=8, seq=64),
                          device=device)
    opt_cfg = optlib.OptConfig(lr=3e-3, warmup_steps=20, total_steps=steps)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    opt_state = optlib.init_opt_state(opt_cfg, params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"model: {n_params/1e6:.1f}M params; data plane: AerialDB "
        f"({pipe.store_cfg.n_edges} edges, 3x replication) on {model.device}")
    train_step = make_train_step(model, opt_cfg)

    start = 0
    if ckpt_dir is not None and ckpt.latest_step(ckpt_dir) is not None:
        restored, start = ckpt.restore_checkpoint(
            ckpt_dir, {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        log(f"resumed from checkpoint at step {start}")

    losses = []
    t0 = time.perf_counter()
    for step in range(start, steps if stop is None else stop):
        batch = pipe.get_batch(step)      # deterministic in step => exact resume
        params, opt_state, m = train_step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        if ckpt_dir is not None and ((step + 1) % ckpt_every == 0
                                     or step + 1 == steps):
            ckpt.save_checkpoint(ckpt_dir, step + 1,
                                 {"params": params, "opt": opt_state})
            log(f"step {step+1:4d} loss={losses[-1]:.4f} "
                f"({(time.perf_counter()-t0)/(step-start+1)*1e3:.0f} ms/step) [ckpt]")
    return {"params": params, "opt": opt_state, "losses": losses,
            "start": start}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "aerialdb_train_ckpt_torch"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.steps, args.ckpt_dir, args.ckpt_every, args.device)
    print("done")


if __name__ == "__main__":
    main()
