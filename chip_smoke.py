#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of AerialDB on one GPU, end to end.

    python3 chip_smoke.py                  # full run (needs one CUDA card)
    python3 chip_smoke.py --rounds 24      # shallower ingest, same widths

Phases, one line each:
  1. environment: card name and power limit (nvidia-smi), torch / CUDA
     versions, kernel build time (one nvcc per csrc/*.cu, all at once);
  2. hash64 and voronoi_assign against their plain PyTorch versions on the
     card (bitwise), and against the pure-Python / float64 oracles;
  3. the main path at full width — the paper's D400 deployment (400 drones,
     80 edges, 60-sample shards every 5 min, 4 channels, replication 3):
     open, fused ingest of one day (288 rounds), then three 64-query AND
     batches at the paper's §4.5.1 sizes, single- and 4-channel. Checks the
     answers on retained windows against a numpy oracle over the generated
     payloads and that every kernel's launch count grew; then, on the same
     store, the planners line: the same batches through a ``random``
     session (key from ``--seed``) and a ``min_edges`` one (batch p50, fig.
     9's mean sub-query edges and shards per edge, launches, the same exact
     checks) and the random planner's threefry draw and plans on the card
     against the CPU (bits and uniforms bitwise, picks away from
     near-ties); then the latest line: the same day into a second store
     with the latest-per-drone cache (``max_drones`` 400), its shards/s
     beside the main path's, the cache against the oracle over every
     record (bitwise), every other state leaf and the 5 km batch against
     the main path's store, the host µs of ``latest()`` and
     ``query(Query().latest())``, a crafted round of edge cases against the
     oracle and the CPU, one cache update's call and host time, and the
     cache's cost on ingest from two fresh stores, with and without it,
     taking the day's first chunks in turns; then the resilience line: the
     paper's edge-server loss at D400 width (4 failure domains, 2^19-slot
     rings, domain 1's
     20 edges down from round 24 to 48, then recovered with the incremental
     repair) against a never-faulted twin: the 1 km x 1800 s batch during
     and after the outage against the twin's, the ledger's no-op flips,
     the incremental repair against a full sweep of a clone, the
     canonical content against the twin's, the kernels at the repair's
     batch against their plain versions, and a small wrapping scenario on
     the card against the CPU; the repair telemetry, its host seconds (D2H,
     placement, sweep, H2D), launches, shards/s and peak memory; its
     partition leg: a third store on the same rounds, split after round
     24 (edges 60-79 unreachable) and healed after round 48, held to the
     same twin (the far side frozen, both batches during and after the
     split, the heal's repair against a full sweep, the swept shards,
     the content, an empty ledger); then the streaming line: 48 rounds of
     a 400-drone fleet sent as an adversarial stream (re-sends, gaps,
     NaN-partial records, shuffled, transient dispatch faults, the
     journal on) through ``IngestPipeline`` into a D400 store with the
     latest cache, its counters, the three batch sizes against a numpy
     oracle (NaN a value), ``latest()`` before the drain against the
     oracle and a journal replay into a fresh store; then the chaos line:
     fig. 19's soak at D400 width (the resilience config) for seeds 3, 11
     and 42, each a ``FaultPlan.random`` over 16 rounds (domain losses,
     edge losses, partitions cut across the domain blocks, flush bursts)
     through ``ChaosRunner`` on a session and pipeline beside a
     never-faulted twin: the plan replayed from its seed, the counters
     every step, a probe batch after every repair (exact against the twin
     with bound 1 at full health), no wrap and the content equal to the
     twin's at the end; a mid-flush crash replayed from the journal; the
     reference tests' smoke plan on the card against the CPU; then the
     federation line: the store split over a one-process edge mesh of 4
     blocks of 20 edges on the card (``make_edge_mesh(4)``) against the
     single store, both taking the day's rounds in turns (shards/s of
     each), every leaf of the gathered store against the single store's,
     the three batches (1 and 4 channels) and the 5 km batch under the
     ``random`` and ``min_edges`` planners equal on both (p50 of each);
     the resilience config's domain loss and incremental repair on a mesh
     and a single store in lockstep (leaves, ledgers, telemetry and the
     1 km x 1800 s batch equal during and after; repair walls and host
     seconds, the mesh's gather and write-back); a small wrapping mesh on
     the card against the CPU; every kernel's launches against 4 x the
     single store's counts; then the fleet line: the store split over a
     one-process 2-D fleet mesh (``make_fleet_mesh(2, 2)``: 2 fleets of 2
     blocks of 20 edges on the card, the candidate merge in two levels,
     each 64-query batch in two tiles) against a single store, both taking
     the day's rounds in turns (G1: every leaf equal), the three batches
     and the 5 km batch under ``random`` and ``min_edges`` equal on both
     (G2, p50 of each), every kernel's launches against the prediction by
     part (G3), the small wrapping scenario on the fleet mesh on the card
     against the CPU (G4), and the two-process smoke at D400 width (G5:
     ``python -m repro_torch.launch.multihost_smoke --device cuda --width
     d400``, 2 gloo processes on the card, one a fleet, each held to its
     own single store; the wall, the exchanges, their syncs and host
     seconds); then the analysis line (``repro_torch.analysis``): the
     port's lint, clean; the canonical workload's budget on the card
     (single store, (4,) and (2, 2) meshes, cold then warm: syncs by a
     TorchFunctionMode count and by ``set_sync_debug_mode``'s warnings side
     by side, host->card copies, launches by kernel held to the TOML); two
     child processes over an empty build directory (the first builds and
     loads st_scan, hash64 and voronoi_assign once each, the second builds
     nothing); the collective contract on the card's meshes; at D400 width
     the (4,) mesh's cross-block multiset identical at 2^18 and 2^19 slots
     and a 24-round ingest in place, its peak memory growth below one
     ``tup_f`` leaf;
  4. st_scan against its plain version on the main path's own scan inputs
     (the three batches, 1 and 4 channels), on a copy of the day's log with
     NaN in a channel of matched slots and on a copy rolled by a third of
     the ring with every count above capacity (count, min, max bitwise with
     NaN equal, sum to rtol 1e-5, a second call bitwise equal); its device
     time at each batch and channel count beside the bytes it must move;
     then per-kernel timings beside their bounds (hash64 at an insert
     round's three shapes, 6,400 slice buckets and 400 midpoint buckets in
     the H_t form and 400 shard ids in the H_i form, each beside an empty
     kernel on its grid; voronoi_assign at the
     slice grid's and the placement's shapes, with the sites it visits a
     point, the instructions that costs by a static count from its SASS,
     and its bound recounted for the sites visited): ``ms`` is the call time,
     wrapper included (CUDA events around back-to-back calls, so a wrapper
     slower than its kernel shows the host), ``device_ms`` the kernel's own
     device time a launch (torch.profiler, summed by kernel name);
  5. flash_attention's three kernels against their plain version (fp32 at
     the JAX package's test shapes, decode rows and ragged sizes, at d 128
     and 160, to 2e-5, through the mma_sync kernel; bf16 at the serve
     shapes of internlm2-1.8b (d 128), stablelm-12b (d 160), zamba2-1.2b
     (d 64, GQA group 1) and deepseek-7b (d 128, GQA group 1), decode rows
     of 256 and 4096 slots, a GQA group of 5 and ragged d-64, d-128 and
     d-160 cases, grok-1-314b's GQA group 6 (d 128) at its prefill and
     decode shapes, to 1e-2, through the sm90, decode and mma_sync kernels,
     each forced and as the wrapper chooses; the sm90 and decode kernels
     also bitwise repeatable); both backward
     kernels against their plain version (``flash_bwd_vs_plain``: the one
     the wrapper picks at d 32, 64, 128 and 160, fp32 to 2e-5 and bf16 to
     2e-2 of each gradient's largest magnitude, GQA groups 1 and 2 and 16
     heads over 8, causal and not, Sq != Skv with a q_offset, ragged
     lengths; at bf16 d 128 also the sm90 and the mma_sync backward forced,
     with 1024-row cases of groups 1 and 8 and a q_offset of 1024 over
     1536 keys; at MLA's pairs, v a strided view, the one the wrapper
     picks (bf16 (192, 128): the sm90 backward) and at bf16 (192, 128)
     both kernels forced; a second call bitwise);
  6. the LM serving path at full width, five times: internlm2-1.8b
     (d_model 2048, 16 query heads over 8 KV heads, d_head 128, vocab
     92544, the depth cut to 6 of its 24 layers; weights drawn in fp32,
     the engine's copy in bf16), then
     stablelm-12b (d_model 5120, 32 query heads over 8 KV heads, d_head
     160, d_ff 13824, vocab 100352, the depth cut to 5 of its 40 layers;
     drawn in bf16 so that the engine copies nothing; internlm2's engine
     freed first), then falcon-mamba-7b (below), random weights from a
     seeded generator on the card, bf16
     compute: ``prefill_step`` on 8 prompts of 2048 tokens, then
     ``Engine.generate`` for 8 requests (128-token prompts, 64 new tokens,
     max_seq 256), twice (identical ids), with the engine's logits after
     the last prompt token held against ``prefill_step``'s on the same
     prompts; every prefill flash call must go to the sm90 kernel and every
     generate call (Sq 1) to the decode kernel (lines ``serve_prefill`` /
     ``serve_generate`` and ``serve_stablelm_prefill`` /
     ``serve_stablelm_generate``); internlm2-1.8b's engine also samples at
     temperature 0.7 (line ``serve_sampled``): twice with seed 0 (equal
     ids) and once with seed 1 (other ids), each with the greedy run's
     decode launches, every pick drawn again from the engine's logits on
     the card (bitwise) and on the CPU (equal wherever the perturbed top-2
     gap exceeds 2 ulps; the rows within it counted), and the device ms
     and host µs a pick adds over argmax; then the ssm family:
     falcon-mamba-7b (Mamba1, attention-free: d_model 4096, d_inner 8192,
     state 16, vocab 65024, the depth cut to 8 of its 64 layers; drawn
     in bf16, ``a_log`` float32) through the same
     ``serve`` with no flash launch:
     ``prefill_step`` on 8 x 2048 tokens (with the plain scan's time at
     one layer's shape and its share of the prefill), ``Engine.generate``
     greedy twice and sampled once (lines ``serve_falcon_prefill`` /
     ``serve_falcon_generate``); then the hybrid family: zamba2-1.2b
     (Mamba2 layers, 26 of its 38, and one shared attention + MLP block
     after every 6th, d_model 2048, 32 heads over 32 at d 64, vocab 32000;
     drawn in bf16) through the same ``serve``: 4 sm90
     launches a prefill, 4 decode launches a step, the plain SSD's time at
     one layer's shape and its share of the prefill, the prefill's FLOP
     bound from the model's matmuls (lines ``serve_zamba_prefill`` /
     ``serve_zamba_generate``); then the moe family: grok-1-314b (d_model
     6144, 48 heads over 8 at d 128, 8 experts of width 32768, top-2,
     vocab 131072; 2 of its 64 layers, 11.45e9 parameters drawn in bf16)
     through the same ``serve``: 2 sm90 launches a prefill, 2 decode
     launches a step, each prefill's dropped pairs and largest expert
     load, the FLOP bound with the capacity padding, the decode step's
     bytes bound; the prompt logits held at PREFILL_DECODE_TOL, or where
     routes parted by the mean beside a K/V-losing control (lines
     ``serve_grok_prefill`` / ``serve_grok_generate``); then the MLA
     family: deepseek-v2-236b (d_model 5120, 128 heads with q/k 192 and v
     128 over a 512-wide latent cache, 160 experts of width 1536 top-6
     and 2 shared, a leading dense layer at 12288, vocab 102400; 3 of its
     60 layers, the dense one and two MoE, 9.57e9 parameters drawn in
     bf16) through the same ``serve``: 3 sm90 launches a prefill at (192,
     128), no flash launch a decode step (the absorbed attention is torch
     ops), held as grok's beside a control that loses the latent cache, and
     fp32 at full width cut to the dense layer (prefill on the mma_sync
     kernel at (192, 128)) to 1e-3 (lines ``serve_dsv2_prefill`` /
     ``serve_dsv2_generate``); then
     ``ssm_vs_cpu``, ``hybrid_vs_cpu``, ``moe_vs_cpu`` and ``mla_vs_cpu``:
     each family's smoke model in fp32 on the card (forward bitwise twice,
     40 decode steps; the hybrid's shared block and the moe model's
     attention on the mma_sync kernel) against float64 on the CPU to 2e-5
     (moe and mla 1e-4, at its capacity and at 8 slots an expert, its
     routes and kept masks equal away from near ties; mla's prefill on the
     mma_sync kernel at (48, 32), its decode none); then the training path (line ``train``):
     internlm2-1.8b at full width (fp32 params, bf16 compute, remat
     "full", AdamW with bf16 moments, 2 microbatches), 1 warm-up and 3
     timed steps on batches of 8 x 4096 tokens that ``AerialPipeline``
     draws by store queries on the card: loss, grad norm, lr, step ms,
     tokens/s and the share of the 6 N T FLOP bound, peak memory, launches
     by kernel against ``TRAIN_PER_STEP`` (every backward call on the sm90
     backward, none on the mma_sync one); fatal: finite losses and norms,
     every leaf changed by step 1, every layer's wq/wk/wv gradient nonzero,
     two backward calls held to the plain version on the tensors the model
     passed them, and a second run from the seed bitwise after 2 steps;
     then the MoE and MLA training path (line ``train_dsv2``, the same
     function): deepseek-v2-236b at full width cut to 2 of its 60 layers
     (its dense first layer and one MoE layer of 160 experts top-6 + 2
     shared; 5.52e9 parameters), 1 x 4096 tokens a step in one
     microbatch: launches against ``TRAIN_DSV2_PER_STEP`` (the sm90
     forward at (192, 128) 4, the sm90 backward 2 calls), the FLOP
     bound by part (``train_flops``) beside AdamW's bytes, peak memory;
     fatal: step 1's two backward calls held to the plain version on the
     model's tensors, every MLA, dense-MLP, gate and shared-expert leaf's
     gradient nonzero, each routed expert's exactly where it kept a pair,
     and the bitwise second run;
     then ``train_vs_cpu``: examples/train_lm.py's lm-8m config, two steps
     on the card in fp32 against a float64 CPU run (losses to 1e-5,
     gradients to 1e-4 of each leaf's largest magnitude), in bf16 (losses
     to 2e-2; gradients against the same port code in bf16 on the CPU at
     the card's params, each leaf to ``TRAIN_GRAD_BF16_TOL`` in norm, and
     a control with a faulty backward that must exceed it), every backward
     call held to the plain version on the model's tensors and taken by
     the mma_sync backward (d 32), the pipeline's batches card against
     CPU, and the example's restart (6 steps against 3 + checkpoint +
     restore + 3) bitwise; then ``moe_train_vs_cpu``: deepseek-v2's and
     grok-1's smoke models trained two steps on the card in fp32 against
     float64 on the CPU, in both dispatch modes and with drops (losses to
     1e-5, gradients to 1e-4, routes equal away from near ties, every
     backward call held), beside a control whose backward zeroes dV;
     then the examples line: the six ported datastore
     and serving examples (``repro_torch.examples``: quickstart, query API
     tour, disaster analytics, federated quickstart, streaming ingest,
     serve_lm) at the reference's own sizes on the card, each held to its
     own run on the CPU (integers, ids and audits bitwise, means and sums
     to rtol 1e-5; serve_lm's logits, the CPU run fed the card's ids,
     within 0.1, by ``serve_lm.compare``), every flash call of a card run
     held to its plain version on its own tensors, the launches by kernel
     and flash variant from the counts reset around each example (st_scan,
     hash64 and voronoi_assign in every datastore example but the
     streaming one, whose only query reads the latest cache; a flash
     kernel in serve_lm), each card and CPU wall, the control (serve_lm
     with its decode results' heads swapped must be refused by both
     holds) and a profile of the disaster and serve_lm card runs; then
     the small_case_timings line: st_scan on the disaster example's own
     scan inputs, the decode kernel at serve_lm's last step, and
     flash_attention.cu and flash_attention_bwd.cu at lm-8m's shape (fp32
     and bf16), each beside its bound, its plain version and SDPA where it
     computes the same function (also in the kernels line);
  7. flash_attention timings at each serve path's prefill shape (sm90 and
     mma_sync, both forced) and at two decode shapes, 192 of 256 slots and
     4096 of 4096 (decode and mma_sync, both forced), at d 128, at d 160
     and at d 64 (zamba2-1.2b's 32 heads over 32), each beside SDPA and the
     bytes or operations bound, and grok-1-314b's 48 heads over 8 at d 128
     (its sm90 prefill and 192-key decode only), deepseek-v2-236b's (192,
     128) prefill (sm90 and mma_sync, forced, beside SDPA and the backends
     that take d_v != d_qk) and the mma_sync kernel in fp32 at the
     dense-layer check's (192, 128) and mla_vs_cpu's (48, 32) shapes,
     the profiles each device time took, and the
     kernels' timings printed as one JSON line (the three flash kernels
     once at each head dim, with ``_d160`` and ``_d64`` names); both
     backward kernels, forced and in turns, at one
     microbatch of the train phase (4 x 4096, 16 heads over 8, d 128,
     causal, bf16), each by its own kernels' names, beside SDPA's backward,
     the plain version and the FLOP bound (``flash_timings.bwd``, the
     ``flash_attention_bwd_sm90`` and ``flash_attention_bwd`` entries of
     the kernels line); and both backward kernels, forced and in turns, at
     train_dsv2's call (1 x 4096, 128 heads, q/k 192 and v 128, causal,
     bf16) beside SDPA's memory-efficient backward, the plain version and
     the FLOP bound (``flash_timings.bwd_mla``, the kernels line's
     ``flash_attention_bwd_mla``: the sm90 backward, which takes that
     call, with the mma_sync one's times beside it).
The last line is {"ok": true, "device": {...}}; any failure exits non-zero
before it. Imports only torch, numpy and the port (``src/repro_torch``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
from collections import Counter
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM data sheet, outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM data sheet, dense tensor cores
QUERY_SIZES = ((0.2, 300.0), (1.0, 1800.0), (5.0, 7200.0))   # paper §4.5.1
RECENT_S = 1800.0              # windows retained on every replica
# The resilience phase's ring: the main path's 2^18 slots wrap on the dead
# domain's successor edge (40 takes the block's spatial and id replicas:
# `resilience.tup_count_max`), and content equality needs no wrap.
RESILIENCE_CAPACITY = 1 << 19
# The resilience phase's partition leg: a cut along the failure-domain
# blocks (domain 3 unreachable), so every shard keeps a reachable replica.
SPLIT_GROUPS = (list(range(60)), list(range(60, 80)))
PER_EDGE_LEAVES = ("tup_f", "tup_sid", "tup_count", "tup_pos",
                   "tup_overwritten", "tup_dropped")
# The streaming phase: 48 rounds of the D400 fleet as a drone stream, made
# adversarial as benchmarks/fig18_streaming_ingest.py makes it.
STREAM_ROUNDS = 48
STREAM_BURSTS = 4
DUP_FRAC, DROP_FRAC, PARTIAL_FRAC = 0.03, 0.02, 0.05
FAULT_FRAC = 0.05              # dispatch attempts that raise a transient fault
# The chaos phase: fig. 19's soak (benchmarks/fig19_chaos_soak.py:100-150)
# at D400 width, FaultPlan.random over the 80 edges and 4 failure domains,
# one D400 round a step; fig. 19's default seeds.
CHAOS_SEEDS = (3, 11, 42)
CHAOS_STEPS = 16
CHAOS_MIN_ALIVE = 30           # alive AND reachable floor (>= replication 3)
CHAOS_REPAIRS = ("heal", "recover_edges", "recover_device")
# The reference chaos tests' smoke plan (tests/test_chaos.py, 8 edges):
# (step, kind, args) rows over 4 steps.
CHAOS_SMOKE = ((0, "fail_edges", ((6,),)),
               (1, "partition", (((0, 1, 2, 3, 6), (4, 5, 7)),)),
               (1, "flush_fail", (2,)),
               (2, "heal", ()),
               (3, "recover_edges", ((6,),)))
SERVE_ARCH = "internlm2-1.8b"
SERVE_D160_ARCH = "stablelm-12b"   # the serve path at head dim 160
# Depth cuts that keep the script within its time as paths were added,
# each model at full width: internlm2-1.8b is served with 6 of its 24
# layers, stablelm-12b with 5 of its 40, falcon-mamba-7b with 8 of its 64
# and zamba2-1.2b with 26 of its 38 (four sites of its shared block and a
# trailing group of two; SERVE_HYBRID_LAYERS) (a serve's prefill, decode
# steps and generates take time in proportion to its layers; the last cuts
# pay for grok-1-314b's serve and moe_vs_cpu). The training path keeps
# internlm2's 24.
SERVE_LAYERS = 6
SERVE_D160_LAYERS = 5
SERVE_SSM_LAYERS = 8
SERVE_BATCH = 8
PREFILL_LEN = 2048
PROMPT_LEN, NEW_TOKENS, MAX_SEQ = 128, 64, 256
LONG_SEQ = 4096                # the long-cache decode row
FLASH_BF16_TOL = 1e-2          # bf16 outputs of order 1: ulp 0.0078
FLASH_F32_TOL = 2e-5           # as the JAX package's kernel tests
# The training path: internlm2-1.8b at full width, batches of 8 x 4096
# tokens (the reference's train_4k sequence length; its 256 sequences cut
# to 8 for one card) from the AerialDB pipeline, in 2 microbatches.
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 8, 4096, 2
TRAIN_TIMED = 3                # steps after the warm-up step
# Launches of each kernel a step: the flash forward a layer, a microbatch,
# and once more for the remat recompute in the backward; the backward once
# a layer and microbatch; the pipeline's one query batch a step.
TRAIN_PER_STEP = {"sm90": 2 * 24 * TRAIN_MICRO, "decode": 0, "mma_sync": 0,
                  "bwd": 24 * TRAIN_MICRO, "bwd_sm90": 24 * TRAIN_MICRO,
                  "bwd_mma_sync": 0, "st_scan": 1, "hash64": 2,
                  "voronoi_assign": 1}
# The backward kernel against its plain version (flash_vs_plain):
# (b, sq, skv, h, kv, causal, q_offset) at every head dim, in fp32 and bf16,
# tolerances relative to each gradient's largest magnitude.
BWD_CASES = [(2, 200, 200, 4, 4, True, 0), (2, 200, 200, 8, 4, False, 0),
             (1, 256, 256, 16, 8, True, 0), (2, 77, 131, 4, 2, True, 54),
             (2, 77, 131, 4, 2, False, 0)]
BWD_F32_TOL, BWD_BF16_TOL = 2e-5, 2e-2
# The sm90 backward (bf16, d 128) across several tiles in both directions:
# GQA groups 1 and 8, causal and not, q_offset > 0 with Sq < Skv.
BWD_SM90_CASES = [(1, 1024, 1024, 8, 8, True, 0), (1, 1024, 1024, 16, 2, False, 0),
                  (2, 512, 1536, 4, 2, True, 1024)]
# The backward's timing shape: one microbatch of the train phase, (b, s,
# h, kv, d_qk, d_v), causal, bf16.
BWD_TIMING = (4, TRAIN_SEQ, 16, 8, 128, 128)
# train_vs_cpu: the card's losses and gradients against a float64 CPU run.
TRAIN_LOSS_F32_TOL, TRAIN_GRAD_TOL, TRAIN_LOSS_BF16_TOL = 1e-5, 1e-4, 2e-2
# bf16 gradients on the card against the same port code in bf16 on the CPU
# (the plain flash forward and backward) at the card's params: each leaf's
# ||card - cpu|| / ||cpu||. The kernel rounds P and dS to bf16 where the
# plain version keeps fp32, which alone gives 1.0e-2 on this config (a CPU
# replay); a backward whose dk has its kv heads swapped gives 0.30-1.41.
TRAIN_GRAD_BF16_TOL = 5e-2
# Engine logits after the last prompt token vs prefill_step's, bf16 through
# a dense serve's layers: the two round activations at different matmul shapes, so
# they agree to a fraction of the logits' unit spread, not bitwise.
PREFILL_DECODE_TOL = 0.5
# The ssm family's serve path: falcon-mamba-7b (Mamba1, attention-free) at
# full width, bf16 weights.
SERVE_SSM_ARCH = "falcon-mamba-7b"
# Its bf16 run cannot be held to PREFILL_DECODE_TOL at the largest logit:
# deep stacks of random Mamba1 layers (64 in its config, SERVE_SSM_LAYERS
# served here) amplify the rounding in which the chunked scan
# and the step-by-step decode differ, in the JAX package itself
# (tests/test_torch_mamba.py::test_bf16_deep_stack_parts_at_the_largest_logit:
# its forward against its decode at d_model 128 x 64 layers in bf16, up to
# 1.14 on logits of unit spread). The mean gap holds it there (at most
# 0.128, against 0.93 and more for a decode that zeroes its scan state in
# its last 16 steps), so the check is the mean, beside that control run on
# the card (SSM_CONTROL_STEPS steps again from the engine's cache with the
# state zeroed before each, which must exceed it). The full-width shapes
# are held tightly in fp32, the depth cut to SSM_F32_CUT_LAYERS:
# prefill_step against decode_step over the prompt.
SSM_PREFILL_DECODE_MEAN_TOL = 0.5
SSM_CONTROL_STEPS = 16
SSM_F32_CUT_LAYERS = 2
SSM_F32_PREFILL_DECODE_TOL = 1e-3
# Temperature sampling: serve_sampled draws internlm2-1.8b's continuation
# at this temperature with these seeds (twice seed 0: equal ids; seed 1:
# other ids); falcon-mamba-7b's generate line samples once with seed 0.
SAMPLE_TEMPERATURE = 0.7
SAMPLE_SEEDS = (0, 0, 1)
# ssm_vs_cpu: falcon-mamba-7b's smoke model in fp32 on the card against
# its float64 CPU run (the scan in float32 on both, as the reference pins
# it), forward on 2 x 64 tokens and SSM_DECODE_STEPS decode steps, to
# SSM_F64_TOL (test_smoke_model_on_card_matches_cpu's bound).
SSM_DECODE_STEPS = 40
SSM_F64_TOL = 2e-5
# The hybrid family's serve path: zamba2-1.2b at full width, bf16 weights;
# its shared attention block is the sm90 kernel's d 64 case. Its bf16 run
# parts at the largest logit too: 1.04 from prefill_step's through 38
# Mamba2 layers and 6 shared-block sites on an H100, and in the JAX
# package's own bf16 forward against its decode
# (tests/test_torch_hybrid.py::test_bf16_deep_hybrid_parts_at_the_largest_logit),
# so it is held as the ssm family is, to its own mean limit
# HYBRID_PREFILL_DECODE_MEAN_TOL: the sound run's mean gap read 0.169 on an
# H100 80GB HBM3 at 700 W, and a decode that loses only its scan state `h`
# in its last SSM_CONTROL_STEPS steps 1.002, which must exceed the limit
# (so must the control that zeroes every cache leaf, K/V slots too: 1.127);
# and
# fp32 at full width with the depth cut to HYBRID_F32_CUT_LAYERS: one group
# of six Mamba2 layers, the shared block, and a last layer after it (the
# trailing group the full stack ends with).
SERVE_HYBRID_ARCH = "zamba2-1.2b"
SERVE_HYBRID_LAYERS = 26
HYBRID_PREFILL_DECODE_MEAN_TOL = 0.25
HYBRID_F32_CUT_LAYERS = 7
# The moe family's serve path: grok-1-314b at full width (d_model 6144, 48
# query heads over 8 at d 128, 8 experts of width 32768, top-2, vocab
# 131072), 2 of its 64 layers: a layer holds 4.92e9 parameters, 9.84 GB in
# bf16, so 64 do not fit one card; 2 layers, the embedding and the
# unembedding are 11.45e9 (22.9 GB), drawn in bf16. Its prefill-vs-decode
# check is the dense one (PREFILL_DECODE_TOL at the largest logit) where
# that holds. In bf16 a tiny difference upstream can swap a token's second
# and third experts, which moves the logits by an expert's output, not by
# rounding; the JAX package's own bf16 forward and decode part so, at the
# tokens and layers where their routes part
# (tests/test_torch_moe.py::test_bf16_moe_parts_at_the_largest_logit: 1.72
# at d_model 128, 2 layers). So where the largest gap exceeds the limit and
# routes parted (or the prompt's prefill dropped pairs, which a decode step
# never does), the check is the mean gap, to MOE_PREFILL_DECODE_MEAN_TOL,
# beside a control that zeroes the K/V cache in the last SSM_CONTROL_STEPS
# prompt steps, which must exceed it (the JAX test: the sound mean
# 0.011-0.160, the control 1.08-1.15).
SERVE_MOE_ARCH = "grok-1-314b"
GROK_SERVE_LAYERS = 2
MOE_PREFILL_DECODE_MEAN_TOL = 0.25
# moe_vs_cpu: grok's smoke model in fp32 on the card against float64 on the
# CPU, to MOE_F64_TOL, at its own capacity factor and at MOE_CAP8_FACTOR,
# which gives the forward's 128 tokens 8 slots an expert (drops); routes
# and kept masks equal away from tokens whose k-th and (k+1)-th routing
# probabilities lie within MOE_TIE.
MOE_F64_TOL = 1e-4
MOE_CAP8_FACTOR = 0.01
MOE_TIE = 1e-5
# The MLA family's serve path: deepseek-v2-236b at full width (d_model
# 5120, 128 heads of q/k 192 = nope 128 + rope 64 and v 128 over a
# kv_lora 512 latent cache, 160 experts of width 1536 top-6 and 2 shared,
# a leading dense layer at 12288, vocab 102400), 3 of its 60 layers: the
# dense one and two MoE (9.57e9 parameters, 19.1 GB in bf16; an MoE layer
# is 4.05e9). Its prefill attends over the expanded K/V (the sm90 kernel at
# (192, 128)), its decode in the latent space (torch ops, no flash
# kernel), so the two round differently; held as grok's (PREFILL_DECODE_TOL
# at the largest logit where it holds, else the mean where routes parted
# beside a control that zeroes the latent cache: the JAX package's own
# bf16 deepseek-v2 parts so, tests/test_torch_mla.py::
# test_bf16_mla_parts_at_the_largest_logit), and fp32 at full width cut
# to MLA_F32_CUT_LAYERS, the dense layer alone (1.47e9 parameters), to
# SSM_F32_PREFILL_DECODE_TOL (its prefill on the mma_sync kernel at (192,
# 128)).
SERVE_MLA_ARCH = "deepseek-v2-236b"
DSV2_SERVE_LAYERS = 3
MLA_F32_CUT_LAYERS = 1
# The MoE and MLA training path (train_dsv2): deepseek-v2-236b at full
# width cut to 2 of its 60 layers, its dense first layer and one MoE layer
# (5.52e9 parameters: fp32 params and grads and bf16 moments, 66.2 GB), on
# batches of 1 x 4096 tokens (train_4k's sequence, its 256 sequences cut to
# 1 for one card) in one microbatch. A step launches the sm90 forward at
# (192, 128) twice a layer (the forward and the remat recompute) and the
# sm90 backward at (192, 128) once a layer (the mma_sync backward not at
# all: it keeps fp32, (48, 32) and calls under 64 rows or keys).
TRAIN_DSV2_LAYERS = 2
TRAIN_DSV2_BATCH, TRAIN_DSV2_SEQ = 1, 4096
TRAIN_DSV2_PER_STEP = {"sm90": 2 * TRAIN_DSV2_LAYERS, "decode": 0, "mma_sync": 0,
                       "bwd": TRAIN_DSV2_LAYERS, "bwd_sm90": TRAIN_DSV2_LAYERS,
                       "bwd_mma_sync": 0, "st_scan": 1, "hash64": 2,
                       "voronoi_assign": 1}
# flash_bwd_vs_plain's one long case at (192, 128): 1 x 1024, 16 heads over
# 16, causal; and the MLA backward's timing shape, train_dsv2's call:
# (b, s, h, kv, d_qk, d_v), causal, bf16.
BWD_MLA_LONG = (1, 1024, 1024, 16, 16, True, 0)
BWD_MLA_TIMING = (TRAIN_DSV2_BATCH, TRAIN_DSV2_SEQ, 128, 128, 192, 128)
# A voronoi_assign visit as compiled for sm_90a (csrc/voronoi_assign.cu
# `visit`): FMUL, FMUL, FADD, FMUL by 2, FADD, then FSETP, FSEL, SEL. A
# static count, read by hand in the kernel's SASS, not measured in a run.
VISIT_INSTRUCTIONS = 8
VORONOI_SOURCE = Path(__file__).resolve().parent / "src/repro_torch/csrc/voronoi_assign.cu"
# Profiles a device_ms call takes before it gives up on the profiler. Late
# in a run the card's profiles record no device activity at all more often
# (calls 35-56 of a run needed a second or third; a d 64 timing found none
# in three, SDPA's at d 64 none in six, on an H100 80GB HBM3 at 700 W). A
# call whose profiles all recorded nothing on the device times ``fn`` with
# CUDA events instead (DEVICE_MS_EVENTS); one whose profiles saw the
# device but not its kernel fails.
DEVICE_MS_TRIES = 3
# Indices of the device_ms calls timed by CUDA events.
DEVICE_MS_EVENTS: list[int] = []
# Profiles taken by each device_ms call, in call order (more than one: a
# profile recorded no device time for the kernel and was taken again).
DEVICE_MS_PROFILES: list[int] = []
# (launches the profile recorded, calls made) of each device_ms call.
DEVICE_MS_RECORDED: list[tuple[int, int]] = []


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def host_us(torch, fns: dict, calls: int = 100, rounds: int = 7) -> dict:
    """The host's time a call of each of ``fns`` (a name -> callable), in
    µs: perf_counter around ``calls`` calls that nothing waits on, the
    median of ``rounds`` rounds taken in turns. While the card keeps up
    with the calls, this is the wrapper's own cost on the host."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times[name].append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return {name: float(np.median(t)) for name, t in times.items()}


def _device_rows(torch, prof):
    """(device µs, calls, name) of each device activity of a profile;
    CUPTI's own buffer markers are not work."""
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or "Buffer" in ev.key:
            continue
        yield (getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0)), ev.count, ev.key)


def device_ms(torch, fn, iters: int, match: str | None = None) -> float:
    """Device time a call of ``fn`` (torch.profiler) over ``iters`` calls:
    the mean time a launch of the device kernels whose name holds
    ``match``, or, when None, the sum over every device activity of its
    mean time a launch times its launches a call. Means are taken over the
    launches the profile recorded, which may be fewer than were made (a
    profile can drop records); the shortfall is kept in
    DEVICE_MS_RECORDED. When none of DEVICE_MS_TRIES profiles recorded any
    device time, the mean time of a call on the stream (CUDA events;
    every kernel of ``fn``), and its index goes to DEVICE_MS_EVENTS. Exits
    non-zero when the profiles saw the device but no such kernel; appends
    the profiles it took to DEVICE_MS_PROFILES."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    seen = False
    for taken in range(1, DEVICE_MS_TRIES + 1):   # a profile may record no device activity
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        every = [(t, n, key) for t, n, key in _device_rows(torch, prof) if n and t > 0]
        seen = seen or bool(every)
        rows = [(t, n) for t, n, key in every if match is None or match in key]
        us = sum(t for t, _ in rows)
        if us > 0:
            DEVICE_MS_PROFILES.append(taken)
            if match is not None:
                n = sum(n for _, n in rows)
                DEVICE_MS_RECORDED.append((n, iters))
                return us / n / 1e3
            DEVICE_MS_RECORDED.append((min(n for _, n in rows), iters))
            return sum(t / n * max(1, round(n / iters)) for t, n in rows) / 1e3
    if seen:
        raise SystemExit(f"device_ms: no device time for kernel {match!r}")
    DEVICE_MS_EVENTS.append(len(DEVICE_MS_PROFILES))
    DEVICE_MS_PROFILES.append(DEVICE_MS_TRIES)
    DEVICE_MS_RECORDED.append((iters, iters))
    return cuda_ms(torch, fn, iters)


def profile(torch, fn, top: int = 12, host_top: int = 0, kernels=()) -> dict:
    """Wall time of one ``fn()`` (synchronised, after a warm-up call) and its
    device time by kernel name (torch.profiler), with the device's busy
    share; with ``host_top``, also the operators that took the most host
    time (self CPU µs, calls), the only use of the host's activity, which
    is recorded for it alone; for each name in ``kernels``, the device ms
    and launches of the kernels whose name holds it, and the ms a
    launch."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]
                  + ([ProfilerActivity.CPU] if host_top else [])) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side activities only (CPU ops would count their kernels twice).
    rows = sorted(((us / 1e3, n, key[:60])
                   for us, n, key in _device_rows(torch, prof) if us > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
           "device_launches": sum(r[1] for r in rows),
           "top": [{"ms": ms, "calls": n, "name": k} for ms, n, k in rows[:top]]}
    if kernels:
        out["kernels"] = {}
        for name in kernels:
            ms, n = (sum(r[i] for r in rows if name in r[2]) for i in (0, 1))
            out["kernels"][name] = {"ms": ms, "launches": n,
                                    "ms_per_launch": ms / n if n else None}
    if host_top:
        ops = sorted(((ev.self_cpu_time_total, ev.count, ev.key)
                      for ev in prof.key_averages()
                      if ev.device_type == torch.autograd.DeviceType.CPU),
                     reverse=True)
        out["host_top"] = [{"us": us, "calls": n, "name": k[:60]}
                           for us, n, k in ops[:host_top]]
    return out


def voronoi_visits(torch, vor_ops, lat, lon, sites) -> dict:
    """The sites ``voronoi_assign``'s kernel visits a point, from the packed
    site set and the kernel's source: ``listed``, the mean length of the
    points' cell lists (E outside the grid), what the data needs; and
    ``issued``, the visits a point's warp issues, 32 consecutive points a
    warp as the kernel's grid-stride loop takes them: kAhead predicated
    visits and then the rest of the warp's longest list when a lane is in
    the grid, plus all E sites when a lane is outside it."""
    ahead = int(re.search(r"constexpr int kAhead = (\d+);",
                          VORONOI_SOURCE.read_text()).group(1))
    e = sites.shape[0]
    listed = vor_ops.listed_sites(lat, lon, sites).reshape(-1).long()
    inside = vor_ops.locate(lat, lon, sites)[2].reshape(-1)
    n = listed.numel()
    pad = -n % 32
    real = torch.nn.functional.pad(torch.ones_like(inside), (0, pad)).view(-1, 32)
    inside = torch.nn.functional.pad(inside, (0, pad)).view(-1, 32) & real
    longest = torch.where(inside, torch.nn.functional.pad(listed, (0, pad)).view(-1, 32),
                          0).amax(1)
    warp = (inside.any(1) * longest.clamp(min=ahead)
            + (real & ~inside).any(1) * e)
    return {"listed": float(listed.float().mean()),
            "issued": float((warp * real.sum(1)).sum() / n), "ahead": ahead}


START_S = time.perf_counter()


def phase(name: str, **fields) -> None:
    """One result line; ``t_s`` is the script's wall seconds when it ends."""
    print(json.dumps({"phase": name, **fields,
                      "t_s": time.perf_counter() - START_S}), flush=True)


def exact_checks(results, batches, specs, flat) -> tuple:
    """Every answer of ``results`` ((batch, spec) -> (QueryResult,
    QueryInfo)) has its shape and finite aggregates where it matched; on
    the recent batches (windows retained on every replica) each count
    equals the numpy oracle over ``flat`` (the generated tuples) and each
    sum agrees to rtol 1e-5. Exits non-zero otherwise; returns (queries
    checked, queries skipped for overflow)."""
    checked = overflowed = 0
    for (bi, si), (res, info) in results.items():
        k = specs[si].n_channels
        assert res.count.shape == (64,) and res.vsum.shape == ((64,) if k == 1 else (64, k))
        cnt = res.count.cpu().numpy()
        some = cnt > 0
        for a in (res.vsum, res.vmin, res.vmax, res.vmean):
            a = a.cpu().numpy().reshape(64, -1)
            if not np.isfinite(a[some]).all():
                raise SystemExit("non-finite aggregate on a matching query")
        km, win, recent, w = batches[bi]
        if not recent:
            continue
        ovf = res.overflow.cpu().numpy()
        vs = res.vsum.cpu().numpy().reshape(64, -1)
        for qi in range(64):
            if ovf[qi]:
                overflowed += 1
                continue
            m = ((w["lat0"][qi] <= flat[:, 1]) & (flat[:, 1] <= w["lat1"][qi])
                 & (w["lon0"][qi] <= flat[:, 2]) & (flat[:, 2] <= w["lon1"][qi])
                 & (w["t0"][qi] <= flat[:, 0]) & (flat[:, 0] <= w["t1"][qi]))
            if int(m.sum()) != int(cnt[qi]):
                raise SystemExit(f"batch {bi} query {qi}: count {cnt[qi]} != "
                                 f"oracle {int(m.sum())}")
            want = flat[m][:, 3:3 + k].sum(0)
            np.testing.assert_allclose(vs[qi], want, rtol=1e-5)
            checked += 1
    return checked, overflowed


def planners_phase(torch, dev, cfg, db, batches, specs, flat, seed: int,
                   do_profile: bool, main_results, main_times) -> dict:
    """Fig. 9's planners on the main path's store: one session per planner
    (``random`` with its key from ``seed``, then ``min_edges``) over the
    same state, running the main path's 3 batches x 2 specs three times,
    the first as the warm-up. Per planner: the batch p50, the mean
    ``subquery_edges`` and ``max_shards_per_edge`` of each batch (fig. 9's
    derived axes), each kernel's launches during its run (counts set to 0
    just before it, read just after; every kernel must launch) and the
    exact checks of the main path; ``min_shards`` gives the same axes
    from the main path's own run (``main_results``, ``main_times``). Then
    the random planner on the card
    against the CPU: the threefry bits and uniforms of its first query's
    (Q, S, 3) draw bitwise, and its plan for each batch's MatchedShards
    away from near-ties (top two CPU gumbels of a shard's usable replicas
    under 1e-5 apart, counted). Exits non-zero on any mismatch."""
    import dataclasses
    from repro_torch.api.session import AerialDB
    from repro_torch.core import planner, threefry
    from repro_torch.core.datastore import _lookup_sets, make_pred
    from repro_torch.core.index import MatchedShards, lookup
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops
    mods = {"hash64": hash64_ops, "voronoi_assign": vor_ops, "st_scan": st_ops}
    preds = [make_pred(q=64, **w, has_spatial=True, has_temporal=True,
                       is_and=True, device=dev) for *_, w in batches]
    out, sessions = {"min_shards": {
        "from_main_path": True,
        "query_batch_p50_ms": float(np.median(main_times)),
        "subquery_edges_mean": [float(np.mean([
            main_results[(bi, si)][1].subquery_edges.float().mean().item()
            for si in range(len(specs))])) for bi in range(len(batches))],
        "max_shards_per_edge_mean": [float(np.mean([
            main_results[(bi, si)][1].max_shards_per_edge.float().mean().item()
            for si in range(len(specs))])) for bi in range(len(batches))]}}, {}
    for name in ("random", "min_edges"):
        sess = AerialDB(dataclasses.replace(cfg, planner=name), db.state,
                        device=dev, seed=seed)
        sessions[name] = sess
        results, times = {}, []
        edges, shards = ([[] for _ in batches] for _ in range(2))
        for mod in mods.values():
            mod.launches = 0
        for rep in range(3):
            for bi, pred in enumerate(preds):
                for si, spec in enumerate(specs):
                    torch.cuda.synchronize()
                    q0 = time.perf_counter()
                    res, info = sess.query(pred, agg=spec)
                    torch.cuda.synchronize()
                    if rep > 0:            # repetition 0 is the warm-up
                        times.append((time.perf_counter() - q0) * 1e3)
                        edges[bi].append(float(info.subquery_edges.float().mean()))
                        shards[bi].append(float(info.max_shards_per_edge.float().mean()))
                    results[(bi, si)] = (res, info)
        launches = {k: m.launches for k, m in mods.items()}
        if min(launches.values()) <= 0:
            raise SystemExit(f"planner {name}: a kernel never launched: {launches}")
        checked, overflowed = exact_checks(results, batches, specs, flat)
        out[name] = {"query_batch_p50_ms": float(np.median(times)),
                     "query_batch_ms": times,
                     "subquery_edges_mean": [float(np.mean(e)) for e in edges],
                     "max_shards_per_edge_mean": [float(np.mean(x)) for x in shards],
                     "launches": launches, "queries_checked_exact": checked,
                     "queries_overflowed": overflowed}

    # The random planner on the card against the CPU. Its session's first
    # query took the second half of the first split of key(seed).
    s = cfg.max_shards_per_query
    k1 = threefry.split(threefry.key(seed))[1]
    qkeys = threefry.fold_in(k1, torch.arange(64, device=dev))
    qkeys_cpu = threefry.fold_in(k1, torch.arange(64))
    if not torch.equal(qkeys.cpu(), qkeys_cpu):
        raise SystemExit("threefry: the folded keys differ on the card")
    card_draw, cpu_draw = ((threefry.random_bits(k, (s, 3)).cpu(),
                            threefry.uniform(k, (s, 3), threefry.F32_TINY).cpu()
                            .view(torch.int32)) for k in (qkeys, qkeys_cpu))
    draw_bad = sum(int((a != b).sum()) for a, b in zip(card_draw, cpu_draw))
    if draw_bad:
        raise SystemExit(f"threefry: {draw_bad} bits or uniforms differ on the card")
    g_cpu = threefry.gumbel(qkeys_cpu, (s, 3))
    g_err = float((threefry.gumbel(qkeys, (s, 3)).cpu() - g_cpu).abs().max())
    alive = sessions["random"].alive
    plan_shards = near_ties = plan_bad = 0
    for pred in preds:
        lookup_mask, _ = _lookup_sets(cfg, pred, cfg.sites_array(dev), alive)
        matched = lookup(db.state.index, pred, lookup_mask, s)
        m_cpu = MatchedShards(*(f.cpu() for f in matched))
        card = planner.plan_random(matched, alive, k1).cpu()
        cpu = planner.plan_random(m_cpu, alive.cpu(), k1)
        ok = planner._alive_replica_mask(m_cpu, alive.cpu())
        top = torch.where(ok, g_cpu, -1e30).sort(dim=-1).values
        near = (ok.sum(-1) >= 2) & (top[..., -1] - top[..., -2] < 1e-5)
        plan_shards += int(m_cpu.valid.sum())
        near_ties += int(near.sum())
        plan_bad += int(((card != cpu) & ~near).sum())
    if plan_bad:
        raise SystemExit(f"plan_random: {plan_bad} picks differ on the card")

    # The draw a random-planner batch adds: the fold of 64 query keys and
    # the (64, S, 3) gumbels, as plan_random makes them.
    def draw():
        return threefry.gumbel(threefry.fold_in(k1, torch.arange(64, device=dev)),
                               (s, 3))
    out["random"]["threefry_draw"] = {
        "ms": cuda_ms(torch, draw, 20),
        "host_us": host_us(torch, {"draw": draw}, calls=20)["draw"]}
    if do_profile:
        prof = profile(torch, draw)
        out["random"]["threefry_draw"].update(
            device_ms=prof["device_busy_ms"], launches=prof["device_launches"],
            device_idle_share=prof["device_idle_share"])
        out["random"]["profile_query"] = profile(
            torch, lambda: sessions["random"].query(preds[2], agg=specs[1]))
    out["card_vs_cpu"] = {"draw_elements": 64 * s * 3, "draw_mismatch": 0,
                          "gumbel_max_abs_err": g_err,
                          "plan_shards": plan_shards, "plan_near_ties": near_ties,
                          "plan_mismatch_away_from_ties": 0}
    return out


def bitwise_equal(torch, a, b) -> bool:
    """Same shape, dtype and bits (a NaN equals a NaN of the same bits)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def latest_phase(torch, dev, cfg, db, fleet, payloads, metas, chunks,
                 batches, specs, seed: int, do_profile: bool) -> tuple:
    """The latest-per-drone cache on a second D400 store (``max_drones``
    400, drone ids 0-399 as ``sid_hi``): the main path's rounds in the same
    chunks, timed as the main path times them; then the cache against the
    vectorised oracle over every record ingested (record, last_seen and
    valid bitwise), every other state leaf against the main path's store
    (``torch.equal``), one 4-channel 5 km batch on both stores (every
    field bitwise), and the host µs of ``latest()`` and of
    ``query(Query().latest())`` (median of 100 calls each). Then one crafted
    round at D400 width (``latest_edge_round``: tied duplicate ids, a t
    equal to the cached row's, NaN and +-inf t, ids -1, 400 and 407, NaN
    channels), held against the oracle and against the same update run on
    the CPU, bitwise. Counts are set to 0 before the ingest and read after
    the batch; every kernel must launch. Also one ``_update_latest`` call
    at a round's shape on copies of the cache: its call ms (CUDA events)
    and host µs, and under ``do_profile`` its profile with the operators
    that took the most host time. Returns (fields, store). Exits non-zero
    on any mismatch."""
    import dataclasses
    from repro_torch.api.query import Query
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import _update_latest, make_pred
    from repro_torch.data.synthetic import latest_edge_round
    from repro_torch.ingest.latest import latest_oracle_sorted
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops
    mods = {"hash64": hash64_ops, "voronoi_assign": vor_ops, "st_scan": st_ops}
    d = fleet.n_drones
    lcfg = dataclasses.replace(cfg, max_drones=d)
    for mod in mods.values():
        mod.launches = 0
    ldb = AerialDB.open(lcfg, device=dev)

    def ingest(sl):
        ldb.ingest_rounds(payloads[sl], type(metas)(*(f[sl] for f in metas)))

    ingest(chunks[0])                  # warm-up chunk, not timed
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for sl in chunks[1:]:
        ingest(sl)
    ev1.record()
    ev1.synchronize()
    timed_rounds = chunks[-1].stop - chunks[0].stop
    ingest_s = ev0.elapsed_time(ev1) / 1e3
    pred = make_pred(q=64, **batches[2][3], has_spatial=True, has_temporal=True,
                     is_and=True, device=dev)
    res_l, info_l = ldb.query(pred, agg=specs[1])
    launches = {k: m.launches for k, m in mods.items()}
    if min(launches.values()) <= 0:
        raise SystemExit(f"latest: a kernel never launched: {launches}")
    res_m, info_m = db.query(pred, agg=specs[1])
    batch_bad = [f for got, want in ((res_l, res_m), (info_l, info_m))
                 for f in want._fields
                 if not bitwise_equal(torch, getattr(got, f), getattr(want, f))]
    if batch_bad:
        raise SystemExit(f"latest: the 5 km batch differs on the cached store: {batch_bad}")

    # every state leaf but the cache equals the main path's store
    cache = ("latest_f", "latest_seen")
    leaf_bad = states_equal(torch, ldb.state, db.state, skip=cache)
    if leaf_bad:
        raise SystemExit(f"latest: the cache perturbed state leaves {leaf_bad}")

    def check(rows, ids, per_step, what):
        """The cache against the oracle over ``rows`` (N, W) with drone ids
        ``ids`` (N,), ``per_step`` records an insert; returns rows checked."""
        want_rec, want_valid, src = latest_oracle_sorted(ids, rows[:, 0], rows, d)
        got = ldb.latest()
        want_seen = np.where(want_valid, src // per_step + 1, -1)
        rec = got.record.cpu().numpy()
        bad = {"record": int((rec.view(np.int32) != want_rec.view(np.int32)).any(1).sum()),
               "last_seen": int((got.last_seen.cpu().numpy() != want_seen).sum()),
               "valid": int((got.valid.cpu().numpy() != want_valid).sum())}
        if any(bad.values()) or got.last_seen.dtype != torch.int32:
            raise SystemExit(f"latest ({what}): rows apart from the oracle {bad}")
        return int(want_valid.sum())

    n_rounds = chunks[-1].stop
    per_round = d * cfg.records_per_shard
    rows = payloads[:n_rounds].reshape(-1, payloads.shape[-1])
    ids = np.repeat(metas.sid_hi[:n_rounds].reshape(-1), cfg.records_per_shard)
    drones_exact = check(rows, ids, per_round, "day")

    host = {}
    for name, fn in (("latest", ldb.latest),
                     ("query_latest", lambda: ldb.query(Query().latest()))):
        times = []
        for _ in range(100):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        host[f"{name}_host_us"] = float(np.median(times))

    # one crafted round after the day, on the card and on the CPU
    before = ldb.latest()
    cpu_f, cpu_seen = before.record.cpu().clone(), before.last_seen.cpu().clone()
    cached_t = np.where(before.valid.cpu().numpy(), cpu_f[:, 0].numpy(), np.nan)
    payload, meta = fleet.next_shards()
    cp, cids = latest_edge_round(payload, meta.sid_hi, cached_t, d, seed=seed)
    ldb.insert(cp, meta._replace(sid_hi=cids))
    _update_latest(cpu_f, cpu_seen, torch.from_numpy(cp), torch.from_numpy(cids),
                   n_rounds + 1)
    after = ldb.latest()
    cpu_bad = int((after.record.cpu().view(torch.int32) != cpu_f.view(torch.int32))
                  .any(1).sum() + (after.last_seen.cpu() != cpu_seen).sum())
    if cpu_bad:
        raise SystemExit(f"latest (crafted round): {cpu_bad} rows apart from the CPU's")
    crafted_exact = check(np.concatenate([rows, cp.reshape(-1, cp.shape[-1])]),
                          np.concatenate([ids, np.repeat(cids, cfg.records_per_shard)]),
                          per_round, "crafted round")
    seen = after.last_seen.cpu().numpy()
    # one cache update at a round's shape, on copies
    uf, us = after.record.clone(), after.last_seen.clone()
    up, uids = (torch.from_numpy(x).to(dev) for x in (cp, cids))

    def update():
        return _update_latest(uf, us, up, uids, n_rounds + 2)
    update_fields = {"ms": cuda_ms(torch, update, 50),
                     "host_us": host_us(torch, {"u": update}, calls=50)["u"]}
    if do_profile:
        update_fields["profile"] = profile(torch, update, host_top=12)
    return {"max_drones": d, "timed_rounds": timed_rounds, "ingest_device_s": ingest_s,
            "shards_per_s": timed_rounds * d / ingest_s, **host,
            "drones_exact": drones_exact, "drones": d,
            "other_leaves_equal": len(ldb.state) - 1 - len(cache)
            + len(ldb.state.index),
            "batch_fields_equal": len(res_m._fields) + len(info_m._fields),
            "crafted": {"drones_exact": crafted_exact, "card_vs_cpu_rows_apart": 0,
                        "rows_written": int((seen == n_rounds + 1).sum()),
                        "rows_with_nan": int(np.isnan(after.record.cpu().numpy()).any(1).sum())},
            "launches": launches, "update_latest": update_fields,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}, ldb


def latest_cost(torch, dev, cfg, payloads, metas, chunks, d: int) -> dict:
    """The cache's cost on ingest, controlled: two fresh D400 stores, one
    with ``max_drones=d`` and one without, take the day's first chunks in
    turns (a warm-up chunk each, then alternating which goes first), each
    chunk timed alone with CUDA events after a synchronise. Returns each
    store's chunk ms, the medians, and the ratio of the cached store's
    shards/s to the uncached one's."""
    import dataclasses
    from repro_torch.api.session import AerialDB
    stores = {"cached": AerialDB.open(dataclasses.replace(cfg, max_drones=d), device=dev),
              "uncached": AerialDB.open(cfg, device=dev)}
    times = {k: [] for k in stores}
    for i, sl in enumerate(chunks[:9]):
        order = list(stores) if i % 2 == 0 else list(stores)[::-1]
        for name in order:
            torch.cuda.synchronize()
            ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            ev0.record()
            stores[name].ingest_rounds(payloads[sl], type(metas)(*(f[sl] for f in metas)))
            ev1.record()
            ev1.synchronize()
            if i > 0:                      # chunk 0 is the warm-up
                times[name].append(ev0.elapsed_time(ev1))
    med = {k: float(np.median(v)) for k, v in times.items()}
    return {"chunk_ms": times, "chunk_ms_median": med,
            "rounds_per_chunk": chunks[0].stop - chunks[0].start,
            "shards_per_s_ratio": med["uncached"] / med["cached"]}


def states_equal(torch, a, b, skip=()) -> list:
    """Names of the StoreState / IndexState leaves of ``a`` and ``b`` (but
    those in ``skip``) that differ in shape, dtype or bits (empty when every
    leaf is equal); ``b``'s leaves are compared on ``a``'s device."""
    def differ(x, y):
        return not bitwise_equal(torch, x, y.to(x.device))
    out = [f"index.{f}" for f in a.index._fields
           if differ(getattr(a.index, f), getattr(b.index, f))]
    return out + [f for f in a._fields if f not in ("index", *skip)
                  and differ(getattr(a, f), getattr(b, f))]


def batch_vs_twin(torch, got, want, what: str = "resilience") -> dict:
    """A faulted store's (QueryResult, QueryInfo) against its never-faulted
    twin's on every query neither overflows: count, vmin and vmax bitwise,
    vsum to rtol 1e-5. Returns the queries compared and overflowed and the
    largest vsum difference; exits non-zero, naming ``what``, on a
    mismatch."""
    (r, _), (w, _) = got, want
    keep = ~(r.overflow | w.overflow)
    if not torch.equal(r.count[keep], w.count[keep]) or not all(
            bitwise_equal(torch, getattr(r, f)[keep], getattr(w, f)[keep])
            for f in ("vmin", "vmax")):
        raise SystemExit(f"{what}: a query's count, min or max differs from "
                         "the store it is held to")
    torch.testing.assert_close(r.vsum[keep], w.vsum[keep], rtol=1e-5, atol=0,
                               equal_nan=True)
    d = (r.vsum[keep] - w.vsum[keep]).abs()
    d = d[~torch.isnan(d)]
    return {"compared": int(keep.sum()), "overflowed": int((~keep).sum()),
            "vsum_max_abs_diff": float(d.max()) if d.numel() else 0.0}


def small_repair_card_vs_cpu(torch, dev) -> dict:
    """The wrapping outage scenario of the CPU tests (8 edges, capacity 256,
    four failure domains: 2 rounds, domain 1 down for 8 rounds that wrap
    the rings, recovered without a repair) on the card and on the CPU, then
    the session's incremental repair and ``repair_state``'s full sweep of a
    clone of the pre-repair state on each: every leaf and both telemetry
    dicts equal. Exits non-zero otherwise."""
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import StoreConfig, clone_state
    from repro_torch.core.repair import repair_state
    from repro_torch.data.synthetic import CityConfig, DroneFleet, make_sites
    sites = tuple(map(tuple, make_sites(8, CityConfig(), seed=3).tolist()))
    cfg = StoreConfig(n_edges=8, sites=sites, tuple_capacity=256,
                      index_capacity=512, max_shards_per_query=64,
                      records_per_shard=8, retention_every=2,
                      n_failure_domains=4)
    out = {}
    for d in (dev, torch.device("cpu")):
        db = AerialDB.open(cfg, device=d)
        fleet = DroneFleet(12, records_per_shard=8, seed=7)
        for r in range(10):
            if r == 2:
                db.fail_device(1)
            db.insert(*fleet.next_shards())
        db.recover_device(1, repair=False)
        pre = clone_state(db.state)
        inc = db.repair()
        full = repair_state(cfg, pre, db.alive)
        out[d.type] = (db.state, inc, full)
    (s_card, i_card, f_card), (s_cpu, i_cpu, f_cpu) = out[dev.type], out["cpu"]
    bad = states_equal(torch, s_card, s_cpu) + states_equal(torch, f_card[0], f_cpu[0])
    if bad or i_card != i_cpu or f_card[1] != f_cpu[1]:
        raise SystemExit(f"resilience: the small repair differs on the card: "
                         f"{bad} {i_card} {i_cpu} {f_card[1]} {f_cpu[1]}")
    if int(s_cpu.tup_count.max()) <= 256 or i_cpu["shards_replaced"] == 0:
        raise SystemExit("resilience: the small scenario did not wrap and repair")
    return {"leaves_equal": len(s_cpu.index) + len(s_cpu) - 1,
            "incremental": i_cpu, "full_swept": f_cpu[1]["shards_swept"]}


def repair_batch_vs_plain(torch, dev, cfg, state) -> dict:
    """voronoi_assign and hash64 at the batch a full repair sends them: the
    16 x 16 slice-cell centres and 16 temporal buckets of every tracked
    shard of ``state``'s index, and the shard ids, each kernel once against
    its plain version on the same card tensors (bitwise). Exits non-zero on
    a mismatch."""
    from repro_torch.core import hashing, voronoi
    from repro_torch.core.repair import _shard_table
    from repro_torch.core.slicing import _cell_index
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops
    ent_i = state.index.ent_i.cpu().numpy()
    ent_f = state.index.ent_f.cpu().numpy()
    ev, ec, _, _, first = _shard_table(ent_i, ent_f, state.index.valid.cpu().numpy())
    f0 = torch.from_numpy(ent_f[ev[first], ec[first]]).to(dev)
    sid = torch.from_numpy(ent_i[ev[first], ec[first], :2].copy()).to(dev)
    sc = cfg.slice_cfg
    k = torch.arange(16, dtype=torch.int32, device=dev)
    ii = _cell_index(f0[:, 0], sc.lat0, sc.cell)[:, None] + k
    jj = _cell_index(f0[:, 2], sc.lon0, sc.cell)[:, None] + k
    glat = (sc.lat0 + (ii.float() + 0.5) * sc.cell)[:, :, None].expand(-1, 16, 16)
    glon = (sc.lon0 + (jj.float() + 0.5) * sc.cell)[:, None, :].expand(-1, 16, 16)
    sites = cfg.sites_array(dev)
    got = vor_ops.voronoi_assign_cuda(glat, glon, sites).reshape(-1)
    want = voronoi.voronoi_assign(torch.stack([glat.reshape(-1), glon.reshape(-1)], -1),
                                  sites)
    buckets = hashing.time_bucket(f0[:, 4], cfg.tau)[:, None] + k
    h_bad = sum(int((hash64_ops.xxh64_mod_cuda(h, lo, cfg.n_edges)
                     != hashing.xxh64_mod_plain(h, lo, cfg.n_edges)).sum())
                for h, lo in ((None, buckets), (sid[:, 0], sid[:, 1])))
    v_bad = int((got != want).sum())
    if v_bad or h_bad:
        raise SystemExit(f"resilience: at the repair batch voronoi_assign "
                         f"differs on {v_bad} points, hash64 on {h_bad} keys")
    return {"shards": int(first.size), "voronoi_points": int(got.numel()),
            "hash64_keys": int(buckets.numel() + sid.shape[0]), "mismatch": 0}


def resilience_phase(torch, dev, cfg, city, seed: int, card: str) -> dict:
    """The paper's edge-server loss (fig. 14's ``device_failure`` row) at
    D400 width: the main path's config with 4 failure domains, two sessions
    on the card taking the same 48 rounds of the same fleet; the faulted
    one loses domain 1 (20 edges) after round 24 and recovers it (the
    incremental repair) after round 48, the twin never fails. Checks, each
    fatal: (1) during the outage a 64-query AND batch (1 km x 1800 s, 4
    channels) over the last 30 minutes and over the 30 minutes before the
    failure equals the twin's on every query neither overflows, and the
    second loses replicas on the faulted store (the first matches only
    shards placed around the dead domain); (2) failing a
    dead edge and recovering an alive one leave ``ledger()`` unchanged (the
    latter runs no repair); (3) a full repair of a clone of the pre-repair
    state equals the incremental repair, every leaf; (4) the two stores'
    ``canonical_content`` is equal (no ring wraps: ``tup_overwritten`` 0
    before the repair, on rings of RESILIENCE_CAPACITY); (5) after the repair the batch equals the twin's
    with no replica lost and a completeness bound of 1, and the ledger is
    empty; (6) the small wrapping scenario equals the CPU's. Both batches'
    degraded scans (during the outage) and post-repair scans are also held
    against st_scan's plain version at this capacity (``scan_vs_plain``,
    launches not counted). Counts are set to 0 before the ingest and read
    after check 5. Then the partition leg (``partition_leg``) on a third
    store, held to the same twin; its results under ``partition``."""
    import dataclasses
    from repro_torch.api.session import AerialDB
    from repro_torch.chaos.audit import assert_content_equal, canonical_content
    from repro_torch.core.datastore import (AggSpec, clone_state, make_pred,
                                            plan_subqueries)
    from repro_torch.data.synthetic import DroneFleet, make_query_workload
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops
    mods = {"hash64": hash64_ops, "voronoi_assign": vor_ops, "st_scan": st_ops}
    t_phase = time.perf_counter()
    rcfg = dataclasses.replace(cfg, n_failure_domains=4,
                               tuple_capacity=RESILIENCE_CAPACITY)
    fleet = DroneFleet(400, city, records_per_shard=60, n_values=4, seed=seed)
    payloads, metas = fleet.next_rounds(48)

    def part(sl):
        return payloads[sl], type(metas)(*(f[sl] for f in metas))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    faulted, twin = (AerialDB.open(rcfg, device=dev) for _ in range(2))
    for db in (faulted, twin):
        db.ingest_rounds(*part(slice(0, 24)))
    faulted.fail_device(1)
    ingest_s = {}
    for name, db in (("faulted", faulted), ("twin", twin)):
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        db.ingest_rounds(*part(slice(24, 48)))
        ev1.record()
        ev1.synchronize()
        ingest_s[name] = ev0.elapsed_time(ev1) / 1e3

    # The batch's boxes over two 30-minute windows: the last (shards placed
    # around the dead domain, so none of theirs is lost) and the last before
    # the failure (shards with replicas on it).
    t_ends = {"recent": float(payloads[..., 0].max()),
              "before_failure": float(payloads[:24, ..., 0].max())}
    w = make_query_workload(np.random.default_rng(seed + 2), 64, city,
                            t_ends["recent"], 1.0, 1800.0)
    preds = {}
    for name, t_end in t_ends.items():
        t0_ = np.full(64, t_end - RECENT_S, np.float32)
        preds[name] = make_pred(q=64, **{**w, "t0": t0_, "t1": t0_ + np.float32(1800.0)},
                                has_spatial=True, has_temporal=True,
                                is_and=True, device=dev)
    spec = AggSpec(channels=(0, 1, 2, 3))

    def scan_check(db, name, when):
        """st_scan against its plain version on ``db``'s log at RESILIENCE_
        CAPACITY, at batch ``name``'s sublists planned under the session's
        mask (around the dead domain during the outage); these launches are
        not counted. Returns the largest vsum difference."""
        counts = {k: m.launches for k, m in mods.items()}
        st_, p = db.state, preds[name]
        subl, slen, _ = plan_subqueries(rcfg, st_, p, db.effective_alive)
        err = scan_vs_plain(torch, (st_.tup_f, st_.tup_sid, st_.tup_count, p,
                                    subl, slen), spec.channels,
                            rcfg.tuple_capacity, f"resilience {when}, {name}")
        for k, m in mods.items():
            m.launches = counts[k]
        return err
    during = {n: faulted.query(p, agg=spec) for n, p in preds.items()}
    lost_during = {n: int(r.replicas_lost.sum()) for n, (r, _) in during.items()}
    if lost_during["before_failure"] <= 0:
        raise SystemExit("resilience: no replica was lost during the outage")
    check1 = {n: batch_vs_twin(torch, during[n], twin.query(p, agg=spec))
              for n, p in preds.items()}
    scan_err = {"during": max(scan_check(faulted, n, "during the outage")
                              for n in preds)}

    # (2) ledger no-ops
    snap = faulted.ledger()
    faulted.fail_edges(20)                   # in domain 1: already dead
    same_after_fail = faulted.ledger() == snap
    faulted.recover_edges(0)                 # alive: no window, no repair
    if not (same_after_fail and faulted.ledger() == snap
            and faulted.last_repair is None):
        raise SystemExit(f"resilience: a no-op flip changed the ledger {snap}")

    pair = (("faulted", faulted), ("twin", twin))
    over = {n: int(db.state.tup_overwritten.sum()) for n, db in pair}
    count_max = {n: int(db.state.tup_count.max()) for n, db in pair}
    if any(over.values()):
        raise SystemExit(f"resilience: a ring wrapped {over} {count_max}")
    pre = clone_state(faulted.state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    faulted.recover_device(1)
    inc_wall = time.perf_counter() - t0
    inc, inc_s = faulted.last_repair, faulted.last_repair_seconds

    # (3) incremental == full, from a clone of the pre-repair state
    full_db = AerialDB(rcfg, pre, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = full_db.repair(full=True)
    full_wall = time.perf_counter() - t0
    full_s = full_db.last_repair_seconds
    bad = states_equal(torch, faulted.state, full_db.state)
    if bad:
        raise SystemExit(f"resilience: incremental repair != full sweep at {bad}")

    # (4) content equal to the never-faulted twin's
    t0 = time.perf_counter()
    got, want = canonical_content(faulted), canonical_content(twin)
    assert_content_equal(got, want, "resilience: ")
    content_s = time.perf_counter() - t0

    # (5) after the repair
    check5 = {}
    for name, p in preds.items():
        after = faulted.query(p, agg=spec)
        check5[name] = batch_vs_twin(torch, after, twin.query(p, agg=spec))
        res = after[0]
        if int(res.replicas_lost.max()) != 0 or not bool(
                (res.completeness_bound[~res.overflow] == 1).all()):
            raise SystemExit(f"resilience: after the repair, batch {name} "
                             f"lost {int(res.replicas_lost.max())} replicas")
    scan_err["after"] = max(scan_check(faulted, n, "after the repair")
                            for n in preds)
    ledger = faulted.ledger()
    if ledger["open_outages"] or ledger["closed_windows"] \
            or ledger["pending_sids"] or ledger["dropped_sids"]:
        raise SystemExit(f"resilience: the ledger after the repair: {ledger}")
    launches = {k: m.launches for k, m in mods.items()}
    if min(launches.values()) <= 0:
        raise SystemExit(f"resilience: a kernel never launched: {launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    batch = repair_batch_vs_plain(torch, dev, rcfg, faulted.state)
    del full_db, pre
    small = small_repair_card_vs_cpu(torch, dev)
    shards = 24 * fleet.n_drones
    faulted_s = time.perf_counter() - t_phase
    split = partition_leg(torch, dev, rcfg, part, twin, want, preds, spec,
                          scan_check, mods, fleet.n_drones, card)
    return {
        "config": {"n_failure_domains": 4, "failed_domain": 1, "failed_edges": 20,
                   "rounds": [24, 24], "tuple_capacity": rcfg.tuple_capacity},
        "tup_count_max": count_max,
        "checks": {"1_during_outage_vs_twin": True, "2_ledger_noops": True,
                   "3_incremental_equals_full": True, "4_content_equals_twin": True,
                   "5_after_repair": True, "6_small_card_vs_cpu": True},
        "during": {n: {**c, "replicas_lost_sum": lost_during[n],
                       "replicas_lost_max": int(during[n][0].replicas_lost.max()),
                       "matched_queries": int((during[n][0].count > 0).sum())}
                   for n, c in check1.items()},
        "after": check5,
        "repair_incremental": inc, "repair_incremental_seconds": inc_s,
        "repair_incremental_wall_s": inc_wall,
        "repair_full": full, "repair_full_seconds": full_s,
        "repair_full_wall_s": full_wall,
        "swept_n": {"incremental": inc["shards_swept"], "full": full["shards_swept"]},
        "content": {"edges": len(got["edges"]), "shards": len(got["index"]),
                    "tuples": int(sum(r.shape[0] for r in got["edges"])),
                    "seconds": content_s},
        "launches": launches, "st_scan_vs_plain_vsum_max_abs_diff": scan_err,
        "ingest_shards_per_s": {k: shards / v for k, v in ingest_s.items()},
        "ingest_device_s": ingest_s,
        "repair_batch_vs_plain": batch, "small_card_vs_cpu": small,
        "peak_mem_gb": peak, "faulted_s": faulted_s, "partition": split,
        "phase_s": time.perf_counter() - t_phase}


def edge_rows(state, edges: slice) -> dict:
    """Copies of every per-edge leaf's rows for ``edges``."""
    out = {f"index.{f}": getattr(state.index, f)[edges].clone()
           for f in state.index._fields}
    out.update({f: getattr(state, f)[edges].clone() for f in PER_EDGE_LEAVES})
    return out


def partition_leg(torch, dev, rcfg, part, twin, twin_content, preds, spec,
                  scan_check, mods, n_drones: int, card: str) -> dict:
    """The resilience phase's partition leg: a third store on ``rcfg`` takes
    the phase's 48 rounds, split after round 24 (``SPLIT_GROUPS``: edges
    60-79 unreachable) and healed with the incremental repair after round
    48, held to the phase's never-faulted ``twin``. Checks, each fatal:
    (P1) every per-edge leaf's rows for the far side are bitwise the same
    at the heal as at the split; (P2) during the split both batches equal
    the twin's on every query neither overflows, and the pre-split batch
    loses replicas; (P3) a full repair of a clone of the pre-heal state
    equals the heal's incremental repair, every leaf; (P4) the heal sweeps
    exactly the shards ingested during the split; (P5) the canonical
    content equals the twin's; (P6) after the heal both batches equal the
    twin's with no replica lost and a completeness bound of 1, and the
    ledger is empty. The degraded and post-heal scans are held to
    st_scan's plain version (launches not counted). Counts are set to 0
    just before the leg's ingest and read after P6."""
    from repro_torch.api.session import AerialDB
    from repro_torch.chaos.audit import assert_content_equal, canonical_content
    from repro_torch.core.datastore import clone_state
    t_leg = time.perf_counter()
    want = {n: twin.query(p, agg=spec) for n, p in preds.items()}
    near, far = SPLIT_GROUPS
    far_rows = slice(far[0], far[-1] + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    split = AerialDB.open(rcfg, device=dev)
    split.ingest_rounds(*part(slice(0, 24)))
    split.partition([near, far])
    frozen = edge_rows(split.state, far_rows)
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    split.ingest_rounds(*part(slice(24, 48)))
    ev1.record()
    ev1.synchronize()
    split_ingest_s = ev0.elapsed_time(ev1) / 1e3
    opened = split.ledger()["partition"]
    if opened != {"unreachable": far, "step": 24}:
        raise SystemExit(f"partition: the ledger holds {opened}")

    # (P2) during the split
    during = {n: split.query(p, agg=spec) for n, p in preds.items()}
    p2 = {n: batch_vs_twin(torch, during[n], want[n], "partition") for n in preds}
    lost = {n: int(r.replicas_lost.sum()) for n, (r, _) in during.items()}
    if lost["before_failure"] <= 0:
        raise SystemExit("partition: no replica was cut off during the split")
    scan_err = {"during": max(scan_check(split, n, "during the split")
                              for n in preds)}

    # (P1) the far side frozen
    now = edge_rows(split.state, far_rows)
    moved = [k for k in frozen if not bitwise_equal(torch, frozen[k], now[k])]
    if moved:
        raise SystemExit(f"partition: the unreachable edges' {moved} changed")
    del now
    over = int(split.state.tup_overwritten.sum())
    if over:
        raise SystemExit(f"partition: a ring wrapped ({over} tuples)")

    pre = clone_state(split.state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    split.heal()
    heal_wall = time.perf_counter() - t0
    inc, inc_s = split.last_repair, split.last_repair_seconds

    # (P4) the heal sweeps the split's shards
    if inc["shards_swept"] != 24 * n_drones or inc["shards_unrepairable"]:
        raise SystemExit(f"partition: the heal swept {inc['shards_swept']} "
                         f"shards, not the {24 * n_drones} of the split: {inc}")
    # (P3) incremental == full, from a clone of the pre-heal state
    full_db = AerialDB(rcfg, pre, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = full_db.repair(full=True)
    full_wall = time.perf_counter() - t0
    full_s = full_db.last_repair_seconds
    bad = states_equal(torch, split.state, full_db.state)
    if bad:
        raise SystemExit(f"partition: incremental repair != full sweep at {bad}")
    del full_db, pre

    # (P5) content equal to the never-faulted twin's
    t0 = time.perf_counter()
    got = canonical_content(split)
    assert_content_equal(got, twin_content, "partition: ")
    content_s = time.perf_counter() - t0

    # (P6) after the heal
    after = {}
    for name, p in preds.items():
        res = split.query(p, agg=spec)
        after[name] = batch_vs_twin(torch, res, want[name], "partition")
        r = res[0]
        if int(r.replicas_lost.max()) != 0 or not bool(
                (r.completeness_bound[~r.overflow] == 1).all()):
            raise SystemExit(f"partition: after the heal, batch {name} lost "
                             f"{int(r.replicas_lost.max())} replicas")
    scan_err["after"] = max(scan_check(split, n, "after the heal") for n in preds)
    ledger = split.ledger()
    empty = {"open_outages": [], "closed_windows": [], "partition": None,
             "pending_sids": 0, "dropped_sids": 0}
    if ledger != empty:
        raise SystemExit(f"partition: the ledger after the heal: {ledger}")
    launches = {k: m.launches for k, m in mods.items()}
    if min(launches.values()) <= 0:
        raise SystemExit(f"partition: a kernel never launched: {launches}")
    return {
        "card": card, "groups": [[near[0], near[-1]], [far[0], far[-1]]],
        "rounds": [24, 24],
        "checks": {"P1_far_side_frozen": True, "P2_during_split_vs_twin": True,
                   "P3_incremental_equals_full": True,
                   "P4_heal_sweeps_the_split": True,
                   "P5_content_equals_twin": True, "P6_after_heal": True},
        "frozen_leaves": len(frozen),
        "during": {n: {**c, "replicas_lost_sum": lost[n],
                       "replicas_lost_max": int(during[n][0].replicas_lost.max()),
                       "matched_queries": int((during[n][0].count > 0).sum())}
                   for n, c in p2.items()},
        "after": after, "swept_n": {"heal": inc["shards_swept"],
                                    "full": full["shards_swept"]},
        "repair_heal": inc, "repair_heal_seconds": inc_s,
        "repair_heal_wall_s": heal_wall, "repair_full": full,
        "repair_full_seconds": full_s, "repair_full_wall_s": full_wall,
        "content": {"shards": len(got["index"]), "seconds": content_s},
        "split_ingest_shards_per_s": 24 * n_drones / split_ingest_s,
        "tup_count_max": int(split.state.tup_count.max()),
        "launches": launches, "st_scan_vs_plain_vsum_max_abs_diff": scan_err,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "leg_s": time.perf_counter() - t_leg}


def adversarial_round(rng, payload: np.ndarray, rnd: int) -> tuple:
    """Round ``rnd`` of a fleet (``payload`` (D, R, 3+V)) as the drones send
    it: each record with its drone's record counter as seq; DROP_FRAC of
    the seqs never sent, PARTIAL_FRAC of the records NaN from a random value
    channel on, DUP_FRAC of the sent records sent twice, all shuffled.
    Returns (drone, seq, rows) as sent and the accepted (drone, rows), in
    the order sent, and the number of re-sends."""
    d, r, w = payload.shape
    n = d * r
    drone = np.repeat(np.arange(d, dtype=np.int64), r)
    seq = np.tile(np.arange(rnd * r, (rnd + 1) * r, dtype=np.int64), d)
    rows = payload.reshape(n, w).copy()
    start = rng.integers(0, w - 3, n)
    nan = (rng.random(n) < PARTIAL_FRAC)[:, None] \
        & (np.arange(w - 3)[None, :] >= start[:, None])
    rows[:, 3:][nan] = np.nan
    sent = np.nonzero(rng.random(n) >= DROP_FRAC)[0]
    dup = sent[rng.random(sent.size) < DUP_FRAC]
    order = np.concatenate([sent, dup])
    rng.shuffle(order)
    return (drone[order], seq[order], rows[order]), (drone[sent], rows[sent]), dup.size


def stream_checks(results, batches, specs, recs) -> tuple:
    """Every non-overflowed answer of ``results`` ((batch, spec) ->
    (QueryResult, QueryInfo)) against a numpy oracle over the accepted
    records ``recs`` (N, 3+V) float32: the count equal, min and max equal
    (NaN, where a matched record's channel is NaN, counts as a value), the
    sum to rtol 1e-5 (NaN equal). Exits non-zero otherwise; returns
    (queries checked, queries skipped for overflow)."""
    recs = recs[np.argsort(recs[:, 0], kind="stable")]
    checked = overflowed = 0
    for (bi, si), (res, _) in results.items():
        ch = [3 + c for c in specs[si].channels]
        w = batches[bi][3]
        cnt, ovf = res.count.cpu().numpy(), res.overflow.cpu().numpy()
        got = {f: getattr(res, f).cpu().numpy().reshape(64, -1)
               for f in ("vsum", "vmin", "vmax")}
        for qi in range(64):
            if ovf[qi]:
                overflowed += 1
                continue
            sub = recs[np.searchsorted(recs[:, 0], w["t0"][qi], "left"):
                       np.searchsorted(recs[:, 0], w["t1"][qi], "right")]
            m = ((w["lat0"][qi] <= sub[:, 1]) & (sub[:, 1] <= w["lat1"][qi])
                 & (w["lon0"][qi] <= sub[:, 2]) & (sub[:, 2] <= w["lon1"][qi]))
            if int(m.sum()) != int(cnt[qi]):
                raise SystemExit(f"streaming: batch {bi} query {qi}: count "
                                 f"{cnt[qi]} != oracle {int(m.sum())}")
            checked += 1
            if not m.any():
                continue
            vals = sub[m][:, ch]
            np.testing.assert_array_equal(got["vmin"][qi], vals.min(0))
            np.testing.assert_array_equal(got["vmax"][qi], vals.max(0))
            np.testing.assert_allclose(got["vsum"][qi],
                                       vals.astype(np.float64).sum(0),
                                       rtol=1e-5, equal_nan=True)
    return checked, overflowed


def streaming_phase(torch, dev, cfg, city, seed: int, card: str,
                    n_drones: int = 400, rounds: int = STREAM_ROUNDS) -> dict:
    """The paper's ingest front door (§4.4) at D400 width: the main path's
    config with the latest cache (``max_drones``), fed through
    ``IngestPipeline`` by ``rounds`` rounds of a fresh fleet made
    adversarial (``adversarial_round``), submitted in STREAM_BURSTS bursts a
    round, ``flush()`` after each round and ``flush(drain=True)`` at the
    end, with the write-ahead journal on and a seeded fault hook raising a
    transient error on FAULT_FRAC of the dispatch attempts. Checks, each
    fatal: (S1) the counters reconcile, ``accepted`` is the stream's
    distinct (drone, seq) count and ``duplicate`` its re-sends; (S2) the
    main path's three batch sizes, each window inside the last
    max(30 minutes, window), at 1 and 4 channels, against a numpy oracle
    over the accepted records (``stream_checks``); (S3) ``latest()``
    before the drain (pending records overlaid) bitwise equal to the
    oracle over every accepted record; (S4) a fresh pipeline over a fresh
    store replays the journal and drains: the same accepted count, its
    counters reconcile, and its S2 batches equal the first store's. Counts
    are set to 0 just before the first submit and read after S2."""
    import dataclasses
    import tempfile
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import AggSpec, make_pred
    from repro_torch.data.synthetic import DroneFleet, make_query_workload
    from repro_torch.ingest import (IngestPipeline, TransientDispatchError,
                                    latest_oracle_sorted)
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops
    mods = {"hash64": hash64_ops, "voronoi_assign": vor_ops, "st_scan": st_ops}
    t_phase = time.perf_counter()
    scfg = dataclasses.replace(cfg, max_drones=n_drones)
    payloads, _ = DroneFleet(n_drones, city, records_per_shard=60, n_values=4,
                             seed=seed + 3).next_rounds(rounds)
    rng = np.random.default_rng(seed + 3)
    stream = [adversarial_round(rng, payloads[r], r) for r in range(rounds)]
    acc_drone = np.concatenate([a[0] for _, a, _ in stream])
    acc_rows = np.concatenate([a[1] for _, a, _ in stream])
    resent = sum(n for _, _, n in stream)
    fault_rng = np.random.default_rng(seed + 4)

    def fault_hook(pipe, attempt):
        if fault_rng.random() < FAULT_FRAC:
            raise TransientDispatchError("injected: a dispatch lost on the link")

    t_end = float(acc_rows[:, 0].max())
    qrng = np.random.default_rng(seed + 5)
    batches = []
    for km, win in QUERY_SIZES:
        w = make_query_workload(qrng, 64, city, t_end, km, win)
        w["t0"] = qrng.uniform(t_end - max(win, RECENT_S), t_end - win,
                               64).astype(np.float32)
        w["t1"] = (w["t0"] + np.float32(win)).astype(np.float32)
        batches.append((km, win, True, w))
    specs = (AggSpec(channel=0), AggSpec(channels=(0, 1, 2, 3)))

    def run_batches(db):
        out = {}
        for bi, (_, _, _, w) in enumerate(batches):
            pred = make_pred(q=64, **w, has_spatial=True, has_temporal=True,
                             is_and=True, device=dev)
            for si, spec in enumerate(specs):
                out[(bi, si)] = db.query(pred, agg=spec)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        journal = Path(tmp) / "ingest.wal"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in mods.values():
            mod.launches = 0
        pipe = IngestPipeline(AerialDB.open(scfg, device=dev), journal=journal,
                              sleep=lambda s: None)
        pipe.fault_hook = fault_hook
        submit_s, sent, flushes, latency = 0.0, 0, [], []

        def timed_flush(**kw):
            tf = time.perf_counter()
            out = pipe.flush(**kw)
            latency.append(out["latency_s"])
            return {"wall_ms": (time.perf_counter() - tf) * 1e3,
                    **{k: out[k] for k in ("dispatches", "flushed_shards",
                                           "retries", "gave_up")}}
        t0 = time.perf_counter()
        for (d, s, rows), _, _ in stream:
            for part in np.array_split(np.arange(d.size), STREAM_BURSTS):
                ts = time.perf_counter()
                pipe.submit_arrays(d[part], s[part], rows[part, 0], rows[part, 1],
                                   rows[part, 2], rows[part, 3:])
                submit_s += time.perf_counter() - ts
            sent += d.size
            flushes.append(timed_flush())
        # (S3) latest before the drain, pending records overlaid
        t_latest = time.perf_counter()
        rec, valid = pipe.latest()
        latest_s = time.perf_counter() - t_latest
        o_rec, o_valid, _ = latest_oracle_sorted(acc_drone, acc_rows[:, 0],
                                                 acc_rows, n_drones)
        pending_at_latest = pipe.pending
        if not (np.array_equal(valid, o_valid)
                and np.array_equal(rec.view(np.int32), o_rec.view(np.int32))):
            raise SystemExit("streaming: latest() before the drain differs "
                             "from the oracle")
        drain = timed_flush(drain=True)
        end_to_end_s = time.perf_counter() - t0
        # (S1)
        rec1 = pipe.reconcile()
        if not rec1["ok"] or rec1["accepted"] != acc_drone.size \
                or rec1["duplicate"] != resent or rec1["pending"]:
            raise SystemExit(f"streaming: the counters do not reconcile: {rec1} "
                             f"(distinct {acc_drone.size}, re-sent {resent})")
        # (S2)
        results = run_batches(pipe.db)
        checked, overflowed = stream_checks(results, batches, specs, acc_rows)
        launches = {k: m.launches for k, m in mods.items()}
        if min(launches.values()) <= 0:
            raise SystemExit(f"streaming: a kernel never launched: {launches}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        journal_bytes = journal.stat().st_size
        pipe.close()
        # (S4) a fresh pipeline over a fresh store replays the journal
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay = IngestPipeline(AerialDB.open(scfg, device=dev), journal=journal)
        rep = replay.replay_journal()
        replay.flush(drain=True)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        rec2 = replay.reconcile()
        replay.close()
    if rec2["accepted"] != rec1["accepted"] or not rec2["ok"]:
        raise SystemExit(f"streaming: the replay reconciles to {rec2}, the "
                         f"stream to {rec1}")
    again = run_batches(replay.db)
    s4 = {f"{bi},{si}": batch_vs_twin(torch, again[(bi, si)], results[(bi, si)],
                                      "streaming replay")
          for bi, si in results}
    lat = np.concatenate(latency)
    return {
        "card": card, "drones": n_drones, "rounds": rounds,
        "records_sent": sent, "records_accepted": rec1["accepted"],
        "checks": {"S1_counters": True, "S2_batches_vs_oracle": True,
                   "S3_latest_vs_oracle": True, "S4_replay": True},
        "reconcile": rec1, "queries_checked": checked,
        "queries_overflowed": overflowed,
        "matched_queries": int(sum(int((r.count > 0).sum())
                                   for r, _ in results.values())),
        "nan_matched_queries": int(sum(int(torch.isnan(r.vsum).reshape(64, -1)
                                           .any(1).sum())
                                       for r, _ in results.values())),
        "submit_host_us_per_record": submit_s / sent * 1e6,
        "flush": flushes, "drain": drain,
        "flush_wall_ms_median": float(np.median([f["wall_ms"] for f in flushes])),
        "dispatches": sum(f["dispatches"] for f in flushes),
        "latency_s": {"p50": float(np.percentile(lat, 50)),
                      "p99": float(np.percentile(lat, 99)), "records": int(lat.size)},
        "records_per_s": rec1["accepted"] / end_to_end_s,
        "end_to_end_s": end_to_end_s,
        "retries": rec1["retries"], "gave_up": rec1["gave_up"],
        "latest_s": latest_s, "pending_at_latest": pending_at_latest,
        "journal_bytes": journal_bytes, "replay": rep, "replay_s": replay_s,
        "replay_vs_stream": s4, "launches": launches,
        "tup_count_max": int(pipe.db.state.tup_count.max()),
        "peak_mem_gb": peak, "phase_s": time.perf_counter() - t_phase}


def chaos_round(payload: np.ndarray, step: int) -> tuple:
    """Round ``step`` of a fleet (``payload`` (D, R, 3+V)) as the drones send
    it, in order: drone d's R records with seqs ``step * R`` on, one full
    shard a drone (fig. 19's ``_step_records``), as ``submit_arrays``
    columns."""
    d, r, w = payload.shape
    rows = payload.reshape(d * r, w)
    return (np.repeat(np.arange(d, dtype=np.int64), r),
            np.tile(np.arange(step * r, (step + 1) * r, dtype=np.int64), d),
            rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3:])


def chaos_feed(pipe, payloads: np.ndarray, step: int) -> dict:
    pipe.submit_arrays(*chaos_round(payloads[step], step))
    return pipe.flush()


def chaos_probe(torch, db, twin, pred, spec, what: str) -> dict:
    """The probe batch on the faulted store ``db``. With every edge alive
    and reachable, every query that does not overflow must have a
    completeness bound of exactly 1 and no replica lost, and equal the
    twin's (``batch_vs_twin``); degraded, only its bounds are read. Exits
    non-zero when every query overflowed."""
    res, info = db.query(pred, agg=spec)
    keep = ~res.overflow
    if not bool(keep.any()):
        raise SystemExit(f"chaos {what}: every probe query overflowed")
    bound = res.completeness_bound[keep]
    out = {"full": bool(db.effective_alive.all()),
           "min_bound": float(bound.min()),
           "replicas_lost_max": int(res.replicas_lost[keep].max()),
           "overflowed": int((~keep).sum())}
    if out["full"]:
        if not bool((bound == 1).all()) or out["replicas_lost_max"]:
            raise SystemExit(f"chaos {what}: at full health a probe query "
                             f"has bound {out['min_bound']} and lost "
                             f"{out['replicas_lost_max']} replicas")
        out.update(batch_vs_twin(torch, (res, info),
                                 twin.query(pred, agg=spec), f"chaos {what}"))
    return out


def chaos_soak(torch, dev, rcfg, payloads, soak_seed: int, pred, spec,
               n_steps: int) -> dict:
    """One seed of the soak: ``FaultPlan.random(soak_seed, ...)`` through
    ``ChaosRunner`` against a session + pipeline on ``rcfg``, a
    never-faulted twin (its own session + pipeline) fed the same rounds.
    Checks, each fatal: (C1) the plan rebuilt from its seed equals the
    first; (C2) ``counters_ok`` after every step, and at the end no give-up
    and a full reconcile; (C3) ``chaos_probe`` after every event that runs
    a repair; (C4) no ring wrapped, ``canonical_content`` equal to the
    twin's, one log entry a plan event, every repair incremental."""
    from repro_torch.api.session import AerialDB
    from repro_torch.chaos import (ChaosRunner, FaultPlan,
                                   assert_content_equal, canonical_content)
    from repro_torch.ingest import IngestPipeline
    kw = dict(n_edges=rcfg.n_edges, n_steps=n_steps, n_domains=4,
              min_alive=CHAOS_MIN_ALIVE, max_transient=2,
              require=("partition", "flush_fail"))
    plan = FaultPlan.random(soak_seed, **kw)
    if FaultPlan.random(soak_seed, **kw) != plan:                    # C1
        raise SystemExit(f"chaos seed {soak_seed}: the plan does not replay")
    events = []

    class TimedRunner(ChaosRunner):
        """The runner, with each applied event's host wall (to the end of
        its device work) and, for a repair, ``last_repair_seconds``."""

        def _apply(self, ev):
            t0 = time.perf_counter()
            entry = super()._apply(ev)
            torch.cuda.synchronize()
            row = {"step": entry["step"], "kind": entry["kind"],
                   "wall_s": time.perf_counter() - t0}
            if "repair" in entry:
                row["repair_seconds"] = self.db.last_repair_seconds
                row["shards_swept"] = entry["repair"]["shards_swept"]
            events.append(row)
            return entry

    noop = lambda s: None     # noqa: E731 — instant backoff
    db, twin = (AerialDB.open(rcfg, device=dev) for _ in range(2))
    pipe = IngestPipeline(db, max_retries=4, sleep=noop)
    twin_pipe = IngestPipeline(twin, max_retries=4, sleep=noop)
    runner = TimedRunner(plan, db, pipe)
    probes, step_s = [], []

    def probe(applied, step):
        for entry in applied:
            if entry["kind"] in CHAOS_REPAIRS:                        # C3
                probes.append({"step": step, "kind": entry["kind"],
                               **chaos_probe(torch, db, twin, pred, spec,
                                             f"seed {soak_seed} step {step}")})
    t_soak = time.perf_counter()
    for step in range(n_steps):
        t0 = time.perf_counter()
        applied = runner.advance(step)
        ev_s = time.perf_counter() - t0
        probe(applied, step)
        t0 = time.perf_counter()
        chaos_feed(pipe, payloads, step)
        rec = pipe.reconcile()                                        # C2
        step_s.append(ev_s + time.perf_counter() - t0)
        if not rec["counters_ok"]:
            raise SystemExit(f"chaos seed {soak_seed} step {step}: {rec}")
        chaos_feed(twin_pipe, payloads, step)
    probe(runner.advance(n_steps), n_steps)             # the closing events
    soak_s = time.perf_counter() - t_soak
    rec = pipe.reconcile()
    if not rec["ok"] or pipe.counters["gave_up"]:                     # C2
        raise SystemExit(f"chaos seed {soak_seed}: reconcile {rec}, "
                         f"{pipe.counters['gave_up']} give-ups")
    # C4: no ring wrapped. A repair's reclaim adds the slots it frees to
    # tup_overwritten (the retention watermark reads it), so every
    # overwritten slot must be one of the repairs' reclaimed slots.
    count_max = int(db.state.tup_count.max())
    over = int(db.state.tup_overwritten.sum())
    reclaimed = sum(e["repair"]["slots_reclaimed"] for e in runner.log
                    if "repair" in e)
    if count_max > rcfg.tuple_capacity or over != reclaimed:
        raise SystemExit(f"chaos seed {soak_seed}: a ring wrapped "
                         f"({count_max} tuples on the fullest; {over} slots "
                         f"overwritten, {reclaimed} reclaimed by repairs)")
    t0 = time.perf_counter()
    got = canonical_content(db)
    assert_content_equal(got, canonical_content(twin),
                         f"chaos seed {soak_seed}: ")
    content_s = time.perf_counter() - t0
    log = runner.log
    modes = {e["repair"]["mode"] for e in log if e["kind"] in CHAOS_REPAIRS}
    if [(e["step"], e["kind"]) for e in log] != \
            [(e.step, e.kind) for e in plan.events] or modes != {"incremental"}:
        raise SystemExit(f"chaos seed {soak_seed}: the log {runner.to_json()}")
    runner.to_json()      # raises unless every logged value is plain JSON
    degraded = [p["min_bound"] for p in probes if not p["full"]]
    return {
        "seed": soak_seed, "events": len(plan.events),
        "kinds": dict(Counter(plan.kinds())),
        "plan": plan.to_rows(),
        "checks": {"C1_plan_replays": True, "C2_counters": True,
                   "C3_probes": True, "C4_converged": True},
        "step_wall_s": {"p50": float(np.median(step_s)),
                        "max": float(np.max(step_s))},
        "event_walls": events,
        "repair_wall_s": float(sum(e["wall_s"] for e in events
                                   if "repair_seconds" in e)),
        "shards_swept": int(sum(e.get("shards_swept", 0) for e in events)),
        "probes": len(probes), "full_health_probes": len(probes) - len(degraded),
        "degraded_min_bound": min(degraded) if degraded else None,
        "probe_queries_overflowed_max": max(p["overflowed"] for p in probes),
        "probe_vsum_max_abs_diff": max((p.get("vsum_max_abs_diff", 0.0)
                                        for p in probes), default=0.0),
        "reconcile": {k: rec[k] for k in ("accepted", "flushed_records",
                                          "pending", "stored_tuples",
                                          "retries", "gave_up")},
        "tup_count_max": count_max, "slots_reclaimed": reclaimed,
        "content_shards": len(got["index"]),
        "content_s": content_s, "soak_s": soak_s}


def chaos_crash_leg(torch, dev, rcfg, payloads) -> dict:
    """(C5) A ``pipeline_crash`` armed by the runner at step 1 of a 2-step
    plan on a journaled pipeline fires in step 1's flush; a fresh session
    and pipeline replay the journal and drain. Fatal unless the replay
    loses no acknowledged record, reconciles, and holds the content of a
    never-crashed store fed the same two rounds."""
    import tempfile
    from repro_torch.api.session import AerialDB
    from repro_torch.chaos import (ChaosRunner, FaultPlan,
                                   assert_content_equal, canonical_content)
    from repro_torch.ingest import IngestPipeline, PipelineCrash
    noop = lambda s: None     # noqa: E731 — instant backoff
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "ingest.wal"
        pipe = IngestPipeline(AerialDB.open(rcfg, device=dev), journal=path,
                              sleep=noop)
        chaos_feed(pipe, payloads, 0)
        runner = ChaosRunner(FaultPlan(events=((1, "pipeline_crash", ()),),
                                       n_steps=2), pipe.db, pipe)
        runner.advance(1)
        try:
            chaos_feed(pipe, payloads, 1)
            raise SystemExit("chaos crash leg: the injected crash did not fire")
        except PipelineCrash:
            pass
        acked = pipe.counters["accepted"]
        pipe.close()
        del pipe
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay = IngestPipeline(AerialDB.open(rcfg, device=dev), journal=path,
                                sleep=noop)
        rep = replay.replay_journal()
        replay.flush(drain=True)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        rec = replay.reconcile()
        replay.close()
    lost = acked - rec["flushed_records"]
    ref = IngestPipeline(AerialDB.open(rcfg, device=dev), sleep=noop)
    for step in range(2):
        chaos_feed(ref, payloads, step)
    assert_content_equal(canonical_content(replay.db), canonical_content(ref.db),
                         "chaos crash leg: ")
    if not rec["ok"] or lost:
        raise SystemExit(f"chaos crash leg: lost {lost}, reconcile {rec}")
    return {"acked": acked, "journal_records": rep["journal_records"],
            "replayed": rep["accepted"], "already_seen": rep["already_seen"],
            "lost": lost, "replay_s": replay_s}


def chaos_small_card_vs_cpu(torch, dev) -> dict:
    """(C6) The reference chaos tests' smoke plan (``CHAOS_SMOKE``: 8 edges,
    4 failure domains, 2048-slot rings, 8-record shards, 12 drones a tick)
    through the runner on the card and on the CPU: every state leaf
    bitwise, the logs byte-identical, the counters equal. Exits non-zero
    otherwise."""
    from repro_torch.api.session import AerialDB
    from repro_torch.chaos import ChaosRunner, FaultPlan
    from repro_torch.core.datastore import StoreConfig
    from repro_torch.data.synthetic import CityConfig, make_sites
    from repro_torch.ingest import IngestPipeline
    sites = tuple(map(tuple, make_sites(8, CityConfig(), seed=3).tolist()))
    cfg = StoreConfig(n_edges=8, sites=sites, tuple_capacity=2048,
                      index_capacity=512, max_shards_per_query=64,
                      records_per_shard=8, retention_every=2,
                      n_failure_domains=4)
    out = {}
    for d in (dev, torch.device("cpu")):
        pipe = IngestPipeline(AerialDB.open(cfg, device=d), max_retries=4,
                              sleep=lambda s: None)
        runner = ChaosRunner(FaultPlan(events=CHAOS_SMOKE, n_steps=4),
                             pipe.db, pipe)

        def tick(step, pipe=pipe):
            rng = np.random.default_rng((0, step))
            seq = np.tile(np.arange(8), 12) + step * 8
            pipe.submit_arrays(np.repeat(np.arange(12), 8), seq,
                               seq + step * 0.25, rng.uniform(12.90, 13.00, 96),
                               rng.uniform(77.50, 77.62, 96),
                               rng.normal(size=(96, 4)))
            pipe.flush()
        runner.run(tick)
        out[d.type] = (pipe, runner.to_json())
    (card, card_log), (cpu, cpu_log) = out[dev.type], out["cpu"]
    bad = states_equal(torch, card.db.state, cpu.db.state)
    if bad or card_log != cpu_log or card.counters != cpu.counters \
            or not card.reconcile()["ok"]:
        raise SystemExit(f"chaos: the smoke plan differs on the card: {bad}")
    return {"leaves_equal": len(cpu.db.state.index) + len(cpu.db.state) - 1,
            "log_bytes": len(card_log), "retries": card.counters["retries"]}


def chaos_phase(torch, dev, cfg, city, seed: int, card: str,
                seeds=CHAOS_SEEDS, n_steps: int = CHAOS_STEPS,
                n_drones: int = 400, capacity: int = RESILIENCE_CAPACITY) -> dict:
    """Fig. 19's chaos soak at D400 width: the resilience phase's config
    (4 failure domains, ``capacity``-slot rings), for each seed a random
    plan over ``n_steps`` rounds of a fresh ``n_drones`` fleet
    (``chaos_soak``: checks C1-C4), the seeds one after another with the
    stores freed between them; then the crash leg (C5) and the smoke plan
    on the card against the CPU (C6). The probe batch: 64 AND queries, 1 km
    x 1800 s, 4 channels, windows spread over the rounds. Counts are set to
    0 just before the first soak and read after the last."""
    import dataclasses
    from repro_torch.core.datastore import AggSpec, make_pred
    from repro_torch.data.synthetic import DroneFleet, make_query_workload
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops
    mods = {"hash64": hash64_ops, "voronoi_assign": vor_ops, "st_scan": st_ops}
    t_phase = time.perf_counter()
    rcfg = dataclasses.replace(cfg, n_failure_domains=4, tuple_capacity=capacity)
    spec = AggSpec(channels=(0, 1, 2, 3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    soaks, payloads = [], None
    for i, s in enumerate(seeds):
        payloads, _ = DroneFleet(n_drones, city, records_per_shard=60,
                                 n_values=4, seed=seed + 10 * (i + 1)
                                 ).next_rounds(n_steps)
        t = payloads[..., 0]
        w = make_query_workload(np.random.default_rng(seed + 7), 64, city,
                                float(t.max()), 1.0, 1800.0)
        w["t0"] = np.random.default_rng(seed + 8).uniform(
            float(t.min()), float(t.max()) - 1800.0, 64).astype(np.float32)
        w["t1"] = (w["t0"] + np.float32(1800.0)).astype(np.float32)
        pred = make_pred(q=64, **w, has_spatial=True, has_temporal=True,
                         is_and=True, device=dev)
        soaks.append(chaos_soak(torch, dev, rcfg, payloads, s, pred, spec,
                                n_steps))
        torch.cuda.empty_cache()
    launches = {k: m.launches for k, m in mods.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    soaks_s = time.perf_counter() - t_phase
    crash = chaos_crash_leg(torch, dev, rcfg, payloads)
    torch.cuda.empty_cache()
    small = chaos_small_card_vs_cpu(torch, dev)
    if min(launches.values()) <= 0:
        raise SystemExit(f"chaos: a kernel never launched: {launches}")
    return {
        "card": card, "drones": n_drones, "steps": n_steps,
        "config": {"n_failure_domains": 4, "tuple_capacity": rcfg.tuple_capacity,
                   "min_alive": CHAOS_MIN_ALIVE, "max_transient": 2,
                   "max_retries": 4},
        "checks": {f"seed_{r['seed']}": r.pop("checks") for r in soaks}
        | {"C5_crash_replay": True, "C6_smoke_card_vs_cpu": True},
        "seeds": soaks, "crash": crash, "smoke_card_vs_cpu": small,
        "launches": launches, "peak_mem_gb": peak, "soaks_s": soaks_s,
        "phase_s": time.perf_counter() - t_phase}


FED_BLOCKS = 4                 # the federation phase's edge mesh: 4 blocks on one card
# What the federation phase's path launches, per call on one store
# (core/placement.py, core/slicing.py, core/datastore.py): an insert hashes
# its shards' time midpoints and ids (place_replicas) and their time slices
# (the index mask), and locates their midpoints and slice cells; a query
# batch hashes its time slices and sid points and locates its slice cells,
# then scans once for up to 4 channels. A mesh runs every block's body, so
# each count is FED_BLOCKS times the store's.
FED_PER_INSERT = {"hash64": 3, "voronoi_assign": 2, "st_scan": 0}
FED_PER_BATCH = {"hash64": 2, "voronoi_assign": 1, "st_scan": 1}


def answers_equal(torch, got, want, what: str) -> float:
    """Two (QueryResult, QueryInfo) answers: count, vmin, vmax, overflow,
    completeness_bound, replicas_lost and every QueryInfo field bitwise,
    vsum and vmean to rtol 1e-5 with NaN equal. Returns the largest vsum
    difference; exits non-zero, naming ``what``, otherwise."""
    (r, i), (w, j) = got, want
    bad = [f for f in ("count", "vmin", "vmax", "overflow",
                       "completeness_bound", "replicas_lost")
           if not bitwise_equal(torch, getattr(r, f), getattr(w, f))]
    bad += [f"info.{f}" for f in i._fields
            if not bitwise_equal(torch, getattr(i, f), getattr(j, f))]
    if bad:
        raise SystemExit(f"federation: {what}: {bad} differ")
    for f in ("vsum", "vmean"):
        torch.testing.assert_close(getattr(r, f), getattr(w, f), rtol=1e-5,
                                   atol=0, equal_nan=True)
    d = (r.vsum - w.vsum).abs()
    d = d[~torch.isnan(d)]
    return float(d.max()) if d.numel() else 0.0


def federation_small_card_vs_cpu(torch, dev, n_fleet=None) -> dict:
    """(F4) The card tests' small federation scenario (8 edges, 256-slot
    rings that wrap, 4 failure domains, 16 cached drones) on a 4-block mesh
    on the card and on the CPU (with ``n_fleet``, a fleet mesh of
    ``n_fleet`` fleets: the fleet line's G4): 2 rounds, block 1 lost for 6
    rounds and recovered with the incremental repair, a 4-channel batch of
    three queries. Every leaf of every block, the repair telemetry and the
    ledger bitwise, the answers by ``answers_equal`` (the kernel sums vsum
    in another order than the plain version). Exits non-zero otherwise."""
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import AggSpec, StoreConfig, make_pred
    from repro_torch.data.synthetic import CityConfig, DroneFleet, make_sites
    from repro_torch.launch.mesh import make_edge_mesh, make_fleet_mesh
    sites = tuple(map(tuple, make_sites(8, CityConfig(), seed=3).tolist()))
    cfg = StoreConfig(n_edges=8, sites=sites, tuple_capacity=256,
                      index_capacity=512, max_shards_per_query=64,
                      records_per_shard=8, retention_every=2,
                      n_failure_domains=4, max_drones=16)
    out = {}
    for d in (dev, torch.device("cpu")):
        db = AerialDB.open(cfg, make_edge_mesh(FED_BLOCKS, device=d)
                           if n_fleet is None else make_fleet_mesh(
                               n_fleet, FED_BLOCKS // n_fleet, device=d))
        fleet = DroneFleet(12, records_per_shard=8, seed=7)
        db.ingest_rounds(*fleet.next_rounds(2))
        db.fail_device(1)
        for _ in range(6):
            db.insert(*fleet.next_shards())
        db.recover_device(1)
        pred = make_pred(q=3, lat0=[12.85, 12.9, 12.95], lat1=[13.1, 13.0, 13.05],
                         lon0=[77.45, 77.5, 77.55], lon1=[77.75, 77.6, 77.65],
                         t0=[0.0, 200.0, 300.0], t1=[1e9, 400.0, 400.0],
                         has_spatial=[False, True, True], has_temporal=True,
                         is_and=True, device=d)
        ans = db.query(pred, agg=AggSpec(channels=(0, 1, 2, 3)), key=(0, 7))
        out[d.type] = (db, ans)
    (card, card_ans), (cpu, cpu_ans) = out[dev.type], out["cpu"]
    bad = [b for x, y in zip(card.blocks, cpu.blocks)
           for b in states_equal(torch, x, y)]
    if bad or card.last_repair != cpu.last_repair \
            or card.ledger() != cpu.ledger():
        raise SystemExit(f"federation: the small mesh differs on the card: "
                         f"{bad} {card.last_repair} {cpu.last_repair}")
    vsum_diff = answers_equal(
        torch, tuple(type(x)(*(t.cpu() for t in x)) for x in card_ans),
        cpu_ans, "the small mesh on the card against the CPU")
    if int(cpu.state.tup_overwritten.sum()) == 0 \
            or cpu.last_repair["shards_replaced"] == 0:
        raise SystemExit("federation: the small scenario did not wrap and repair")
    return {"blocks": FED_BLOCKS,
            "leaves_equal_per_block": len(cpu.blocks[0].index) + len(cpu.blocks[0]) - 1,
            "repair": cpu.last_repair, "count": cpu_ans[0].count.tolist(),
            "vsum_max_abs_diff": vsum_diff}


def federation_phase(torch, dev, cfg, city, payloads, metas, chunks,
                     batches, specs, seed: int, card: str, do_profile: bool,
                     n_drones: int = 400, fail_rounds: int = 48,
                     capacity: int = RESILIENCE_CAPACITY) -> dict:
    """The federated runtime on a one-process edge mesh: FED_BLOCKS blocks
    of the store on the card against the single store on the card.

    Day leg, at the main path's D400 width: a mesh session
    (``make_edge_mesh(4)``: 4 blocks of 20 edges on ``dev``) and a single
    session take the main path's rounds in its chunks, in turns (chunk 0 a
    warm-up; CUDA events around each later chunk); (F1) every leaf of the
    mesh's gathered store equals the single store's, bitwise; (F2) the main
    path's three batches, single- and 4-channel, under ``min_shards``, and
    the 5 km batch under ``random`` (an explicit key) and ``min_edges``
    sessions adopting both stores, give equal answers (``answers_equal``);
    each batch's p50 on both over 3 timed repetitions after a warm-up.
    Failure leg, at the resilience config (4 failure domains,
    ``capacity``-slot rings, ``fail_rounds`` rounds of a fresh
    ``n_drones`` fleet): a mesh and a single session in lockstep,
    ``fail_device(1)`` halfway, ``recover_device(1)`` (the incremental
    repair) at the end; (F3) the leaves and the ledgers
    equal after the outage's rounds and after the repair, the repair
    telemetry equal, the 1 km x 1800 s batch equal during the outage and
    after it; the repair walls, their host seconds by part and the mesh's
    gather and write-back alone. (F4) ``federation_small_card_vs_cpu``.
    (F5) the counts are set to 0 at the start and each part's launches
    equal FED_BLOCKS times the single store's count (FED_PER_INSERT,
    FED_PER_BATCH) on the mesh and once that count on the single store."""
    import dataclasses
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import AggSpec, make_pred
    from repro_torch.data.synthetic import DroneFleet, make_query_workload
    from repro_torch.distributed.sharding import gather_store, shard_store
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops
    from repro_torch.launch.mesh import make_edge_mesh
    mods = {"hash64": hash64_ops, "voronoi_assign": vor_ops, "st_scan": st_ops}
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    got = {}                    # part -> launches on the mesh and the single

    def counted(part, fn):
        before = {k: m.launches for k, m in mods.items()}
        out = fn()
        acc = got.setdefault(part, dict.fromkeys(mods, 0))
        for k, m in mods.items():
            acc[k] += m.launches - before[k]
        return out

    mesh = make_edge_mesh(FED_BLOCKS, cfg.n_edges, device=dev)
    sess = {"mesh": AerialDB.open(cfg, mesh), "single": AerialDB.open(cfg, device=dev)}
    ingest_ms = dict.fromkeys(sess, 0.0)
    for ci, sl in enumerate(chunks):
        part = (payloads[sl], type(metas)(*(f[sl] for f in metas)))
        for name, db in sess.items():
            torch.cuda.synchronize()
            ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            ev0.record()
            counted(f"{name}_ingest", lambda db=db: db.ingest_rounds(*part))
            ev1.record()
            ev1.synchronize()
            if ci > 0:
                ingest_ms[name] += ev0.elapsed_time(ev1)
    timed_rounds = len(payloads) - (chunks[0].stop - chunks[0].start)
    shards = timed_rounds * payloads.shape[1]
    mdb, sdb = sess["mesh"], sess["single"]
    bad = states_equal(torch, mdb.state, sdb.state)
    if bad:
        raise SystemExit(f"federation F1: the mesh's store differs at {bad}")
    blocks_own = len({t.untyped_storage().data_ptr()
                      for b in mdb.blocks + sdb.blocks
                      for t in (b.tup_f, b.tup_sid, b.steps, b.index.ent_i)})
    if blocks_own != 4 * (FED_BLOCKS + 1):
        raise SystemExit("federation F1: a block shares storage with another "
                         f"store ({blocks_own} distinct)")

    # F2: the main path's batches on both, then the 5 km batch per planner.
    times = {n: {bi: [] for bi in range(len(batches))} for n in sess}
    vsum_diff = 0.0
    preds = [make_pred(q=64, **w, has_spatial=True, has_temporal=True,
                       is_and=True, device=dev) for _, _, _, w in batches]
    for rep in range(4):
        for bi, pred in enumerate(preds):
            for si, spec in enumerate(specs):
                ans = {}
                for name, db in sess.items():
                    torch.cuda.synchronize()
                    q0 = time.perf_counter()
                    ans[name] = counted(f"{name}_queries", lambda db=db: db.query(
                        pred, agg=spec, key=(seed, bi)))
                    torch.cuda.synchronize()
                    if rep > 0:
                        times[name][bi].append((time.perf_counter() - q0) * 1e3)
                if rep == 0:
                    vsum_diff = max(vsum_diff, answers_equal(
                        torch, ans["mesh"], ans["single"],
                        f"batch {bi} spec {si}"))
    n_batches = 4 * len(preds) * len(specs)
    planners = {}
    for planner in ("random", "min_edges"):
        pcfg = dataclasses.replace(cfg, planner=planner)
        pm = AerialDB(pcfg, mdb.blocks, mesh=mesh)
        ps = AerialDB(pcfg, sdb.state, device=dev)
        row = {}
        for si, spec in enumerate(specs):
            a = counted("mesh_queries", lambda: pm.query(preds[2], agg=spec,
                                                          key=(seed, 5)))
            b = counted("single_queries", lambda: ps.query(preds[2], agg=spec,
                                                            key=(seed, 5)))
            row[f"spec{si}_vsum_max_abs_diff"] = answers_equal(
                torch, a, b, f"{planner} spec {si}")
            row[f"spec{si}_matched"] = int((a[0].count > 0).sum())
        planners[planner] = row
        n_batches += len(specs)
    profiles = {}
    if do_profile:      # after the checks: the profiled chunk goes in twice
        sl = chunks[1]
        again = (payloads[sl], type(metas)(*(f[sl] for f in metas)))
        for name, db in sess.items():
            profiles[f"query_5km_4ch_{name}"] = profile(
                torch, lambda db=db: db.query(preds[2], agg=specs[1],
                                              key=(seed, 2)))
            profiles[f"ingest_chunk_{name}"] = profile(
                torch, lambda db=db: db.ingest_rounds(*again), host_top=8)
    day_rounds = len(payloads)
    del pm, ps, sess, mdb, sdb
    torch.cuda.empty_cache()

    # Failure leg (F3).
    rcfg = dataclasses.replace(cfg, n_failure_domains=4,
                               tuple_capacity=capacity)
    rp, rm = DroneFleet(n_drones, city, records_per_shard=60, n_values=4,
                        seed=seed).next_rounds(fail_rounds)
    half = fail_rounds // 2
    rmesh = make_edge_mesh(FED_BLOCKS, rcfg.n_edges, device=dev)
    fail = {"mesh": AerialDB.open(rcfg, rmesh),
            "single": AerialDB.open(rcfg, device=dev)}
    # The resilience phase's batch over its two windows: the last 30
    # minutes, and the 30 minutes before the failure (replicas lost).
    w = make_query_workload(np.random.default_rng(seed + 2), 64, city,
                            float(rp[..., 0].max()), 1.0, 1800.0)
    fpreds = {}
    for name, t_end in (("recent", float(rp[..., 0].max())),
                        ("before_failure", float(rp[:half, ..., 0].max()))):
        t0_ = np.full(64, t_end - RECENT_S, np.float32)
        fpreds[name] = make_pred(
            q=64, **{**w, "t0": t0_, "t1": t0_ + np.float32(1800.0)},
            has_spatial=True, has_temporal=True, is_and=True, device=dev)
    spec4 = AggSpec(channels=(0, 1, 2, 3))

    def lockstep_check(when):
        m, s = fail["mesh"], fail["single"]
        bad = states_equal(torch, m.state, s.state)
        if bad or m.ledger() != s.ledger():
            raise SystemExit(f"federation F3 ({when}): leaves {bad} or the "
                             "ledgers differ")
        out = {}
        for name, p in fpreds.items():
            a = counted("mesh_queries", lambda: m.query(p, agg=spec4))
            b = counted("single_queries", lambda: s.query(p, agg=spec4))
            out[name] = {
                "vsum_max_abs_diff": answers_equal(torch, a, b,
                                                   f"F3 {when}, {name}"),
                "replicas_lost_sum": int(a[0].replicas_lost.sum()),
                "matched_queries": int((a[0].count > 0).sum())}
        return out
    for name, db in fail.items():
        counted(f"{name}_ingest", lambda db=db: db.ingest_rounds(
            rp[:half], type(rm)(*(f[:half] for f in rm))))
        db.fail_device(1)
        counted(f"{name}_ingest", lambda db=db: db.ingest_rounds(
            rp[half:], type(rm)(*(f[half:] for f in rm))))
    n_batches += len(fpreds)
    during = lockstep_check("during the outage")
    if during["before_failure"]["replicas_lost_sum"] <= 0:
        raise SystemExit("federation F3: no replica was lost during the outage")
    repair = {}
    for name, db in fail.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counted(f"{name}_repair", lambda db=db: db.recover_device(1))
        torch.cuda.synchronize()
        repair[name] = {"wall_s": time.perf_counter() - t0,
                        "seconds": db.last_repair_seconds}
    if fail["mesh"].last_repair != fail["single"].last_repair:
        raise SystemExit(f"federation F3: the repairs differ: "
                         f"{fail['mesh'].last_repair} {fail['single'].last_repair}")
    n_batches += len(fpreds)
    after = lockstep_check("after the repair")
    # The mesh's repair gathers the blocks and writes the result back: each
    # alone, on the repaired store (writing back what is there).
    mblocks = fail["mesh"].blocks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = gather_store(mblocks)
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shard_store(whole, rmesh, into=mblocks)
    torch.cuda.synchronize()
    write_back_s = time.perf_counter() - t0
    fail_repair = fail["single"].last_repair
    peak = torch.cuda.max_memory_allocated() / 2**30
    del whole, mblocks, fail
    torch.cuda.empty_cache()
    small = counted("small_card_vs_cpu", lambda: federation_small_card_vs_cpu(
        torch, dev))

    # F5: each part's launches against FED_BLOCKS x the store's counts; a
    # repair runs once, on the gathered store, on either.
    n_inserts = day_rounds + fail_rounds
    want = {}
    for name, k in (("mesh", FED_BLOCKS), ("single", 1)):
        want[f"{name}_ingest"] = {m: k * c * n_inserts
                                  for m, c in FED_PER_INSERT.items()}
        want[f"{name}_queries"] = {m: k * c * n_batches
                                   for m, c in FED_PER_BATCH.items()}
    want["mesh_repair"] = got["single_repair"]
    off = {p: (got.get(p), w_) for p, w_ in want.items() if got.get(p) != w_}
    if off or got["single_repair"]["hash64"] <= 0:
        raise SystemExit(f"federation F5: launches against the prediction: {off}")
    launches = {k: m.launches for k, m in mods.items()}
    if min(launches.values()) <= 0:
        raise SystemExit(f"federation: a kernel never launched: {launches}")
    mesh_ms, single_ms = ingest_ms["mesh"], ingest_ms["single"]
    return {
        "card": card, "blocks": FED_BLOCKS, "edges_per_block": cfg.n_edges // FED_BLOCKS,
        "day_rounds": day_rounds, "timed_rounds": timed_rounds,
        "checks": {"F1_day_leaves_equal": True, "F2_batches_equal": True,
                   "F3_failure_leg_equal": True, "F4_small_card_vs_cpu": True,
                   "F5_launches_as_predicted": True},
        "ingest_shards_per_s": {"mesh": shards / (mesh_ms / 1e3),
                                "single": shards / (single_ms / 1e3)},
        "ingest_device_s": {"mesh": mesh_ms / 1e3, "single": single_ms / 1e3},
        "query_batch_p50_ms": {n: {f"{batches[bi][0]}km_{batches[bi][1]:.0f}s":
                                   float(np.median(v)) for bi, v in t.items()}
                               for n, t in times.items()},
        "batches_vsum_max_abs_diff": vsum_diff, "planners": planners,
        "blocks_distinct_storages": blocks_own,
        "failure": {"during": during, "after": after, "repair": fail_repair,
                    "repair_wall_s": {n: r["wall_s"] for n, r in repair.items()},
                    "repair_seconds": {n: r["seconds"] for n, r in repair.items()},
                    "mesh_gather_s": gather_s, "mesh_write_back_s": write_back_s},
        "small_card_vs_cpu": small,
        "launches": launches, "launches_by_part": got,
        "launches_predicted": want, "query_batches": n_batches,
        "profiles": profiles,
        "peak_mem_gb": peak, "phase_s": time.perf_counter() - t_phase}


FLEET = (2, 2)                 # the fleet phase's mesh: 2 fleets of 2 blocks on one card
FLEET_TILES = 2                # a fleet mesh runs a batch of >= 2 queries in 2 tiles
MULTIHOST_ROUNDS = 24          # the two-process leg's rounds at D400 width
MULTIHOST_TIMEOUT_S = 600


def fleet_phase(torch, dev, cfg, payloads, metas, chunks, batches, specs,
                seed: int, card: str, do_profile: bool = False,
                multihost_rounds: int = MULTIHOST_ROUNDS,
                multihost_args=("--device", "cuda", "--width", "d400")
                ) -> dict:
    """The federated runtime on a one-process 2-D fleet mesh, and on two
    processes.

    (G1) A fleet-mesh session (``make_fleet_mesh(2, 2, 80)``: 2 fleets of 2
    blocks of 20 edges on ``dev``) and a single session take the main
    path's rounds in its chunks, in turns (chunk 0 a warm-up; CUDA events
    around each later chunk); every leaf of the gathered store equals the
    single store's, bitwise, and every block has storage of its own. (G2)
    The main path's three batches, single- and 4-channel, under
    ``min_shards``, and the 5 km batch under ``random`` and ``min_edges``
    sessions adopting both stores, give equal answers (``answers_equal``);
    each batch's p50 on both over 3 timed repetitions after a warm-up.
    (G3) The counts are set to 0 at the start; each part's launches equal
    the prediction: an insert FED_PER_INSERT on each block, a 64-query
    batch the lookup sets' hash64 and voronoi_assign once a block and
    st_scan once a tile and block on the fleet mesh, FED_PER_BATCH on the
    single store. (G4) ``federation_small_card_vs_cpu`` on a fleet mesh.
    With ``do_profile``, after the checks: the device-time breakdown of the
    5 km 4-channel batch and of one more ingest chunk on both stores.
    (G5) ``python -m repro_torch.launch.multihost_smoke`` with
    ``multihost_args`` (default: on the card at D400 width) and
    ``multihost_rounds`` rounds: 2 gloo processes, one a fleet, each
    holding its blocks and answers to its own single store; both must exit
    0."""
    import dataclasses
    import os
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import make_pred
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops
    from repro_torch.launch.mesh import make_fleet_mesh
    mods = {"hash64": hash64_ops, "voronoi_assign": vor_ops, "st_scan": st_ops}
    n_blocks = FLEET[0] * FLEET[1]
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    got = {}                    # part -> launches on the fleet mesh and the single

    def counted(part, fn):
        before = {k: m.launches for k, m in mods.items()}
        out = fn()
        acc = got.setdefault(part, dict.fromkeys(mods, 0))
        for k, m in mods.items():
            acc[k] += m.launches - before[k]
        return out

    mesh = make_fleet_mesh(*FLEET, cfg.n_edges, device=dev)
    sess = {"fleet": AerialDB.open(cfg, mesh),
            "single": AerialDB.open(cfg, device=dev)}
    ingest_ms = dict.fromkeys(sess, 0.0)
    for ci, sl in enumerate(chunks):
        part = (payloads[sl], type(metas)(*(f[sl] for f in metas)))
        for name, db in sess.items():
            torch.cuda.synchronize()
            ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            ev0.record()
            counted(f"{name}_ingest", lambda db=db: db.ingest_rounds(*part))
            ev1.record()
            ev1.synchronize()
            if ci > 0:
                ingest_ms[name] += ev0.elapsed_time(ev1)
    timed_rounds = len(payloads) - (chunks[0].stop - chunks[0].start)
    shards = timed_rounds * payloads.shape[1]
    fdb, sdb = sess["fleet"], sess["single"]
    bad = states_equal(torch, fdb.state, sdb.state)
    if bad:
        raise SystemExit(f"fleet G1: the fleet mesh's store differs at {bad}")
    blocks_own = len({t.untyped_storage().data_ptr()
                      for b in fdb.blocks + sdb.blocks
                      for t in (b.tup_f, b.tup_sid, b.steps, b.index.ent_i)})
    if blocks_own != 4 * (n_blocks + 1):
        raise SystemExit("fleet G1: a block shares storage with another "
                         f"store ({blocks_own} distinct)")

    # G2: the main path's batches on both, then the 5 km batch per planner.
    times = {n: {bi: [] for bi in range(len(batches))} for n in sess}
    vsum_diff = 0.0
    preds = [make_pred(q=64, **w, has_spatial=True, has_temporal=True,
                       is_and=True, device=dev) for _, _, _, w in batches]
    for rep in range(4):
        for bi, pred in enumerate(preds):
            for si, spec in enumerate(specs):
                ans = {}
                for name, db in sess.items():
                    torch.cuda.synchronize()
                    q0 = time.perf_counter()
                    ans[name] = counted(f"{name}_queries", lambda db=db: db.query(
                        pred, agg=spec, key=(seed, bi)))
                    torch.cuda.synchronize()
                    if rep > 0:
                        times[name][bi].append((time.perf_counter() - q0) * 1e3)
                if rep == 0:
                    vsum_diff = max(vsum_diff, answers_equal(
                        torch, ans["fleet"], ans["single"],
                        f"fleet G2 batch {bi} spec {si}"))
    n_batches = 4 * len(preds) * len(specs)
    planners = {}
    for planner in ("random", "min_edges"):
        pcfg = dataclasses.replace(cfg, planner=planner)
        pf = AerialDB(pcfg, fdb.blocks, mesh=mesh)
        ps = AerialDB(pcfg, sdb.state, device=dev)
        row = {}
        for si, spec in enumerate(specs):
            a = counted("fleet_queries", lambda: pf.query(preds[2], agg=spec,
                                                           key=(seed, 5)))
            b = counted("single_queries", lambda: ps.query(preds[2], agg=spec,
                                                            key=(seed, 5)))
            row[f"spec{si}_vsum_max_abs_diff"] = answers_equal(
                torch, a, b, f"fleet G2 {planner} spec {si}")
            row[f"spec{si}_matched"] = int((a[0].count > 0).sum())
        planners[planner] = row
        n_batches += len(specs)
    profiles = {}
    if do_profile:      # not counted by part
        sl = chunks[1]
        again = (payloads[sl], type(metas)(*(f[sl] for f in metas)))
        for name, db in sess.items():
            profiles[f"query_5km_4ch_{name}"] = profile(
                torch, lambda db=db: db.query(preds[2], agg=specs[1],
                                              key=(seed, 2)))
            profiles[f"ingest_chunk_{name}"] = profile(
                torch, lambda db=db: db.ingest_rounds(*again), host_top=8)
    day_rounds = len(payloads)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del pf, ps, sess, fdb, sdb
    torch.cuda.empty_cache()
    small = counted("small_card_vs_cpu", lambda: federation_small_card_vs_cpu(
        torch, dev, n_fleet=FLEET[0]))

    # G3: each part's launches against the prediction.
    per_batch = {"hash64": FED_PER_BATCH["hash64"] * n_blocks,
                 "voronoi_assign": FED_PER_BATCH["voronoi_assign"] * n_blocks,
                 "st_scan": FED_PER_BATCH["st_scan"] * n_blocks * FLEET_TILES}
    want = {"fleet_ingest": {m: n_blocks * c * day_rounds
                             for m, c in FED_PER_INSERT.items()},
            "single_ingest": {m: c * day_rounds
                              for m, c in FED_PER_INSERT.items()},
            "fleet_queries": {m: c * n_batches for m, c in per_batch.items()},
            "single_queries": {m: c * n_batches
                               for m, c in FED_PER_BATCH.items()}}
    off = {p: (got.get(p), w_) for p, w_ in want.items() if got.get(p) != w_}
    if off:
        raise SystemExit(f"fleet G3: launches against the prediction: {off}")
    launches = {k: m.launches for k, m in mods.items()}
    if min(launches.values()) <= 0:
        raise SystemExit(f"fleet: a kernel never launched: {launches}")

    # G5: two processes, one a fleet, both on the card.
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parent / "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.launch.multihost_smoke",
           *multihost_args, "--rounds", str(multihost_rounds),
           "--timeout", str(MULTIHOST_TIMEOUT_S)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=MULTIHOST_TIMEOUT_S + 60)
    mh_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"fleet G5: the two-process smoke exited "
                         f"{proc.returncode}: {proc.stderr[-3000:]}")
    mh = json.loads(proc.stdout.strip().splitlines()[-1])
    workers = mh["workers"]
    if [w["fleet"] for w in workers] != [0, 1] or any(
            w["device"].split(":")[0] != dev.type or w["gloo_exchanges"] <= 0
            or (dev.type == "cuda" and min(w["launches"].values()) <= 0)
            for w in workers):
        raise SystemExit(f"fleet G5: unexpected worker reports {workers}")
    fleet_ms, single_ms = ingest_ms["fleet"], ingest_ms["single"]
    return {
        "card": card, "mesh": mesh.shape, "edges_per_block": cfg.n_edges // n_blocks,
        "tiles": FLEET_TILES, "day_rounds": day_rounds, "timed_rounds": timed_rounds,
        "checks": {"G1_day_leaves_equal": True, "G2_batches_equal": True,
                   "G3_launches_as_predicted": True,
                   "G4_small_card_vs_cpu": True,
                   "G5_two_processes_on_the_card": True},
        "ingest_shards_per_s": {"fleet": shards / (fleet_ms / 1e3),
                                "single": shards / (single_ms / 1e3)},
        "ingest_device_s": {"fleet": fleet_ms / 1e3, "single": single_ms / 1e3},
        "query_batch_p50_ms": {n: {f"{batches[bi][0]}km_{batches[bi][1]:.0f}s":
                                   float(np.median(v)) for bi, v in t.items()}
                               for n, t in times.items()},
        "batches_vsum_max_abs_diff": vsum_diff, "planners": planners,
        "blocks_distinct_storages": blocks_own, "small_card_vs_cpu": small,
        "launches": launches, "launches_by_part": got,
        "launches_predicted": want, "query_batches_per_store": n_batches,
        "profiles": profiles,
        "multihost": {"wall_s": mh_wall, "smoke_wall_s": mh["wall_s"],
                      "rounds": mh["rounds"], "edges": mh["edges"],
                      "drones": mh["drones"],
                      "gloo_exchanges": [w["gloo_exchanges"] for w in workers],
                      "host_syncs": [w["host_syncs"] for w in workers],
                      "exchange_host_s": [w["exchange_host_s"] for w in workers],
                      "worker_s": [w["worker_s"] for w in workers],
                      "leaves_checked": [w["leaves_checked"] for w in workers],
                      "counts": workers[0]["counts"],
                      "worker_launches": [w["launches"] for w in workers]},
        "peak_mem_gb": peak, "phase_s": time.perf_counter() - t_phase}


def scan_vs_plain(torch, args_scan, channels, cap: int, what: str,
                  want_nan: bool = False) -> float:
    """st_scan's kernel against its plain version on ``args_scan``: count,
    vmin and vmax bitwise (NaN where the plain version has NaN), vsum to
    rtol 1e-5, and a second kernel call bitwise equal to the first. Exits
    non-zero on a mismatch (or, with ``want_nan``, when no NaN reached the
    plain version's minima); returns the largest vsum difference."""
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.st_scan.ref import st_scan_ref
    rows = tuple(3 + c for c in channels)
    got = st_ops.st_scan_cuda(*args_scan, rows, cap)
    again = st_ops.st_scan_cuda(*args_scan, rows, cap)
    want = st_scan_ref(*args_scan, channels=channels, valid_c=cap)
    try:
        if not torch.equal(got[0], want[0]):
            raise AssertionError("count differs")
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0,
                                   equal_nan=True)
        for g, x in zip(got[2:], want[2:]):
            torch.testing.assert_close(g, x, rtol=0, atol=0, equal_nan=True)
    except AssertionError as err:
        raise SystemExit(f"st_scan differs from plain ({what}, K {len(rows)}): "
                         f"{err}")
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, again)):
        raise SystemExit(f"st_scan ({what}): a second call gave other bits")
    if want_nan and not torch.isnan(want[2]).any():
        raise SystemExit(f"st_scan ({what}): no NaN reached the plain minima")
    d = (got[1] - want[1]).abs()
    d = d[~torch.isnan(d)]
    return float(d.max()) if d.numel() else 0.0


def st_scan_phase(torch, dev, cfg, st, alive, batches, specs) -> dict:
    """st_scan's kernel against its plain version on the main path's scan
    inputs (the three batches at 1 and 4 channels), on a copy of the day's
    log with NaN in a channel of every 7th matched slot (and of some
    unmatched ones), and on a copy rolled by a third of the ring with every
    count above capacity; then its device time at each batch and channel
    count beside the bytes it must move: five hot words a live slot of a
    selected edge, K channel words a slot some query matched (the plain
    version's masks), the listed entries, the lengths, the predicates and
    the outputs. Exits non-zero on any mismatch."""
    from repro_torch.core.datastore import make_pred, plan_subqueries
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.st_scan.ref import matched_slots, st_scan_ref
    cap = cfg.tuple_capacity
    q = 64
    channel_sets = {1: specs[0].channels, 4: specs[1].channels}
    scan_err, checks, scans = 0.0, 0, []
    for bi in range(3):
        p = make_pred(q=q, **batches[bi][3], has_spatial=True,
                      has_temporal=True, is_and=True, device=dev)
        subl, slen, _ = plan_subqueries(cfg, st, p, alive)
        args_scan = (st.tup_f, st.tup_sid, st.tup_count, p, subl, slen)
        for chans in channel_sets.values():
            scan_err = max(scan_err, scan_vs_plain(torch, args_scan, chans, cap,
                                                   f"batch {bi}"))
            checks += 1
        scans.append((args_scan, matched_slots(*args_scan, valid_c=cap)))
    args_scan, matched = scans[2]
    nan_f = st.tup_f.clone()
    hit = matched.nonzero()[::7]
    nan_f[hit[:, 0], 3, hit[:, 1]] = float("nan")
    nan_f[:, 4, ::1009] = float("nan")
    scan_vs_plain(torch, (nan_f, *args_scan[1:]), specs[1].channels, cap,
                  "NaN copy", want_nan=True)
    del nan_f
    rolled = (torch.roll(st.tup_f[..., :cap], cap // 3, dims=2).contiguous(),
              torch.roll(st.tup_sid[..., :cap], cap // 3, dims=2).contiguous(),
              torch.full_like(st.tup_count, 3 * cap))
    scan_vs_plain(torch, (*rolled, *args_scan[3:]), specs[1].channels, cap,
                  "rolled copy")
    checks += 2
    del rolled

    scan_rows = {k: tuple(3 + c for c in ch) for k, ch in channel_sets.items()}
    n_valid = torch.clamp(st.tup_count, max=cap).double()
    per_batch = []
    for bi, (a, matched) in enumerate(scans):
        subl, slen = a[4], a[5]
        selected = (slen != 0).any(dim=0)
        live = float((n_valid * selected).sum())
        n_matched = int(matched.sum())
        listed = int(slen.clamp(0, subl.shape[2]).sum())
        row = {"batch": f"{batches[bi][0]} km x {batches[bi][1]:.0f} s",
               "selected_edges": int(selected.sum()), "live_slots": live,
               "matched_slots": n_matched, "listed_entries": listed}
        for k, rows_k in scan_rows.items():
            nbytes = (live * 5 + n_matched * k) * 4 + listed * 8 \
                + slen.numel() * 4 + q * 16 * 4 + slen.numel() * 4 * (1 + 3 * k)
            row[f"k{k}_bytes"] = nbytes
            row[f"k{k}_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            row[f"k{k}_device_ms"] = device_ms(
                torch, lambda: st_ops.st_scan_cuda(*a, rows_k, cap), 10,
                "st_scan_kernel")
        per_batch.append(row)
    a = scans[2][0]
    rows = scan_rows[4]
    # the earlier count, for comparison: nine words every live slot of a
    # selected edge, every list entry
    old_bytes = per_batch[2]["live_slots"] * (5 + len(rows)) * 4 \
        + (a[4].numel() + a[5].numel()) * 4 + a[5].numel() * 4 * (1 + 3 * len(rows))
    return {
        "rows": rows, "err": scan_err, "checks": checks, "batches": per_batch,
        "bytes": per_batch[2]["k4_bytes"], "old_bytes": old_bytes,
        "device_ms": per_batch[2]["k4_device_ms"],
        "ms": cuda_ms(torch, lambda: st_ops.st_scan_cuda(*a, rows, cap), 20),
        "k1_ms": cuda_ms(torch, lambda: st_ops.st_scan_cuda(
            *a, scan_rows[1], cap), 20),
        "plain_ms": cuda_ms(torch, lambda: st_scan_ref(
            *a, channels=specs[1].channels, valid_c=cap), 1)}


def flash_vs_plain(torch, dev, seed: int) -> dict:
    """flash_attention's kernels against their plain version on the card:
    fp32 at the JAX package's kernel-test shapes, decode rows and a ragged
    size (to FLASH_F32_TOL), bf16 at the serve shapes of internlm2-1.8b
    (d 128), stablelm-12b (d 160), zamba2-1.2b (d 64, GQA group 1),
    deepseek-7b (d 128, GQA group 1) and grok-1-314b (d 128, GQA group 6),
    decode rows and ragged cases (to
    FLASH_BF16_TOL), each bf16 case through the kernel the wrapper chooses
    and through every kernel that takes it, forced; the sm90 and decode
    kernels twice, bitwise. Exits non-zero on
    any mismatch or on a call that went to another kernel than expected;
    returns the largest errors by dtype, by bf16 kernel, by bf16 kernel
    and head dim (``bfloat16_<kernel>_d<d>``) and by bf16 kernel, head dim
    and GQA group (``bfloat16_<kernel>_d<d>_g<G>``; grok-1-314b's G 6).
    MLA's unequal head dims at the shapes its paths give them, v a strided
    view as MLA passes it: deepseek-v2-236b's bf16 prefill (sm90, and
    mma_sync forced), a bf16 call with 1 < Sq < 64, the fp32 dense-layer
    check's (192, 128) and mla_vs_cpu's (48, 32), each by
    ``<dtype>_<kernel>_mla<d_qk>``."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(seed)
    # (b, sq, skv, h, kv, dh, causal, q_offset)
    f32_cases = [(1, 256, 256, 4, 4, 64, True, 0),
                 (2, 256, 256, 8, 2, 32, True, 0),      # GQA group 4
                 (1, 384, 384, 4, 1, 64, False, 0),     # MQA, bidirectional
                 (1, 128, 128, 2, 2, 128, True, 0),
                 (2, 77, 131, 4, 2, 64, True, 54),      # ragged Sq and Skv
                 (2, 77, 131, 4, 2, 64, False, 0)]
    f32_cases += [(SERVE_BATCH, 1, MAX_SEQ, 16, 8, 128, True, p)
                  for p in (0, 63, 64, 191, 255)]
    # stablelm-12b's head dim on the mma_sync kernel (the fp32 instance)
    f32_cases += [(1, 256, 256, 4, 1, 160, True, 0),
                  (2, 77, 131, 4, 2, 160, True, 54),
                  (2, 77, 131, 4, 2, 160, False, 0),
                  (SERVE_BATCH, 1, MAX_SEQ, 32, 8, 160, True, 191)]
    bf16_cases = [(SERVE_BATCH, PREFILL_LEN, PREFILL_LEN, 16, 8, 128, True, 0),
                  (2, 77, 131, 4, 2, 128, True, 54),    # ragged, d 128
                  (SERVE_BATCH, 1, MAX_SEQ, 16, 8, 128, True, 191),
                  (SERVE_BATCH, 1, MAX_SEQ, 16, 8, 128, True, 0),
                  (SERVE_BATCH, 1, LONG_SEQ, 16, 8, 128, True, LONG_SEQ - 1),
                  (8, 1, 128, 4, 2, 32, True, 35),      # the lm-serve example's last step
                  (2, 1, MAX_SEQ, 40, 8, 128, True, 100),   # qwen3-14b heads
                  # stablelm-12b: 32 heads over 8, d 160
                  (SERVE_BATCH, PREFILL_LEN, PREFILL_LEN, 32, 8, 160, True, 0),
                  (2, 77, 131, 4, 2, 160, True, 54),    # ragged, d 160
                  (SERVE_BATCH, 1, MAX_SEQ, 32, 8, 160, True, 0),
                  (SERVE_BATCH, 1, MAX_SEQ, 32, 8, 160, True, 191),
                  (SERVE_BATCH, 1, LONG_SEQ, 32, 8, 160, True, LONG_SEQ - 1),
                  # deepseek-7b: 32 heads over 32 (GQA group 1), d 128
                  (2, 1, MAX_SEQ, 32, 32, 128, True, 191),
                  (1, PREFILL_LEN, PREFILL_LEN, 32, 32, 128, True, 0),
                  # zamba2-1.2b's shared block: 32 heads over 32, d 64
                  (SERVE_BATCH, PREFILL_LEN, PREFILL_LEN, 32, 32, 64, True, 0),
                  (2, 77, 131, 4, 2, 64, True, 54),     # ragged, d 64
                  (SERVE_BATCH, 1, MAX_SEQ, 32, 32, 64, True, 191),
                  # grok-1-314b: 48 heads over 8 (GQA group 6), d 128
                  (SERVE_BATCH, PREFILL_LEN, PREFILL_LEN, 48, 8, 128, True, 0),
                  (SERVE_BATCH, 1, MAX_SEQ, 48, 8, 128, True, 191)]
    errs = {}
    n_calls = 0
    for dtype, cases, tol in ((torch.float32, f32_cases, FLASH_F32_TOL),
                              (torch.bfloat16, bf16_cases, FLASH_BF16_TOL)):
        worst = 0.0
        for case in cases:
            b, sq, skv, h, kv, dh, causal, off = case
            q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                       .to(dev, dtype) for shape in ((b, sq, h, dh), (b, skv, kv, dh),
                                                     (b, skv, kv, dh)))
            want = flash_attention_ref(q, k, v, causal=causal, q_offset=off)
            chosen = fops._variant(q, k, v)
            forced = () if dtype != torch.bfloat16 else \
                (chosen, "mma_sync") if chosen != "mma_sync" else ("mma_sync",)
            for variant in (None, *forced):
                before = dict(fops.launches_by_variant)
                got = fops.flash_attention_cuda(q, k, v, causal=causal,
                                                q_offset=off, variant=variant)
                ran = variant or chosen
                if fops.launches_by_variant[ran] != before[ran] + 1:
                    raise SystemExit(f"flash_attention {case}: variant {variant} "
                                     f"did not launch {ran}")
                err = (got.float() - want.float()).abs()
                bad = int((err > tol + tol * want.float().abs()).sum())
                if bad or not torch.isfinite(got).all():
                    raise SystemExit(f"flash_attention {dtype} {ran} {case}: {bad} "
                                     f"elements beyond {tol}, max err {float(err.max())}")
                if ran in ("decode", "sm90") and not torch.equal(
                        got, fops.flash_attention_cuda(q, k, v, causal=causal,
                                                       q_offset=off, variant=ran)):
                    raise SystemExit(f"flash_attention {ran} {case}: a second "
                                     "call gave other bits")
                worst = max(worst, float(err.max()))
                if dtype == torch.bfloat16:
                    for key in (f"bfloat16_{ran}", f"bfloat16_{ran}_d{dh}",
                                f"bfloat16_{ran}_d{dh}_g{h // kv}"):
                        errs[key] = max(errs.get(key, 0.0), float(err.max()))
                n_calls += 1
        errs[str(dtype).removeprefix("torch.")] = worst
    # (dtype, b, sq, skv, h, kv, d_qk, d_v, causal, q_offset)
    mla_cases = [(torch.bfloat16, SERVE_BATCH, PREFILL_LEN, PREFILL_LEN, 128, 128,
                  192, 128, True, 0),                   # deepseek's prefill: sm90
                 (torch.bfloat16, 2, 33, 80, 8, 8, 192, 128, True, 47),   # mma_sync
                 (torch.float32, SERVE_BATCH, PROMPT_LEN, PROMPT_LEN, 128, 128,
                  192, 128, True, 0),                   # the fp32 dense-layer check
                 (torch.float32, 2, 64, 64, 4, 4, 48, 32, True, 0)]       # mla_vs_cpu
    # drawn on the card: deepseek's prefill is 1.3e9 normals, ~20 s on the host
    gen = torch.Generator(device=dev).manual_seed(seed)
    for case in mla_cases:
        dtype, b, sq, skv, h, kv, dk, dv, causal, off = case
        q, k, kvb = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((b, sq, h, dk), (b, skv, kv, dk), (b, skv, kv, 2 * dv)))
        v = kvb[..., dv:]
        want = flash_attention_ref(q, k, v, causal=causal, q_offset=off)
        chosen = fops._variant(q, k, v)
        tol = FLASH_BF16_TOL if dtype == torch.bfloat16 else FLASH_F32_TOL
        for ran in dict.fromkeys((chosen, "mma_sync")):
            before = fops.launches_by_variant[ran]
            got = fops.flash_attention_cuda(q, k, v, causal=causal, q_offset=off,
                                            variant=ran)
            err = (got.float() - want.float()).abs()
            bad = int((err > tol + tol * want.float().abs()).sum())
            if fops.launches_by_variant[ran] != before + 1 or bad \
                    or got.shape != (b, sq, h, dv) or not torch.isfinite(got).all() \
                    or not torch.equal(got, fops.flash_attention_cuda(
                        q, k, v, causal=causal, q_offset=off, variant=ran)):
                raise SystemExit(f"flash_attention MLA {case} {ran}: {bad} elements "
                                 f"beyond {tol}, max err {float(err.max())}, "
                                 "or another launch count, shape or bits")
            key = f"{str(dtype).removeprefix('torch.')}_{ran}_mla{dk}"
            errs[key] = max(errs.get(key, 0.0), float(err.max()))
            n_calls += 2
        del q, k, kvb, v, want
    phase("flash_vs_plain", f32_cases=len(f32_cases), bf16_cases=len(bf16_cases),
          mla_cases=len(mla_cases), kernel_calls=n_calls, max_abs_err=errs,
          f32_tol=FLASH_F32_TOL, bf16_tol=FLASH_BF16_TOL)
    return errs


def serve(torch, dev, seed: int, do_profile: bool, arch: str = SERVE_ARCH,
          param_dtype: str = "float32", tag: str = "serve",
          sample_seeds: tuple = (), layers: int | None = None) -> dict:
    """The LM serving path of ``arch`` at full width: prefill_step, then
    Engine.generate twice, as the lines ``<tag>_prefill`` and
    ``<tag>_generate``, then sampled at SAMPLE_TEMPERATURE once per seed of
    ``sample_seeds`` (``sampled_runs``; for internlm2-1.8b its own line
    ``serve_sampled``, else under ``sampled`` in the generate line).
    ``param_dtype`` is the dtype the weights are drawn in: "float32" (the
    engine casts a bf16 copy) or "bfloat16" (the engine's cast copies
    nothing). ``layers`` cuts the depth (None: the config's own). A dense
    or moe model launches the sm90 kernel at every prefill
    layer and the decode kernel at every decode layer (an MLA model none:
    its decode attends in the latent space); the hybrid family at
    every site of its shared block; the ssm family none (its prefill line
    also times the plain scan at one layer's shape, the hybrid's the plain
    SSD). Returns the flash launch counts of these runs by kernel (an MLA
    model's fp32 cut's under ``fp32_cut_``); the model and its weights are
    freed on return."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import hybrid_attn_sites
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train.train_loop import make_serve_steps

    class TimedEngine(Engine):
        """Records CUDA events around every decode step, keeps the logits
        after the last prompt token, with ``keep_picks`` the logits every
        pick was made from and with ``snapshot_at`` a copy of the cache
        before that position's step."""
        def __init__(self, *a, keep_picks=False, snapshot_at=None, **kw):
            super().__init__(*a, **kw)
            self.events, self.prompt_logits = [], None
            self.picks = [] if keep_picks else None
            self.snapshot_at, self.snapshot = snapshot_at, None

        def _step(self, cache, tokens, pos):
            if pos == self.snapshot_at:
                self.snapshot = {k: v.clone() for k, v in cache.items()}
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            cache, logits = super()._step(cache, tokens, pos)
            e1.record()
            self.events.append((e0, e1))
            if pos == PROMPT_LEN - 1:
                self.prompt_logits = logits.clone()
            return cache, logits

        def _sample(self, logits, key, i):
            if self.picks is not None:
                self.picks.append(logits.clone())
            return super()._sample(logits, key, i)

    phase_t0 = time.perf_counter()
    cfg = get_config(arch).replace(param_dtype_str=param_dtype)
    full_layers = cfg.n_layers
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    model = Model(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    n_params = sum(int(x.numel()) for x in _leaves(params))
    # flash calls a forward: one a layer (dense, moe), one a site of the
    # hybrid's shared block, none in the ssm family
    attn = {"dense": cfg.n_layers, "moe": cfg.n_layers,
            "hybrid": len(hybrid_attn_sites(cfg))}.get(cfg.family, 0)
    recurrent = cfg.family in ("ssm", "hybrid")  # a scan state the control can lose
    is_moe = cfg.family == "moe"
    # flash calls a decode step: none in MLA's latent-space decode
    dec_attn = 0 if cfg.mla else attn
    engine = TimedEngine(model, params, ServeConfig(
        max_new_tokens=NEW_TOKENS, max_seq=MAX_SEQ),
        snapshot_at=PROMPT_LEN - SSM_CONTROL_STEPS if recurrent or is_moe else None)
    del params                      # the engine keeps the bf16 weights
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    eparams = engine.params
    weight_bytes = sum(int(x.numel()) * x.element_size() for x in _leaves(eparams))
    prefill_step, _ = make_serve_steps(model)
    rng = np.random.default_rng(seed + 7)
    long_prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_BATCH, PREFILL_LEN)).astype(np.int32)).to(dev)
    prompts = rng.integers(0, cfg.vocab, (SERVE_BATCH, PROMPT_LEN)).astype(np.int32)

    # prefill_step on 8 x 2048 tokens: one warm-up (its MoE routes
    # recorded), then timed runs.
    fops.launches = 0
    fops.launches_by_variant = dict.fromkeys(fops.launches_by_variant, 0)
    with RouteLog() as warm_routes:
        prefill_step(eparams, {"tokens": long_prompts})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        lg = prefill_step(eparams, {"tokens": long_prompts})
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    prefill_launches = fops.launches
    prefill_by_variant = dict(fops.launches_by_variant)
    if prefill_launches != 4 * attn or not torch.isfinite(lg).all() \
            or lg.shape != (SERVE_BATCH, cfg.vocab_padded) \
            or prefill_by_variant["sm90"] != prefill_launches:
        raise SystemExit(f"{tag} prefill: {prefill_launches} flash launches "
                         f"({prefill_by_variant}), logits {tuple(lg.shape)} "
                         f"finite={bool(torch.isfinite(lg).all())}")
    ms = float(np.median(times))
    family = {"family": cfg.family}
    if cfg.family == "ssm":
        family.update(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
                      ssm_chunk=cfg.ssm_chunk, ssm_scan=cfg.ssm_scan,
                      **scan_share(torch, model, eparams, long_prompts, ms))
    if cfg.family == "hybrid":
        # the bound: the bf16 products at the tensor cores' peak, the SSD's
        # float32 ones (the reference pins them to float32) at float32's
        flops = hybrid_prefill_flops(cfg, SERVE_BATCH, PREFILL_LEN)
        bound_s = (flops["total"] - flops["ssd_fp32"]) / BF16_FLOP_PER_S \
            + flops["ssd_fp32"] / FP32_FLOP_PER_S
        family.update(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
                      ssm_headdim=cfg.ssm_headdim, ssm_chunk=cfg.ssm_chunk,
                      attn_sites=hybrid_attn_sites(cfg), prefill_flops=flops,
                      prefill_bound_ms=bound_s * 1e3,
                      prefill_bound_tokens_per_s=SERVE_BATCH * PREFILL_LEN / bound_s,
                      **ssd_share(torch, model, eparams, long_prompts, ms))
    if is_moe:
        flops = moe_prefill_flops(cfg, SERVE_BATCH, PREFILL_LEN)
        bound_s = flops["total"] / BF16_FLOP_PER_S
        if cfg.mla:
            family.update(mla=True, kv_lora=cfg.kv_lora,
                          d_qk=cfg.mla_nope_dim + cfg.mla_rope_dim,
                          d_v=cfg.mla_v_dim, first_dense=cfg.first_dense,
                          d_ff_dense=cfg.d_ff, n_shared=cfg.n_shared)
        family.update(n_experts=cfg.n_experts, top_k=cfg.top_k,
                      d_ff_expert=cfg.d_ff_expert, capacity_factor=cfg.capacity_factor,
                      moe_dispatch=cfg.moe_dispatch, prefill_flops=flops,
                      prefill_bound_ms=bound_s * 1e3,
                      prefill_bound_tokens_per_s=SERVE_BATCH * PREFILL_LEN / bound_s,
                      routes=moe_loads(torch, warm_routes.idx, cfg, SERVE_BATCH * PREFILL_LEN))
    phase(f"{tag}_prefill", arch=arch, params=n_params, **family,
          n_layers=cfg.n_layers, config_n_layers=full_layers,
          d_model=cfg.d_model, n_heads=cfg.n_heads,
          n_kv=cfg.n_kv, d_head=cfg.d_head, param_dtype=param_dtype,
          weight_gb=weight_bytes / 1e9,
          batch=SERVE_BATCH, seq=PREFILL_LEN, init_s=init_s,
          init_peak_mem_gb=init_peak,
          prefill_ms=times, prefill_p50_ms=ms,
          prefill_tokens_per_s=SERVE_BATCH * PREFILL_LEN / (ms / 1e3),
          peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
          logits_shape=list(lg.shape),
          flash_launches=prefill_launches, flash_by_variant=prefill_by_variant)

    # Engine.generate: 8 requests, 128-token prompts, NEW_TOKENS new tokens.
    with RouteLog() as prompt_routes:
        ref_logits = prefill_step(eparams, {"tokens": torch.from_numpy(prompts).to(dev)})
    torch.cuda.reset_peak_memory_stats()
    fops.launches = 0
    fops.launches_by_variant = dict.fromkeys(fops.launches_by_variant, 0)
    w0 = time.perf_counter()
    ids = engine.generate(prompts)
    wall = time.perf_counter() - w0
    gen_launches = fops.launches
    gen_by_variant = dict(fops.launches_by_variant)
    want_launches = dec_attn * (PROMPT_LEN + NEW_TOKENS)
    if gen_launches != want_launches or gen_by_variant["decode"] != want_launches:
        raise SystemExit(f"{tag} generate: {gen_launches} flash launches "
                         f"({gen_by_variant}), expected {want_launches} "
                         "through the decode kernel")
    if ids.shape != (SERVE_BATCH, NEW_TOKENS) or ids.min() < 0 \
            or ids.max() >= cfg.vocab:
        raise SystemExit(f"{tag} generate: ids {ids.shape} in [{ids.min()}, {ids.max()}]")
    step_ms = [e0.elapsed_time(e1) for e0, e1 in engine.events]
    ev = engine.events
    prompt_ms = ev[0][0].elapsed_time(ev[PROMPT_LEN - 1][1])
    decode_ms = ev[PROMPT_LEN][0].elapsed_time(ev[-1][1])
    finite = bool(torch.isfinite(engine.prompt_logits).all())
    diff = (engine.prompt_logits.float() - ref_logits.float()).abs()
    max_diff = float(diff[:, :cfg.vocab].max())
    agree = int((engine.prompt_logits.argmax(-1) == ref_logits.argmax(-1)).sum())
    peak = torch.cuda.max_memory_allocated() / 2**30
    state_bytes = {}
    if recurrent:     # the scan state a decode step reads and writes
        state_bytes = {"decode_step_state_bytes": 2 * sum(
            int(engine.snapshot[k].numel()) * engine.snapshot[k].element_size()
            for k in ("conv", "h"))}
        state_bytes["decode_step_bytes_bound_with_state_ms"] = \
            (weight_bytes + state_bytes["decode_step_state_bytes"]) / HBM_BYTES_PER_S * 1e3
    with RouteLog() as engine_routes:
        again = engine.generate(prompts)
    deterministic = bool(np.array_equal(ids, again))
    if cfg.family == "dense":
        held = {"prefill_vs_decode_tol": PREFILL_DECODE_TOL}
        ok = max_diff <= PREFILL_DECODE_TOL
    elif is_moe:
        # the dense check where it holds; else the mean, beside the control,
        # where routes parted or the prompt's prefill dropped pairs
        loads = moe_loads(torch, prompt_routes.idx, cfg, SERVE_BATCH * PROMPT_LEN)
        flips = route_flips(torch, prompt_routes.idx + engine_routes.idx,
                            cfg.n_layers - cfg.first_dense, SERVE_BATCH, PROMPT_LEN)
        mean = float(diff[:, :cfg.vocab].mean())
        control = ssm_control(torch, model, eparams, engine.snapshot, prompts,
                              ref_logits, tuple(engine.snapshot))
        parted = flips["total"] > 0 or sum(loads["dropped_pairs"]) > 0
        by_max = max_diff <= PREFILL_DECODE_TOL
        held = {"prefill_vs_decode_tol": PREFILL_DECODE_TOL,
                "prefill_vs_decode_mean_abs_diff": mean,
                "prefill_vs_decode_mean_tol": MOE_PREFILL_DECODE_MEAN_TOL,
                f"control_{'latent' if cfg.mla else 'kv'}_lost_mean_abs_diff": control,
                "prompt_prefill_routes": loads, "route_flips": flips,
                "held_by": "max" if by_max else "mean_and_control"}
        ok = by_max or (parted and mean <= MOE_PREFILL_DECODE_MEAN_TOL < control)
        if cfg.mla:     # fp32 at full width, cut to the dense layer
            before = dict(fops.launches_by_variant)
            held["fp32_cut"] = ssm_fp32_cut(torch, dev, seed, arch, prompts,
                                            MLA_F32_CUT_LAYERS)
            cut_launches = {v: fops.launches_by_variant[v] - before[v]
                            for v in fops.VARIANTS}
            held["fp32_cut"]["flash_by_variant"] = cut_launches
            ok = ok and held["fp32_cut"]["max_abs_diff"] <= SSM_F32_PREFILL_DECODE_TOL \
                and cut_launches == dict.fromkeys(fops.VARIANTS, 0) | {"mma_sync": 1}
    else:
        ssm = cfg.family == "ssm"
        tol = SSM_PREFILL_DECODE_MEAN_TOL if ssm else HYBRID_PREFILL_DECODE_MEAN_TOL
        # the controls: the scan state lost, and for the hybrid also every
        # cache leaf (its K/V slots carry the prompt past a lost state)
        controls = [ssm_control(torch, model, eparams, engine.snapshot, prompts,
                                ref_logits, lost)
                    for lost in ((("h",),) if ssm else (("h",), tuple(engine.snapshot)))]
        held = {"prefill_vs_decode_tol": None,
                "prefill_vs_decode_mean_abs_diff": float(diff[:, :cfg.vocab].mean()),
                "prefill_vs_decode_mean_tol": tol,
                "control_mean_abs_diff": controls[0],
                "fp32_cut": ssm_fp32_cut(torch, dev, seed, arch, prompts,
                                         SSM_F32_CUT_LAYERS if ssm else HYBRID_F32_CUT_LAYERS)}
        if not ssm:
            held["control_all_leaves_mean_abs_diff"] = controls[1]
        ok = held["prefill_vs_decode_mean_abs_diff"] <= tol < min(controls) \
            and held["fp32_cut"]["max_abs_diff"] <= SSM_F32_PREFILL_DECODE_TOL
    sampled, sampled_decode = {}, 0
    if sample_seeds:
        sampled = sampled_runs(
            torch, lambda s, **kw: TimedEngine(model, eparams, ServeConfig(
                max_new_tokens=NEW_TOKENS, max_seq=MAX_SEQ,
                temperature=SAMPLE_TEMPERATURE, seed=s), **kw),
            prompts, sample_seeds, ids, wall, want_launches, cfg.vocab, tag,
            cpu_check=tag == "serve")
        sampled_decode = sum(sampled["decode_launches"])
        if tag == "serve":
            phase("serve_sampled", arch=arch, **sampled)
            sampled = {}
        else:
            sampled = {"sampled": sampled}
    if is_moe:   # a step reads every weight but the embedding table's rows
        embed_bytes = eparams["embed"]["tok"].numel() * eparams["embed"]["tok"].element_size()
        state_bytes = {"decode_step_bytes_without_embed": weight_bytes - embed_bytes,
                       "decode_step_bytes_bound_without_embed_ms":
                       (weight_bytes - embed_bytes) / HBM_BYTES_PER_S * 1e3,
                       "decode_step_capacity": moe._capacity(SERVE_BATCH, cfg)}
    phase(f"{tag}_generate", arch=arch, batch=SERVE_BATCH, prompt_len=PROMPT_LEN,
          new_tokens=NEW_TOKENS, max_seq=MAX_SEQ, wall_s=wall,
          prompt_phase_ms=prompt_ms,
          decode_step_p50_ms=float(np.median(step_ms[PROMPT_LEN:])),
          decode_step_ms_min_max=[float(min(step_ms[PROMPT_LEN:])),
                                  float(max(step_ms[PROMPT_LEN:]))],
          decode_step_bytes_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
          **state_bytes,
          generated_tokens_per_s=SERVE_BATCH * NEW_TOKENS / (decode_ms / 1e3),
          peak_mem_gb=peak, flash_launches=gen_launches,
          flash_by_variant=gen_by_variant,
          deterministic=deterministic, prompt_logits_finite=finite,
          prompt_logits_shape=list(engine.prompt_logits.shape),
          prefill_vs_decode_max_abs_diff=max_diff, **held,
          first_tokens_agree=agree, first_ids=ids[:, 0].tolist(), **sampled,
          phase_wall_s=time.perf_counter() - phase_t0)
    if not deterministic:
        raise SystemExit(f"{tag} generate: a second run gave other ids")
    if not finite or not np.isfinite(max_diff) or not ok:
        raise SystemExit(f"{tag} generate: logits after the prompt differ from "
                         f"prefill_step's by {max_diff} at the largest ({held})")

    if do_profile:
        batch = {"tokens": long_prompts}
        name = "profile" if tag == "serve" else f"profile_{tag}"
        phase(f"{name}_prefill",
              **profile(torch, lambda: prefill_step(eparams, batch)))
        cache = model.init_cache(SERVE_BATCH, MAX_SEQ)
        tok = torch.from_numpy(prompts[:, :1]).to(dev)
        phase(f"{name}_decode_step", **profile(
            torch, lambda: model.decode_step(eparams, cache, {"tokens": tok},
                                             PROMPT_LEN + NEW_TOKENS // 2)))
    out = {v: prefill_by_variant[v] + gen_by_variant[v] for v in fops.VARIANTS}
    out["sampled_decode"] = sampled_decode
    if cfg.mla:
        out.update({f"fp32_cut_{v}": n
                    for v, n in held["fp32_cut"]["flash_by_variant"].items()})
    return out


def ssm_control(torch, model, eparams, snapshot, prompts, ref_logits,
                lost=("h",)) -> float:
    """The ssm check's control: the engine's last SSM_CONTROL_STEPS prompt
    steps again from its cache before them (``snapshot``, left as it is),
    the cache leaves ``lost`` zeroed before each step; the mean gap of the
    logits after the prompt to ``prefill_step``'s."""
    toks = torch.from_numpy(prompts).to(ref_logits.device)
    cache = {k: v.clone() for k, v in snapshot.items()}
    for pos in range(PROMPT_LEN - SSM_CONTROL_STEPS, PROMPT_LEN):
        for leaf in lost:
            cache[leaf].zero_()
        cache, lg = model.decode_step(eparams, cache,
                                      {"tokens": toks[:, pos:pos + 1]}, pos)
    vocab = model.cfg.vocab
    return float((lg.float() - ref_logits.float())[:, :vocab].abs().mean())


def ssm_fp32_cut(torch, dev, seed: int, arch: str, prompts,
                 layers: int = SSM_F32_CUT_LAYERS) -> dict:
    """``arch`` at full width in fp32 with ``layers`` layers (random weights
    from ``seed``): ``prefill_step`` on the prompts against ``decode_step``
    over them, the largest logit gap after the last token."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    from repro_torch.train.train_loop import make_serve_steps
    cfg = get_config(arch).replace(n_layers=layers, compute_dtype_str="float32")
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    toks = torch.from_numpy(prompts).to(dev)
    ref = make_serve_steps(model)[0](params, {"tokens": toks})
    cache = model.init_cache(toks.shape[0], PROMPT_LEN)
    for pos in range(PROMPT_LEN):
        cache, lg = model.decode_step(params, cache, {"tokens": toks[:, pos:pos + 1]}, pos)
    return {"layers": layers, "tol": SSM_F32_PREFILL_DECODE_TOL,
            "max_abs_diff": float((lg - ref)[:, :cfg.vocab].abs().max()),
            "logits_std": float(ref[:, :cfg.vocab].std())}


def scan_share(torch, model, eparams, tokens, prefill_ms: float) -> dict:
    """The plain selective scan at one layer of the ssm prefill: its time
    (CUDA events, 3 calls) on layer 0's own inputs for ``tokens``, the
    prefill's share of it over all layers, and its bytes bound (dt, B, C
    and x read once, y written once)."""
    from repro_torch.models import layers, mamba
    cfg = model.cfg
    lp = {k: v[0] for k, v in eparams["stack"]["layers"]["mamba"].items()}
    x = layers.embed_apply(eparams["embed"], tokens, cfg.compute_dtype)
    h = layers.rms_norm(x, eparams["stack"]["layers"]["ln"][0])
    xin = (h @ lp["in_proj"].to(cfg.compute_dtype))[..., :cfg.d_inner]
    xc, _ = mamba._causal_conv(xin, lp["conv_w"], lp["conv_b"])
    dt, b_mat, c_mat = mamba._ssm_params(lp, xc, cfg)
    del x, h, xin
    ms = cuda_ms(torch, lambda: mamba.selective_scan(
        dt, b_mat, c_mat, xc, lp["a_log"], chunk=cfg.ssm_chunk,
        mode=cfg.ssm_scan), 3)
    nbytes = sum(t.numel() * t.element_size() for t in (dt, b_mat, c_mat, xc)) \
        + dt.numel() * 4
    return {"scan_ms_per_layer": ms,
            "scan_share_of_prefill": cfg.n_layers * ms / prefill_ms,
            "scan_bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "scan_shape": list(dt.shape) + [cfg.ssm_state]}


def hybrid_prefill_flops(cfg, b: int, s: int) -> dict:
    """FLOP of a hybrid ``prefill_step`` on b x s tokens, from the model's
    products: each Mamba2 layer's in_proj and out_proj (bf16) and its SSD's
    four chunked products (float32: C B^T and its product with x dt, both
    over the causal half of a chunk's q x q scores, as attention's are
    counted; the chunk's state gain and the carried state's read-out); the
    shared
    block's projections, MLP and causal attention once a site; the
    unembedding of the last position."""
    from repro_torch.models.transformer import hybrid_attn_sites
    t, d, di = b * s, cfg.d_model, cfg.d_inner
    n, g, p = cfg.ssm_state, cfg.n_groups, cfg.ssm_headdim
    nh = di // p
    q = s // max(s // cfg.ssm_chunk, 1)
    sites = len(hybrid_attn_sites(cfg))
    mamba = 2 * t * d * (2 * di + 2 * g * n + nh) + 2 * t * di * d
    ssd = 2 * t * nh * (q + 1) / 2 * (n + p) + 2 * 2 * t * nh * n * p
    hd = cfg.n_heads * cfg.d_head
    block = 2 * t * d * (hd + 2 * cfg.n_kv * cfg.d_head) + 2 * t * hd * d \
        + 3 * 2 * t * d * cfg.d_ff
    attention = 4 * b * cfg.n_heads * cfg.d_head * s * (s + 1) / 2
    out = {"mamba_matmuls": cfg.n_layers * mamba, "ssd_fp32": cfg.n_layers * ssd,
           "shared_block_matmuls": sites * block, "attention": sites * attention,
           "unembed": 2 * b * d * cfg.vocab_padded}
    out["total"] = sum(out.values())
    return out


def ssd_share(torch, model, eparams, tokens, prefill_ms: float) -> dict:
    """The plain SSD at one layer of the hybrid prefill: its time (CUDA
    events, 3 calls) on layer 0's own inputs for ``tokens``, the prefill's
    share of it over all layers, and its bytes bound (x, dt, B and C read
    once, y and the state written once)."""
    from repro_torch.models import layers, mamba
    cfg = model.cfg
    lp = {k: v[0] for k, v in eparams["stack"]["layers"]["mamba"].items()}
    di, g, n, hd = cfg.d_inner, cfg.n_groups, cfg.ssm_state, cfg.ssm_headdim
    x = layers.embed_apply(eparams["embed"], tokens, cfg.compute_dtype)
    h = layers.rms_norm(x, eparams["stack"]["layers"]["ln"][0])
    xbc = (h @ lp["in_proj"].to(cfg.compute_dtype))
    dt_in = xbc[..., -(di // hd):].float()
    xbc, _ = mamba._causal_conv(xbc[..., di:2 * di + 2 * g * n], lp["conv_w"], lp["conv_b"])
    b, s = tokens.shape
    xh = xbc[..., :di].reshape(b, s, di // hd, hd).float()
    bm = xbc[..., di:di + g * n].reshape(b, s, g, n).float()
    cm = xbc[..., di + g * n:].reshape(b, s, g, n).float()
    dt = mamba._softplus(dt_in + lp["dt_bias"].float())
    a = -torch.exp(lp["a_log"])
    h0 = torch.zeros((b, di // hd, n, hd), dtype=torch.float32, device=tokens.device)
    del x, h, xbc
    ms = cuda_ms(torch, lambda: mamba.ssd_chunked(xh, dt, a, bm, cm, h0, cfg.ssm_chunk), 3)
    nbytes = 4 * (2 * xh.numel() + dt.numel() + bm.numel() + cm.numel() + h0.numel())
    return {"ssd_ms_per_layer": ms,
            "ssd_share_of_prefill": cfg.n_layers * ms / prefill_ms,
            "ssd_bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ssd_shape": list(xh.shape) + [n]}


class RouteLog:
    """While active, records the expert indices of every MoE routing call
    (``models/moe.py``'s functions look ``_route`` up when they run), and
    with ``gaps`` each token's gap between its k-th and (k+1)-th routing
    probabilities; the records stay where the call ran (no sync)."""

    def __init__(self, gaps: bool = False):
        from repro_torch.models import moe
        self.moe, self.gaps = moe, gaps

    def __enter__(self):
        import torch
        self.idx, self.gap, self.orig = [], [], self.moe._route

        def route(p, x, cfg):
            out = self.orig(p, x, cfg)
            self.idx.append(out[0])
            if self.gaps:
                probs = torch.softmax((x @ p["gate"].to(cfg.compute_dtype)).float(), -1)
                top = torch.sort(probs, -1, descending=True).values
                self.gap.append(top[:, cfg.top_k - 1] - top[:, cfg.top_k])
            return out
        self.moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.orig


def moe_loads(torch, idx, cfg, tokens: int) -> dict:
    """Each recorded layer's routes of a call over ``tokens`` tokens: the
    pairs past the capacity (dropped: a pair's slot is its rank in token
    order, so an expert keeps its first ``capacity``) and the largest
    per-expert load."""
    from repro_torch.models import moe
    cap = moe._capacity(tokens, cfg)
    loads = [torch.bincount(i.reshape(-1), minlength=cfg.n_experts) for i in idx]
    return {"capacity": cap, "routed_pairs": tokens * cfg.top_k,
            "dropped_pairs": [int(torch.clamp(ld - cap, min=0).sum()) for ld in loads],
            "max_expert_load": [int(ld.max()) for ld in loads]}


def route_flips(torch, idx, n_layers: int, b: int, s: int) -> dict:
    """(token, layer) pairs whose expert set differs between a forward over
    b x s tokens (the first ``n_layers`` records, (b * s, k) each) and the
    ``s`` decode steps over the same tokens after it (``n_layers`` records
    of (b, k) a step); also those at each row's last token."""
    fwd = torch.stack(idx[:n_layers]).sort(-1).values
    dec = torch.stack(idx[n_layers:n_layers * (s + 1)])
    dec = dec.reshape(s, n_layers, b, -1).permute(1, 2, 0, 3).reshape(n_layers, b * s, -1)
    diff = (fwd != dec.sort(-1).values).any(-1)
    return {"total": int(diff.sum()), "by_layer": diff.sum(1).tolist(),
            "last_token": int(diff.view(n_layers, b, s)[:, :, -1].sum())}


def moe_prefill_flops(cfg, b: int, s: int) -> dict:
    """FLOP of an moe ``prefill_step`` on b x s tokens, from the model's
    products: each MoE layer's three expert products over every slot of
    the (E, C) buffers (the capacity padding included), the gate and the
    shared experts; each layer's attention projections and causal
    attention (MLA: q, the latent, its expansion to K and V, the output;
    attention at q/k d_qk and v d_v); the leading dense layers' MLP; the
    unembedding of the last position."""
    from repro_torch.models import moe
    t, d, f = b * s, cfg.d_model, cfg.d_ff_expert
    n_moe = cfg.n_layers - cfg.first_dense
    cap = moe._capacity(t, cfg)
    if cfg.mla:
        h, kvl = cfg.n_heads, cfg.kv_lora
        dk, dv = cfg.mla_nope_dim + cfg.mla_rope_dim, cfg.mla_v_dim
        proj = 2 * t * d * (h * dk + kvl + cfg.mla_rope_dim) \
            + 2 * t * kvl * h * (cfg.mla_nope_dim + dv) + 2 * t * h * dv * d
        attn = 2 * b * h * (dk + dv) * s * (s + 1) / 2
    else:
        hd = cfg.n_heads * cfg.d_head
        proj = 2 * t * d * (hd + 2 * cfg.n_kv * cfg.d_head) + 2 * t * hd * d
        attn = 4 * b * hd * s * (s + 1) / 2
    experts = 3 * 2 * cfg.n_experts * cap * d * f
    out = {"expert_products": n_moe * experts,
           "gate": n_moe * 2 * t * d * cfg.n_experts,
           "projections": cfg.n_layers * proj,
           "attention": cfg.n_layers * attn,
           "unembed": 2 * b * d * cfg.vocab_padded}
    if cfg.n_shared:
        out["shared_experts"] = n_moe * 3 * 2 * t * d * f * cfg.n_shared
    if cfg.first_dense:
        out["dense_ffn"] = cfg.first_dense * 3 * 2 * t * d * cfg.d_ff
    out["total"] = sum(out.values())
    out["expert_slots"], out["routed_pairs"] = cfg.n_experts * cap, t * cfg.top_k
    return out


def moe_vs_cpu(torch, dev, seed: int, arch: str = SERVE_MOE_ARCH) -> dict:
    """``arch``'s smoke model (grok-1-314b's: 4 layers, d_model 128, 4
    heads over 1, 4 experts top-2 of width 64; deepseek-v2-236b's: its
    leading dense layer and 3 MoE layers, MLA at q/k 48 and v 32, a shared
    expert) in fp32 on the card, forward on 2 x 64
    tokens twice (bitwise) and SSM_DECODE_STEPS decode steps, against the
    same weights in float64 on one CPU thread (routing in float32, as the
    reference pins it), to MOE_F64_TOL; at its capacity factor (128 slots
    an expert) and at MOE_CAP8_FACTOR (8 slots against a mean load of 64:
    the forward drops pairs, a 2-token decode step never does). Each
    forward MoE layer's routes and kept mask equal the CPU's at every token
    whose k-th and (k+1)-th probabilities lie more than MOE_TIE apart;
    the tokens within it are counted. Attention goes to the mma_sync kernel
    (fp32), once a layer and call (an MLA decode step launches none)."""
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    base = reduce_for_smoke(get_config(arch)).replace(compute_dtype_str="float32")
    toks = torch.from_numpy(np.random.default_rng(seed + 2).integers(
        0, base.vocab, (2, 64)).astype(np.int32))
    out = {"config": base.name, "n_layers": base.n_layers, "d_model": base.d_model,
           "n_experts": base.n_experts, "top_k": base.top_k,
           "d_ff_expert": base.d_ff_expert, "tokens": list(toks.shape),
           "decode_steps": SSM_DECODE_STEPS, "tol": MOE_F64_TOL, "tie": MOE_TIE}
    bad = []
    for factor in (base.capacity_factor, MOE_CAP8_FACTOR):
        cfg = base.replace(capacity_factor=factor)
        f64 = Model(cfg.replace(compute_dtype_str="float64"), device="cpu")
        params = f64.init(torch.Generator().manual_seed(seed))
        card = Model(cfg, device=dev)
        cparams = tree_map(lambda a: a.to(dev), params)
        before = dict(fops.launches_by_variant)
        with RouteLog() as rc:
            h_card, _ = card.forward(cparams, {"tokens": toks.to(dev)})
        bitwise = bool(torch.equal(h_card, card.forward(cparams, {"tokens": toks.to(dev)})[0]))
        cg = card.init_cache(2, 64)
        for t in range(SSM_DECODE_STEPS):
            cg, lg = card.decode_step(cparams, cg, {"tokens": toks[:, t:t + 1].to(dev)}, t)
        launches = {k: v - before[k] for k, v in fops.launches_by_variant.items()}
        want = dict.fromkeys(launches, 0)
        want["mma_sync"] = cfg.n_layers * (2 + (0 if cfg.mla else SSM_DECODE_STEPS))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            with RouteLog(gaps=True) as rr:
                h_ref, _ = f64.forward(params, {"tokens": toks})
            cr = f64.init_cache(2, 64)
            for t in range(SSM_DECODE_STEPS):
                cr, lr = f64.decode_step(params, cr, {"tokens": toks[:, t:t + 1]}, t)
        finally:
            torch.set_num_threads(threads)
        cap = moe._capacity(toks.numel(), cfg)
        near = route_apart = keep_apart = dropped = 0
        for ic, ir, gap in zip(rc.idx, rr.idx, rr.gap):
            held = gap > MOE_TIE
            near += int((~held).sum())
            ic = ic.cpu()
            route_apart += int((ic != ir).any(-1)[held].sum())
            kc, kr = moe.slots(ic, cfg.n_experts, cap)[1], moe.slots(ir, cfg.n_experts, cap)[1]
            keep_apart += int((kc != kr).any(-1)[held].sum())
            dropped += int((~kr).sum())

        def gap(got, want):     # the largest excess over atol + rtol |want|
            got = got.cpu().double()
            return float(((got - want).abs() - MOE_F64_TOL * want.abs()).max())
        run = {"capacity_factor": factor, "capacity": cap, "dropped_pairs": dropped,
               "near_tie_tokens": near, "route_mismatch_tokens": route_apart,
               "keep_mismatch_tokens": keep_apart, "forward_bitwise": bitwise,
               "flash_launches": launches,
               "hidden_max_abs_diff": float((h_card.cpu().double() - h_ref).abs().max()),
               "decode_logits_max_abs_diff": float((lg.cpu().double() - lr).abs().max()),
               "hidden_excess": gap(h_card, h_ref), "decode_excess": gap(lg, lr)}
        out["cap8" if factor == MOE_CAP8_FACTOR else "full"] = run
        if not bitwise or launches != want or route_apart or keep_apart \
                or (dropped > 0) != (factor == MOE_CAP8_FACTOR) \
                or max(run["hidden_excess"], run["decode_excess"]) > MOE_F64_TOL:
            bad.append((factor, run, want))
    out["phase_wall_s"] = time.perf_counter() - t0
    if bad:
        raise SystemExit(f"{'mla' if base.mla else 'moe'}_vs_cpu: {bad}")
    return out


def sampled_runs(torch, make_engine, prompts, seeds, greedy_ids, greedy_wall_s,
                 want_launches, vocab, tag, cpu_check: bool) -> dict:
    """``Engine.generate`` at SAMPLE_TEMPERATURE once per seed of ``seeds``
    (``make_engine(seed, keep_picks=)`` builds an engine on the serve
    path's weights), each run's flash launches equal to the greedy run's
    (``want_launches``, all on the decode kernel): a run with the first
    run's seed gives its ids, another seed other ids. The first run keeps
    the logits of every pick: each pick is drawn again from them
    (``categorical`` of ``fold_in(key(seed), i)`` and the logits over T in
    their dtype) on the card, bitwise the engine's ids, and with
    ``cpu_check`` on the CPU from the same tensor: equal in every row
    whose perturbed top-2 gap (the CPU's gumbels plus logits / T) exceeds
    2 ulps of its top value; the rows within it are counted. Also the
    device ms and host µs of one pick, sampled and greedy (argmax), and
    each run's wall beside the greedy run's."""
    from repro_torch.core import threefry
    from repro_torch.kernels.flash_attention import ops as fops
    runs, walls, decode, first = [], [], [], None
    for sd in seeds:
        fops.launches = 0
        fops.launches_by_variant = dict.fromkeys(fops.launches_by_variant, 0)
        eng = make_engine(sd, keep_picks=first is None)
        w0 = time.perf_counter()
        ids = eng.generate(prompts)
        walls.append(time.perf_counter() - w0)
        decode.append(fops.launches_by_variant["decode"])
        if fops.launches != want_launches or decode[-1] != want_launches:
            raise SystemExit(f"{tag} sampled (seed {sd}): {fops.launches} flash "
                             f"launches ({fops.launches_by_variant}), expected "
                             f"{want_launches}, as the greedy run")
        if ids.shape != greedy_ids.shape or ids.min() < 0 or ids.max() >= vocab:
            raise SystemExit(f"{tag} sampled: ids {ids.shape} in "
                             f"[{ids.min()}, {ids.max()}]")
        first = first or eng
        runs.append(ids)
    repeat = [bool(np.array_equal(r, runs[0])) == (sd == seeds[0])
              for sd, r in zip(seeds[1:], runs[1:])]
    if not all(repeat):
        raise SystemExit(f"{tag} sampled: seeds {seeds} gave ids equal or "
                         f"apart against the first run's as {repeat} (all True wanted)")

    key, picks = threefry.key(seeds[0]), first.picks
    first.picks = None
    dtype = picks[0].dtype

    def draw(lg, i):
        temp = torch.full((), SAMPLE_TEMPERATURE, dtype=dtype, device=lg.device)
        return threefry.categorical(threefry.fold_in(key, i), lg / temp)
    again = torch.stack([draw(lg, i) for i, lg in enumerate(picks[:-1])], 1)
    if not np.array_equal(again.cpu().numpy(), runs[0]):
        raise SystemExit(f"{tag} sampled: the picks drawn again from the "
                         "engine's logits differ from its ids")
    out = {"temperature": SAMPLE_TEMPERATURE, "seeds": list(seeds),
           "batch": SERVE_BATCH, "new_tokens": NEW_TOKENS,
           "logits_dtype": str(dtype).removeprefix("torch."),
           "repeat_as_seeded": repeat, "redrawn_equal": True,
           "ids_equal_greedy": int((runs[0] == greedy_ids).sum()),
           "first_ids": runs[0][:, 0].tolist(), "decode_launches": decode,
           "wall_s": walls, "greedy_wall_s": greedy_wall_s,
           "wall_added_per_pick_ms": (float(np.median(walls)) - greedy_wall_s)
           / (NEW_TOKENS + 1) * 1e3}
    if cpu_check:
        rows = held = bad = equal = 0
        for i, lg in enumerate(picks):
            card = draw(lg, i).cpu()
            lc = lg.cpu()
            cpu = draw(lc, i)
            scaled = lc / torch.full((), SAMPLE_TEMPERATURE, dtype=dtype)
            p = (threefry.gumbel(threefry.fold_in(key, i), lc.shape, "cpu", dtype)
                 + scaled).float()
            top2 = torch.topk(p, 2, dim=-1).values
            ulp = torch.finfo(dtype).eps * torch.exp2(torch.floor(torch.log2(top2[:, 0].abs())))
            ok = (top2[:, 0] - top2[:, 1]) > 2 * ulp
            rows += ok.numel()
            held += int(ok.sum())
            bad += int((card != cpu)[ok].sum())
            equal += int((card == cpu).sum())
        out["card_vs_cpu"] = {"picks": len(picks), "rows": rows,
                              "rows_within_2_ulps": rows - held,
                              "held_rows_apart": bad, "rows_equal": equal}
        if bad:
            raise SystemExit(f"{tag} sampled: card and CPU categorical differ in "
                             f"{bad} of {held} rows beyond 2 ulps of a tie")
    lg = picks[0]
    out["pick_ms"] = {"sampled": cuda_ms(torch, lambda: first._sample(lg, key, 1), 20),
                      "greedy": cuda_ms(torch, lambda: torch.argmax(lg, -1).to(torch.int32), 20)}
    out["pick_host_us"] = host_us(torch, {
        "sampled": lambda: first._sample(lg, key, 1),
        "greedy": lambda: torch.argmax(lg, -1).to(torch.int32)}, calls=20, rounds=3)
    out["pick_added_ms"] = out["pick_ms"]["sampled"] - out["pick_ms"]["greedy"]
    return out


def ssm_vs_cpu(torch, dev, seed: int, arch: str = SERVE_SSM_ARCH) -> dict:
    """``arch``'s smoke model in fp32 on the card, forward on 2 x 64 tokens
    (four chunks) twice (bitwise) and SSM_DECODE_STEPS decode steps,
    against the same weights in float64 on one CPU thread (the scan in
    float32, as the reference pins it), to SSM_F64_TOL. falcon-mamba-7b's
    (4 layers, d_model 128, d_inner 256, state 8, chunk 16) launches no
    flash kernel; zamba2-1.2b's (the same widths, 16 heads of 16, its
    shared block after layers 1 and 3, d_head 32) launches the mma_sync
    kernel (fp32) once a site and call."""
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import hybrid_attn_sites
    from repro_torch.tree import tree_map
    cfg = reduce_for_smoke(get_config(arch)).replace(
        compute_dtype_str="float32")
    f64 = Model(cfg.replace(compute_dtype_str="float64"), device="cpu")
    params = f64.init(torch.Generator().manual_seed(seed))
    card = Model(cfg, device=dev)
    cparams = tree_map(lambda a: a.to(dev), params)
    toks = torch.from_numpy(np.random.default_rng(seed + 2).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    before = dict(fops.launches_by_variant)
    h_card, _ = card.forward(cparams, {"tokens": toks.to(dev)})
    bitwise = bool(torch.equal(h_card, card.forward(cparams, {"tokens": toks.to(dev)})[0]))
    cg = card.init_cache(2, 64)
    for t in range(SSM_DECODE_STEPS):
        cg, lg = card.decode_step(cparams, cg, {"tokens": toks[:, t:t + 1].to(dev)}, t)
    launches = {k: v - before[k] for k, v in fops.launches_by_variant.items()}
    sites = len(hybrid_attn_sites(cfg))
    want = dict.fromkeys(launches, 0)
    want["mma_sync"] = sites * (2 + SSM_DECODE_STEPS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        h_ref, _ = f64.forward(params, {"tokens": toks})
        cr = f64.init_cache(2, 64)
        for t in range(SSM_DECODE_STEPS):
            cr, lr = f64.decode_step(params, cr, {"tokens": toks[:, t:t + 1]}, t)
    finally:
        torch.set_num_threads(threads)

    def gap(got, want):     # the largest excess over atol + rtol |want|
        got, want = got.cpu().double(), want
        return float(((got - want).abs() - SSM_F64_TOL * want.abs()).max())
    out = {"config": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "d_inner": cfg.d_inner, "ssm_state": cfg.ssm_state,
           "ssm_chunk": cfg.ssm_chunk, "attn_sites": sites,
           "tokens": list(toks.shape),
           "decode_steps": SSM_DECODE_STEPS, "tol": SSM_F64_TOL,
           "forward_bitwise": bitwise, "flash_launches": launches,
           "hidden_max_abs_diff": float((h_card.cpu().double() - h_ref).abs().max()),
           "decode_logits_max_abs_diff": float((lg.cpu().double() - lr).abs().max()),
           "h_state_max_abs_diff": float((cg["h"].cpu().double() - cr["h"].double()).abs().max()),
           "hidden_excess": gap(h_card, h_ref), "decode_excess": gap(lg, lr)}
    if not bitwise or launches != want \
            or max(out["hidden_excess"], out["decode_excess"]) > SSM_F64_TOL:
        raise SystemExit(f"{cfg.family}_vs_cpu: {out}, launches wanted {want}")
    return out


# The serve shapes flash_timings times, by key suffix: (head dim, query
# heads, kv heads, whether the mma_sync kernel and the 4096-key decode row
# are timed too) of internlm2-1.8b at d 128, of stablelm-12b at d 160, of
# zamba2-1.2b's shared block at d 64 and of grok-1-314b (d 128, GQA group
# 6: its prefill and 192-key decode on the kernels that take them).
FLASH_TIMING_HEADS = {"": (128, 16, 8, True), "_d160": (160, 32, 8, True),
                      "_d64": (64, 32, 32, True), "_grok": (128, 48, 8, False)}


def flash_timings(torch, dev, seed: int) -> dict:
    """flash_attention at the serve paths' prefill shape (the sm90 kernel
    and the mma_sync kernel, both forced) and at two decode shapes, 192
    keys of a 256-slot cache and 4096 of 4096 (the decode kernel and the
    mma_sync kernel, both forced), its plain version and SDPA (timed as the
    yardstick only), each beside the bound of the same work: at d 128 with
    internlm2-1.8b's heads (keys ``prefill``, ``decode``, ``decode_long``)
    and at d 160 with stablelm-12b's (the same keys with ``_d160``).
    ``*ms`` is the call time, wrapper included; ``*device_ms`` the kernel's
    own device time a launch; ``*bound_ms`` the bound of the work at each
    shape, for whichever kernel runs it. The same at d 64 with zamba2-1.2b's
    heads (keys ``_d64``), and with grok-1-314b's 48 heads over 8 at d 128
    (keys ``_grok``: the sm90 prefill and the 192-key decode, beside their
    plain version and SDPA). MLA's unequal head dims (``mla_timings``):
    deepseek-v2-236b's prefill at (192, 128) (``prefill_mla``), and the
    mma_sync kernel in fp32 at the dense-layer check's (``mla_f32``) and
    mla_vs_cpu's (48, 32) (``mla_smoke_f32``) shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(seed)
    b = SERVE_BATCH

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dev, torch.bfloat16)

    def kernel(variant, q, k, v, **kw):
        return lambda: fops.flash_attention_cuda(q, k, v, causal=True,
                                                 variant=variant, **kw)

    out = {}
    for sfx, (d, h, kv, every) in FLASH_TIMING_HEADS.items():
        # prefill: S = 2048, causal
        q, k, v = rand(b, PREFILL_LEN, h, d), rand(b, PREFILL_LEN, kv, d), rand(b, PREFILL_LEN, kv, d)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        s = PREFILL_LEN
        flops = 4 * b * h * d * s * (s + 1) / 2
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)
        out["prefill" + sfx] = {
            "shape": [b, s, h, kv, d, "causal", "bf16"],
            "ms": cuda_ms(torch, kernel("sm90", q, k, v), 20),
            "device_ms": device_ms(torch, kernel("sm90", q, k, v), 10, "flash_fwd_sm90"),
            "plain_ms": cuda_ms(torch, lambda: flash_attention_ref(q, k, v, causal=True), 3),
            "library_ms": cuda_ms(torch, sdpa, 20),
            "library_device_ms": device_ms(torch, sdpa, 10),
            "flops": flops, "bytes": nbytes,
            **_bound(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)}
        if every:
            out["prefill" + sfx].update(
                mma_sync_ms=cuda_ms(torch, kernel("mma_sync", q, k, v), 20),
                mma_sync_device_ms=device_ms(torch, kernel("mma_sync", q, k, v), 10,
                                             "flash_fwd_bf16"))
        del q, k, v, qt, kt, vt
        # decode: Sq = 1 at the last position of the generate run (191 of a
        # 256-slot cache), and at the last of a 4096-slot cache
        rows = (("decode", MAX_SEQ, PROMPT_LEN + NEW_TOKENS - 1),
                ("decode_long", LONG_SEQ, LONG_SEQ - 1))
        for name, slots, pos in rows[:2 if every else 1]:
            q, k, v = rand(b, 1, h, d), rand(b, slots, kv, d), rand(b, slots, kv, d)
            qt = q.transpose(1, 2).contiguous()
            kt, vt = (x[:, :pos + 1].transpose(1, 2).contiguous() for x in (k, v))
            flops = 4 * b * h * d * (pos + 1)
            nbytes = 2 * (2 * q.numel() + 2 * b * (pos + 1) * kv * d)
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
            calls = {"decode": kernel("decode", q, k, v, q_offset=pos)}
            if every:
                calls["mma_sync"] = kernel("mma_sync", q, k, v, q_offset=pos)
            host = host_us(torch, calls)
            out[name + sfx] = {
                "shape": [b, 1, h, kv, d, "q_offset", pos, "Skv", slots],
                "host_us": host["decode"],
                "keys": pos + 1, "slots": slots,
                "n_split": fops.decode_splits(b, kv, pos + 1),
                "ms": cuda_ms(torch, calls["decode"], 200),
                "device_ms": device_ms(torch, calls["decode"], 50, "flash_decode"),
                "plain_ms": cuda_ms(torch, lambda: flash_attention_ref(
                    q, k, v, causal=True, q_offset=pos), 20),
                "library_ms": cuda_ms(torch, sdpa, 200),
                "library_device_ms": device_ms(torch, sdpa, 50),
                "flops": flops, "bytes": nbytes,
                **_bound(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)}
            if every:
                out[name + sfx].update(
                    mma_sync_host_us=host["mma_sync"],
                    mma_sync_ms=cuda_ms(torch, calls["mma_sync"], 200),
                    mma_sync_device_ms=device_ms(torch, calls["mma_sync"], 50,
                                                 "flash_fwd_bf16"))
    out.update(mla_timings(torch, dev, seed))
    return out


def sdpa_backends(torch, q, k, v) -> list:
    """The SDPA backends that take these inputs, each tried alone (the
    flash backend refuses v's head dim differing from q's)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    took = []
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"):
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                F.scaled_dot_product_attention(q, k, v, is_causal=True)
            torch.cuda.synchronize()
            took.append(name)
        except RuntimeError:
            pass
    return took


def mla_timings(torch, dev, seed: int) -> dict:
    """flash_attention at MLA's unequal head dims, v a strided view as MLA
    passes it: deepseek-v2-236b's bf16 prefill (8 x 2048, 128 heads, q/k
    192, v 128, causal) on the sm90 kernel and on mma_sync (forced), and
    the mma_sync kernel in fp32 at the dense-layer check's prefill (8 x
    128, the same heads) and at mla_vs_cpu's (2 x 64, 4 heads, q/k 48, v
    32); each beside its plain version, SDPA (the backend PyTorch picks,
    and those that take the inputs) and the operations or bytes bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    out = {}
    gen = torch.Generator(device=dev).manual_seed(seed)   # drawn on the card
    for key, dtype, (b, s, h, dk, dv), variants in (
            ("prefill_mla", torch.bfloat16, (SERVE_BATCH, PREFILL_LEN, 128, 192, 128),
             ("sm90", "mma_sync")),
            ("mla_f32", torch.float32, (SERVE_BATCH, PROMPT_LEN, 128, 192, 128),
             ("mma_sync",)),
            ("mla_smoke_f32", torch.float32, (2, 64, 4, 48, 32), ("mma_sync",))):
        q, k, kvb = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((b, s, h, dk), (b, s, h, dk), (b, s, h, 2 * dv)))
        v = kvb[..., dv:]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        flops = 2 * b * h * (dk + dv) * s * (s + 1) / 2
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel()
                                     - q.numel() // dk * (dk - dv))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
        row = {"shape": [b, s, h, h, dk, dv, "causal", str(dtype).removeprefix("torch.")],
               "flops": flops, "bytes": nbytes,
               "plain_ms": cuda_ms(torch, lambda: flash_attention_ref(q, k, v, causal=True), 3),
               "library_ms": cuda_ms(torch, sdpa, 10),
               "library_device_ms": device_ms(torch, sdpa, 5),
               "library_backends": sdpa_backends(torch, qt, kt, vt),
               **_bound(flops / peak, nbytes / HBM_BYTES_PER_S)}
        for var in variants:
            call = (lambda var=var: fops.flash_attention_cuda(q, k, v, causal=True,
                                                              variant=var))
            name = "flash_fwd_sm90" if var == "sm90" else \
                "flash_fwd_bf16" if dtype == torch.bfloat16 else "flash_fwd_f32"
            pre = "" if var == variants[0] else f"{var}_"
            row[pre + "ms"] = cuda_ms(torch, call, 10)
            row[pre + "device_ms"] = device_ms(torch, call, 5, name)
        out[key] = row
        del q, k, kvb, v, qt, kt, vt
    return out


def flash_bwd_vs_plain(torch, dev, seed: int) -> dict:
    """Both backward kernels against ``flash_attention_bwd_ref``: the one
    the wrapper picks at every head dim in fp32 and bf16 over BWD_CASES,
    and at bf16 d 128 also the sm90 and the mma_sync kernels forced, over
    BWD_CASES and BWD_SM90_CASES; and at each MLA pair of
    ``MLA_HEAD_DIMS`` in fp32 and bf16 over BWD_CASES (plus BWD_MLA_LONG
    at (192, 128)), v the strided half of a K/V expansion as the model
    passes it and dv of v's shape, the one the wrapper picks (the sm90
    kernel at bf16 (192, 128), the mma_sync one at fp32 and (48, 32)) and
    at bf16 (192, 128) both forced; each gradient to its tolerance
    relative to its largest magnitude, and a second call bitwise equal.
    The forward's output it takes is the forward kernel's. Exits non-zero
    on any failure; returns the largest relative errors by dtype, head dims
    and forced kernel, and the calls each kernel took."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    rng = np.random.default_rng(seed + 29)
    errs, calls = {}, Counter()

    def hold(key, case, dtype, tol, dk, dv, both):
        b, sq, skv, h, kv, causal, off = case
        q, k, kvb, do = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                         .to(dev, dtype) for sh in ((b, sq, h, dk), (b, skv, kv, dk),
                                                    (b, skv, kv, dv if dk == dv else 2 * dv),
                                                    (b, sq, h, dv)))
        v = kvb if dk == dv else kvb[..., dv:]
        o = fops.flash_attention_cuda(q, k, v, causal=causal, q_offset=off)
        want = flash_attention_bwd_ref(q, k, v, o, do, causal=causal, q_offset=off)
        forced = both and fops.resolve_bwd_variant(q, k, v) == "sm90"
        # MLA's calls: bf16 (192, 128) to the sm90 backward, the rest to mma_sync
        mla_pick = "sm90" if (dk, dtype) == (192, torch.bfloat16) else "mma_sync"
        for variant in (None, "sm90", "mma_sync") if forced else (None,):
            ran = fops.resolve_bwd_variant(q, k, v, variant)
            if dk != dv and variant is None and ran != mla_pick:
                raise SystemExit(f"flash bwd ({dk}, {dv}) {case}: sent to {ran}")
            before = fops.launches_by_variant["bwd"], fops.bwd_launches_by_variant[ran]
            got = fops.flash_attention_bwd_cuda(q, k, v, o, do, causal=causal,
                                                q_offset=off, variant=variant)
            if (fops.launches_by_variant["bwd"], fops.bwd_launches_by_variant[ran]) \
                    != (before[0] + 1, before[1] + 1):
                raise SystemExit(f"flash bwd {case} {ran}: no launch counted")
            name_ = key + (f"_{variant}" if variant else "")
            for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
                rel = float((g.float() - w.float()).abs().max()) \
                    / max(float(w.float().abs().max()), 1e-30)
                if not torch.isfinite(g).all() or rel > tol or g.shape != x.shape:
                    raise SystemExit(f"flash bwd {name_} {case} {name}: relative "
                                     f"error {rel} > {tol}, or shape {tuple(g.shape)}")
                errs[name_] = max(errs.get(name_, 0.0), rel)
            again = fops.flash_attention_bwd_cuda(q, k, v, o, do, causal=causal,
                                                  q_offset=off, variant=variant)
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                raise SystemExit(f"flash bwd {name_} {case}: a second call "
                                 "gave other bits")
            calls[ran] += 2

    for dtype, tol in ((torch.float32, BWD_F32_TOL), (torch.bfloat16, BWD_BF16_TOL)):
        dt = str(dtype).removeprefix('torch.')
        for dh in fops.HEAD_DIMS:
            both = dtype == torch.bfloat16 and (dh, dh) in fops.SM90_BWD_HEAD_DIMS
            for case in BWD_CASES + (BWD_SM90_CASES if both else []):
                hold(f"{dt}_d{dh}", case, dtype, tol, dh, dh, both)
        for dk, dv in fops.MLA_HEAD_DIMS:
            both = dtype == torch.bfloat16 and (dk, dv) in fops.SM90_BWD_HEAD_DIMS
            for case in BWD_CASES + ([BWD_MLA_LONG] if dk == 192 else []):
                hold(f"{dt}_mla{dk}", case, dtype, tol, dk, dv, both)
    return {"cases": len(BWD_CASES), "sm90_cases": len(BWD_SM90_CASES),
            "mla_long_case": list(BWD_MLA_LONG),
            "head_dims": list(fops.HEAD_DIMS), "mla_head_dims": list(fops.MLA_HEAD_DIMS),
            "kernel_calls": dict(calls), "max_rel_err": errs, "f32_tol": BWD_F32_TOL,
            "bf16_tol": BWD_BF16_TOL, "repeat_bitwise": True}


def _reset_counts():
    """Every kernel's launch count to 0; returns a reader of them."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.hash64 import ops as hops
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.voronoi_assign import ops as vops
    fops.launches = 0
    fops.launches_by_variant = dict.fromkeys(fops.launches_by_variant, 0)
    fops.bwd_launches_by_variant = dict.fromkeys(fops.bwd_launches_by_variant, 0)
    for mod in (hops, st_ops, vops):
        mod.launches = 0
    return lambda: {**fops.launches_by_variant,
                    **{f"bwd_{k}": n for k, n in fops.bwd_launches_by_variant.items()},
                    "st_scan": st_ops.launches, "hash64": hops.launches,
                    "voronoi_assign": vops.launches}


class _HeldBwdCalls:
    """Within ``with``, keeps the arguments and results of the backward
    kernel's calls numbered in ``keep`` (0 the first), as the model passed
    them (their strides, views and dtypes); ``errors()`` then holds each
    against ``flash_attention_bwd_ref`` on the same tensors. A ``fault``
    (dq, dk, dv) -> (dq, dk, dv) alters every result the model receives:
    the control of a gradient gate."""

    def __init__(self, keep, fault=None):
        self.keep, self.fault, self.calls, self.n = set(keep), fault, [], 0

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops as fops
        self.fops, self.kernel = fops, fops.flash_attention_bwd_cuda

        def held(q, k, v, o, do, *, causal, q_offset=0):
            got = self.kernel(q, k, v, o, do, causal=causal, q_offset=q_offset)
            if self.n in self.keep:
                self.calls.append(((q, k, v, o, do), causal, q_offset, got))
            self.n += 1
            return self.fault(*got) if self.fault else got

        fops.flash_attention_bwd_cuda = held
        return self

    def __exit__(self, *exc):
        self.fops.flash_attention_bwd_cuda = self.kernel

    def errors(self, tol: float) -> list:
        import torch
        from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
        out = []
        for args, causal, off, got in self.calls:
            with torch.no_grad():
                want = flash_attention_bwd_ref(*args, causal=causal, q_offset=off)
            rel = {n: float((g.float() - w.float()).abs().max())
                   / max(float(w.float().abs().max()), 1e-30)
                   for n, g, w in zip(("dq", "dk", "dv"), got, want)}
            out.append({"shape": list(args[0].shape), "kv": args[1].shape[2],
                        "dtype": str(args[0].dtype).removeprefix("torch."),
                        "strides": {n: list(x.stride()) for n, x in
                                    zip(("q", "k", "v", "o", "do"), args)},
                        "causal": causal, "q_offset": off, "max_rel_err": rel,
                        "ok": all(bool(torch.isfinite(g).all()) for g in got)
                        and max(rel.values()) <= tol})
            del want
        self.calls.clear()
        return out


def train_flops(cfg, b: int, s: int) -> dict:
    """Forward FLOP of ``Model.loss`` on b x s tokens, by part, from the
    model's products (moe_prefill_flops's count with the unembedding over
    every token); a training step under remat "full" runs the forward, its
    recompute and a backward of twice its products: 4 x the total."""
    out = moe_prefill_flops(cfg, b, s)
    slots, pairs = out.pop("expert_slots"), out.pop("routed_pairs")
    out.pop("total")
    out["unembed"] = 2 * b * s * cfg.d_model * cfg.vocab_padded
    total = sum(out.values())
    out.update(total=total, step_total=4 * total, expert_slots=slots,
               routed_pairs=pairs)
    return out


def _every_nonzero(torch, g) -> bool:
    return bool(torch.isfinite(g).all()) and bool(
        (g.ne(0).flatten(1).any(1)).all())


def moe_grad_checks(torch, model, params, batch, micro: int) -> dict:
    """``value_and_grad`` on ``batch`` with the routes recorded (RouteLog):
    every MLA or GQA leaf of every layer, the leading dense layers' MLP, the
    gate and the shared experts with a finite gradient that is nonzero in
    every layer; each routed expert's wi, wg and wo gradient nonzero
    exactly where that expert kept a pair of the call (its rows of the
    (E, C) buffers otherwise all zero). Returns the per-leaf smallest
    norms, the routes' dropped pairs and loads, and ``ok``."""
    from repro_torch.models import moe
    from repro_torch.train.train_loop import value_and_grad
    cfg = model.cfg
    with RouteLog() as routes:
        _, grads = value_and_grad(model, params, batch, micro)
    stack, n_moe = grads["stack"], cfg.n_layers - cfg.first_dense
    tokens = batch["tokens"].numel()
    leaves = {f"{group}.attn.{n}": g for group in ("first", "layers") if group in stack
              for n, g in stack[group]["attn"].items()}
    if "first" in stack:
        leaves.update({f"first.mlp.{n}": g for n, g in stack["first"]["mlp"].items()})
    moe_g = stack["layers"]["moe"]
    leaves["layers.moe.gate"] = moe_g["gate"]
    leaves.update({f"layers.moe.shared.{n}": g
                   for n, g in moe_g.get("shared", {}).items()})
    norms = {n: min(g.float().flatten(1).norm(dim=1).tolist()) for n, g in leaves.items()}
    leaves_ok = all(_every_nonzero(torch, g) for g in leaves.values())
    cap = moe._capacity(tokens, cfg)
    kept_by = []
    for idx in routes.idx[:n_moe]:           # the forward's calls, in layer order
        keep = moe.slots(idx, cfg.n_experts, cap)[1]
        kept = torch.zeros(cfg.n_experts, dtype=torch.bool, device=idx.device)
        kept[idx[keep]] = True
        kept_by.append(kept)
    kept_by = torch.stack(kept_by)                                   # (L, E)
    experts = {n: torch.isfinite(moe_g[n]).all() & torch.equal(
        moe_g[n].ne(0).flatten(2).any(-1), kept_by) for n in ("wi", "wg", "wo")}
    experts = {n: bool(v) for n, v in experts.items()}
    loads = moe_loads(torch, routes.idx[:n_moe], cfg, tokens)
    del grads, stack, leaves, moe_g
    torch.cuda.empty_cache()
    return {"grad_norm_min": norms, "leaves_nonzero_finite": leaves_ok,
            "routed_experts_nonzero_exactly_where_kept": experts,
            "experts_with_a_kept_pair": kept_by.sum(1).tolist(), "routes": loads,
            "ok": leaves_ok and all(experts.values())}


def qkv_grad_checks(torch, model, params, batch, micro: int) -> dict:
    """``value_and_grad`` on ``batch``: every layer's wq, wk and wv gradient
    nonzero. Returns each one's smallest norm over the layers, and ``ok``."""
    from repro_torch.train.train_loop import value_and_grad
    _, grads = value_and_grad(model, params, batch, micro)
    attn = grads["stack"]["layers"]["attn"]
    norms = {n: min(attn[n].float().flatten(1).norm(dim=1).tolist())
             for n in ("wq", "wk", "wv")}
    del grads, attn
    torch.cuda.empty_cache()
    return {"qkv_grad_norm_min": norms, "ok": min(norms.values()) > 0}


def train(torch, dev, seed: int, smi: str, do_profile: bool = False,
          arch: str = TRAIN_ARCH, layers: int | None = None,
          batch_size: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
          micro: int = TRAIN_MICRO, per_step: dict = TRAIN_PER_STEP,
          grad_checks=qkv_grad_checks, tag: str = "train") -> dict:
    """The training path at full width: ``arch`` (internlm2-1.8b; or, cut
    to ``layers``, deepseek-v2-236b) in fp32 params, bf16 compute, remat
    "full", the default OptConfig with bf16 moments, ``micro``
    microbatches, on batches of ``batch_size`` x ``seq`` tokens that the
    port's AerialPipeline draws from its store on the card. One warm-up
    step and TRAIN_TIMED timed steps (CUDA events around each train step):
    loss, grad_norm, lr, wall, tokens/s and the share of the FLOP bound (a
    dense model's 6 N T; an moe model's ``train_flops``, beside AdamW's
    bytes); peak memory of init and of step 2; launches by kernel against
    ``per_step``; then, fatal: every loss and norm finite, every leaf
    changed by step 1 (a sample of each leaf's elements), every backward
    call of step 1 held to the plain version on the tensors the model
    passed it (after the step freed its activations), ``grad_checks`` of a
    value_and_grad after the last step (``qkv_grad_checks``, or
    ``moe_grad_checks``), and a second run from the seed giving the same
    losses and params after 2 steps, bitwise (step 2's params kept on the
    host)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import AerialPipeline, PipelineConfig
    from repro_torch.models.model import Model
    from repro_torch.train import optimizer as optlib
    from repro_torch.train.train_loop import make_train_step
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    moe_model = cfg.n_experts > 0
    model = Model(cfg, device=dev)
    counts = _reset_counts()
    t0 = time.perf_counter()
    pipe = AerialPipeline(PipelineConfig(vocab=cfg.vocab, batch=batch_size,
                                         seq=seq), device=dev)
    pipe_s, pipe_launches = time.perf_counter() - t0, counts()
    opt_cfg = optlib.OptConfig()
    train_step = make_train_step(model, opt_cfg, n_micro=micro)

    def fresh():
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        return params, optlib.init_opt_state(opt_cfg, params)

    def sample(x):              # up to 2^20 of a leaf's elements
        return x.reshape(-1)[::max(1, x.numel() >> 20)].clone()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state = fresh()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    leaves = tree_leaves(params)
    n_params = sum(x.numel() for x in leaves)
    state_gb = sum(x.numel() * x.element_size()
                   for x in leaves + tree_leaves(state)) / 1e9
    before = [sample(x) for x in leaves]
    tokens = batch_size * seq
    if moe_model:
        flops = train_flops(cfg, batch_size, seq)
        bound_s = flops["step_total"] / BF16_FLOP_PER_S
        # AdamW reads fp32 params and grads and bf16 moments, writes params
        # and moments: 20 bytes a parameter
        adam_bytes = 20 * n_params
    else:
        bound_s = 6 * n_params * tokens / BF16_FLOP_PER_S
    steps, batch_ms, snapshot, bwd_on_path = [], [], None, []
    counts = _reset_counts()
    for s in range(1 + TRAIN_TIMED):
        if s == 1:                 # a step's own peak: step 2, nothing held
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        batch = pipe.get_batch(s)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        held = _HeldBwdCalls(range(cfg.n_layers * micro)) if s == 0 \
            else contextlib.nullcontext()
        with held:
            e0.record()
            params, state, m = train_step(params, state, batch)
            e1.record()
            e1.synchronize()
        ms = e0.elapsed_time(e1)
        steps.append({"step": s + 1, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
                      "ms": ms, "tokens_per_s": tokens / (ms / 1e3),
                      "flop_bound_share": bound_s / (ms / 1e3)})
        if s == 0:
            changed = [not torch.equal(a, sample(b_)) for a, b_ in zip(before, leaves)]
            del before
            bwd_on_path = held.errors(BWD_BF16_TOL)     # after the step freed its activations
            torch.cuda.empty_cache()
        if s == 1:
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            snapshot = [x.to("cpu", copy=True) for x in leaves]
    launches = counts()
    per_step_got = {k: launches[k] / (1 + TRAIN_TIMED) for k in per_step}
    grads = grad_checks(torch, model, params, pipe.get_batch(0), micro)
    if do_profile:               # one more step, traced (after the checks' window)
        batch = pipe.get_batch(0)
        phase(f"profile_{tag}_step", **profile(
            torch, lambda: train_step(params, state, batch), top=16,
            kernels=[n for names in BWD_KERNEL_NAMES.values() for n in names]))
    del params, state, leaves, m
    torch.cuda.empty_cache()
    # A second run from the same seed: 2 steps, bitwise.
    params, state = fresh()
    again = []
    for s in range(2):
        params, state, m = train_step(params, state, pipe.get_batch(s))
        again.append(float(m["loss"]))
    repeat = again == [st["loss"] for st in steps[:2]] and all(
        torch.equal(a, b_.to(dev)) for a, b_ in zip(tree_leaves(params), snapshot))
    del params, state, snapshot, m
    torch.cuda.empty_cache()
    timed = steps[1:]
    step_ms = float(np.median([st["ms"] for st in timed]))
    out = {"arch": arch, "nvidia_smi": smi, "params": n_params,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "n_kv": cfg.n_kv, "d_head": cfg.d_head,
           "vocab": cfg.vocab, "remat": cfg.remat, "param_dtype": cfg.param_dtype_str,
           "compute_dtype": cfg.compute_dtype_str,
           "moment_dtype": opt_cfg.moment_dtype_str, "batch": batch_size,
           "seq": seq, "n_micro": micro, "tokens_per_step": tokens,
           "pipeline_build_s": pipe_s, "pipeline_launches": pipe_launches,
           "init_s": init_s, "state_gb": state_gb, "init_peak_mem_gb": init_peak_gb,
           "steps": steps, "get_batch_ms": batch_ms, "step_p50_ms": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "flop_bound_s": bound_s, "flop_bound_share": bound_s / (step_ms / 1e3),
           "peak_mem_gb": peak_gb, "launches": launches,
           "launches_per_step": per_step_got, "predicted_per_step": per_step,
           "leaves_changed_by_step_1": f"{sum(changed)} of {len(changed)}",
           **grads, "bwd_on_path": bwd_on_path, "bwd_on_path_tol": BWD_BF16_TOL,
           "repeat_losses": again, "repeat_bitwise": repeat}
    if moe_model:
        out.update(mla=cfg.mla, n_experts=cfg.n_experts, top_k=cfg.top_k,
                   n_shared=cfg.n_shared, d_ff_expert=cfg.d_ff_expert,
                   first_dense=cfg.first_dense, train_flops=flops,
                   adamw_bytes=adam_bytes,
                   adamw_bound_s=adam_bytes / HBM_BYTES_PER_S,
                   flop_and_adamw_bound_share=(bound_s + adam_bytes / HBM_BYTES_PER_S)
                   / (step_ms / 1e3))
    phase(tag, **out)
    finite = all(np.isfinite([st["loss"], st["grad_norm"]]).all() for st in steps)
    held_ok = len(bwd_on_path) == cfg.n_layers * micro and all(c["ok"] for c in bwd_on_path)
    if not finite or not all(changed) or not repeat or not held_ok or not grads["ok"] \
            or per_step_got != {k: float(v) for k, v in per_step.items()}:
        raise SystemExit(f"{tag}: finite={finite}, leaves changed "
                         f"{out['leaves_changed_by_step_1']}, repeat={repeat}, "
                         f"gradient checks {grads}, backward on "
                         f"the path {bwd_on_path}, launches a step "
                         f"{per_step_got} (predicted {per_step})")
    return launches


def train_vs_cpu(torch, dev, seed: int) -> dict:
    """examples/train_lm.py's lm-8m config on the card against the same port
    code on the CPU: two steps in fp32 compute against a float64 run on one
    CPU thread (after a forward thrown away, as the smoke-model card test)
    — the losses within TRAIN_LOSS_F32_TOL relative and each gradient leaf
    within TRAIN_GRAD_TOL of its largest magnitude — then the same in bf16
    compute (losses within TRAIN_LOSS_BF16_TOL; each gradient leaf within
    TRAIN_GRAD_BF16_TOL in norm of the port's bf16 CPU gradient at the
    card's params, and step 1 with dk's kv heads swapped in every backward
    outside it); every backward call of both held to the plain version on
    the tensors the model passed it; the pipeline's batches
    card against CPU, bitwise; then the example's restart on the card: 6
    steps straight against 3, a checkpoint, a restore into fresh objects
    and 3 more, params and optimizer state bitwise."""
    import tempfile
    from repro_torch.data.pipeline import AerialPipeline, PipelineConfig
    from repro_torch.examples import train_lm
    from repro_torch.models.model import Model
    from repro_torch.train import optimizer as optlib
    from repro_torch.train.train_loop import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    cfg = train_lm.LM_8M
    counts = _reset_counts()
    pipe = AerialPipeline(PipelineConfig(vocab=cfg.vocab, batch=8, seq=64), device=dev)
    cpu_pipe = AerialPipeline(PipelineConfig(vocab=cfg.vocab, batch=8, seq=64),
                              device="cpu")
    batches = [pipe.get_batch(s) for s in range(2)]
    cpu_batches = [cpu_pipe.get_batch(s) for s in range(2)]
    pipe_bitwise = all(torch.equal(a[k].cpu(), b_[k]) for a, b_ in
                       zip(batches, cpu_batches) for k in a)
    opt = optlib.OptConfig(lr=3e-3, warmup_steps=20, total_steps=200)
    ref_model = Model(cfg.replace(compute_dtype_str="float64"), device="cpu")
    init = ref_model.init(torch.Generator().manual_seed(seed))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            ref_model.loss(init, cpu_batches[0])      # thrown away
        p, st, ref = tree_map(torch.clone, init), None, []
        st = optlib.init_opt_state(opt, p)
        for b in cpu_batches:
            loss, g = value_and_grad(ref_model, p, b)
            ref.append((float(loss), g))
            p, st, _ = optlib.adamw_update(opt, g, st, p)
    finally:
        torch.set_num_threads(threads)
    def l2_err(g, want):          # the largest ||g - want|| / ||want|| of a leaf
        return max(float((a.float().cpu() - w.float()).norm())
                   / max(float(w.float().norm()), 1e-30)
                   for a, w in zip(tree_leaves(g), tree_leaves(want)))

    out = {"pipeline_bitwise": pipe_bitwise}
    cpu_bf16 = Model(cfg.replace(compute_dtype_str="bfloat16"), device="cpu")
    for compute in ("float32", "bfloat16"):
        model = Model(cfg.replace(compute_dtype_str=compute), device=dev)
        p = tree_map(lambda a: a.to(dev, copy=True), init)
        st = optlib.init_opt_state(opt, p)
        losses, grad_err, grad_l2, held = [], [], [], []
        tol = BWD_F32_TOL if compute == "float32" else BWD_BF16_TOL
        for b, cb, (ref_loss, ref_g) in zip(batches, cpu_batches, ref):
            with _HeldBwdCalls(range(cfg.n_layers)) as calls:
                loss, g = value_and_grad(model, p, b)
            held += calls.errors(tol)
            losses.append(float(loss))
            grad_err.append(max(
                float((a.float().cpu() - r.float()).abs().max())
                / max(float(r.float().abs().max()), 1e-30)
                for a, r in zip(tree_leaves(g), tree_leaves(ref_g))))
            if compute == "bfloat16":     # the same params, bf16 on the CPU
                _, want = value_and_grad(cpu_bf16, tree_map(torch.Tensor.cpu, p), cb)
                grad_l2.append(l2_err(g, want))
                if len(grad_l2) == 1:     # step 1's, for the control below
                    first = (tree_map(torch.clone, p), want)
            p, st, _ = optlib.adamw_update(opt, g, st, p)
        rel = [abs(a - r) / abs(r) for a, (r, _) in zip(losses, ref)]
        out[compute] = {"losses": losses, "cpu_float64_losses": [r for r, _ in ref],
                        "loss_rel_err": rel, "grad_rel_err": grad_err,
                        "bwd_on_path_max_rel_err": max(
                            (max(c["max_rel_err"].values()) for c in held),
                            default=None),
                        "bwd_on_path_calls": len(held),
                        "bwd_on_path_ok": len(held) == 2 * cfg.n_layers
                        and all(c["ok"] for c in held)}
    # The control: step 1 again with dk's kv heads swapped in every backward.
    with _HeldBwdCalls((), fault=lambda dq, dk, dv: (dq, dk.roll(1, 2), dv)):
        _, g = value_and_grad(model, first[0], batches[0])
    out["bfloat16"].update(grad_l2_err_vs_cpu_bf16=grad_l2,
                           control_dk_heads_swapped=l2_err(g, first[1]),
                           grad_l2_tol=TRAIN_GRAD_BF16_TOL)
    with tempfile.TemporaryDirectory() as tmp:
        log = lambda *_: None
        straight = train_lm.run(6, None, 50, dev, log=log)
        first = train_lm.run(6, tmp, 3, dev, stop=3, log=log)
        second = train_lm.run(6, tmp, 3, dev, log=log)
        restart = second["start"] == 3 and all(
            torch.equal(a, b_) for a, b_ in zip(
                tree_leaves((second["params"], second["opt"])),
                tree_leaves((straight["params"], straight["opt"]))))
        restart_losses = first["losses"] + second["losses"] == straight["losses"]
    out.update(restart_bitwise=restart, restart_losses_equal=restart_losses,
               restart_losses=straight["losses"], launches=counts())
    # lm-8m's d 32 is the mma_sync backward's: every call goes there.
    launched = out["launches"]
    out["bwd_all_mma_sync"] = launched["bwd_sm90"] == 0 \
        and launched["bwd_mma_sync"] == launched["bwd"] > 0
    phase("train_vs_cpu", **out)
    f32, bf16 = out["float32"], out["bfloat16"]
    if not pipe_bitwise or not restart or not restart_losses \
            or not out["bwd_all_mma_sync"] \
            or not f32["bwd_on_path_ok"] or not bf16["bwd_on_path_ok"] \
            or max(f32["loss_rel_err"]) > TRAIN_LOSS_F32_TOL \
            or max(f32["grad_rel_err"]) > TRAIN_GRAD_TOL \
            or max(bf16["loss_rel_err"]) > TRAIN_LOSS_BF16_TOL \
            or max(bf16["grad_l2_err_vs_cpu_bf16"]) > TRAIN_GRAD_BF16_TOL \
            or not bf16["control_dk_heads_swapped"] > TRAIN_GRAD_BF16_TOL:
        raise SystemExit(f"train_vs_cpu: pipeline bitwise {pipe_bitwise}, "
                         f"restart {restart}/{restart_losses}, fp32 losses "
                         f"{f32['loss_rel_err']} grads {f32['grad_rel_err']}, "
                         f"bf16 losses {bf16['loss_rel_err']} grads against "
                         f"the CPU's bf16 {bf16['grad_l2_err_vs_cpu_bf16']} "
                         f"(control {bf16['control_dk_heads_swapped']}), "
                         f"backward on the path {f32['bwd_on_path_ok']}/"
                         f"{bf16['bwd_on_path_ok']}, backward launches "
                         f"{ {k: launched[k] for k in ('bwd', 'bwd_sm90', 'bwd_mma_sync')} }")
    return out["launches"]


def moe_train_vs_cpu(torch, dev, seed: int) -> dict:
    """deepseek-v2-236b's smoke model (its leading dense layer and 3 MoE
    layers with a shared expert, MLA at q/k 48 and v 32) and grok-1-314b's
    (4 MoE layers, GQA 4 heads over 1 at d 32), each in both dispatch modes
    at its capacity factor and at MOE_CAP8_FACTOR (drops), trained on the
    card in fp32 against the same weights and batches in float64 on one CPU
    thread (routing in float32 on both): two steps of value_and_grad and
    AdamW on 2 x 64 tokens, the losses within TRAIN_LOSS_F32_TOL relative
    and each gradient leaf within TRAIN_GRAD_TOL of its largest magnitude;
    each step's routes and kept masks equal the CPU's at every token whose
    k-th and (k+1)-th probabilities lie more than MOE_TIE apart; every
    backward call held to the plain version on its own tensors, all on the
    mma_sync backward. The control, per model: step 1 again with dV zeroed
    in every backward result the model receives (the held calls keep the
    kernel's), which must exceed TRAIN_GRAD_TOL."""
    from repro_torch.configs.base import get_config, reduce_for_smoke
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.train import optimizer as optlib
    from repro_torch.train.train_loop import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map
    t0 = time.perf_counter()
    opt = optlib.OptConfig(lr=3e-3, warmup_steps=20, total_steps=200)
    rng = np.random.default_rng(seed + 5)
    counts = _reset_counts()
    out, bad = {"tol": {"loss": TRAIN_LOSS_F32_TOL, "grad": TRAIN_GRAD_TOL,
                        "bwd": BWD_F32_TOL, "tie": MOE_TIE}}, []

    def grad_err(g, want):        # the largest |g - want| / max |want| of a leaf
        return max(float((a.cpu().double() - w).abs().max())
                   / max(float(w.abs().max()), 1e-30)
                   for a, w in zip(tree_leaves(g), tree_leaves(want)))

    for arch in (SERVE_MLA_ARCH, SERVE_MOE_ARCH):
        base = reduce_for_smoke(get_config(arch)).replace(compute_dtype_str="float32")
        toks = rng.integers(0, base.vocab, (2, 2, 65)).astype(np.int32)
        batches = [{"tokens": torch.from_numpy(t[:, :-1].copy()),
                    "labels": torch.from_numpy(t[:, 1:].copy())} for t in toks]
        init = Model(base.replace(compute_dtype_str="float64"), device="cpu").init(
            torch.Generator().manual_seed(seed))
        n_moe = base.n_layers - base.first_dense
        runs = {}
        for mode in ("einsum", "scatter"):
            for factor in (base.capacity_factor, MOE_CAP8_FACTOR):
                cfg = base.replace(moe_dispatch=mode, capacity_factor=factor)
                f64 = Model(cfg.replace(compute_dtype_str="float64"), device="cpu")
                card = Model(cfg, device=dev)
                p_cpu = tree_map(torch.clone, init)
                p_card = tree_map(lambda a: a.to(dev, copy=True), init)
                s_cpu = optlib.init_opt_state(opt, p_cpu)
                s_card = optlib.init_opt_state(opt, p_card)
                cap = moe._capacity(batches[0]["tokens"].numel(), cfg)
                run = {"capacity": cap, "losses": [], "cpu_float64_losses": [],
                       "loss_rel_err": [], "grad_rel_err": [], "dropped_pairs": 0,
                       "near_tie_tokens": 0, "route_mismatch_tokens": 0,
                       "keep_mismatch_tokens": 0}
                held = []
                for step, b in enumerate(batches):
                    cb = {k: v.to(dev) for k, v in b.items()}
                    with RouteLog() as rc, _HeldBwdCalls(range(cfg.n_layers)) as calls:
                        lc, gc = value_and_grad(card, p_card, cb)
                    held += calls.errors(BWD_F32_TOL)
                    threads = torch.get_num_threads()
                    torch.set_num_threads(1)
                    try:
                        with RouteLog(gaps=True) as rr:
                            lr_, gr = value_and_grad(f64, p_cpu, b)
                    finally:
                        torch.set_num_threads(threads)
                    for ic, ir, gap in zip(rc.idx[:n_moe], rr.idx[:n_moe], rr.gap[:n_moe]):
                        apart = gap > MOE_TIE
                        ic = ic.cpu()
                        kc = moe.slots(ic, cfg.n_experts, cap)[1]
                        kr = moe.slots(ir, cfg.n_experts, cap)[1]
                        run["near_tie_tokens"] += int((~apart).sum())
                        run["route_mismatch_tokens"] += int((ic != ir).any(-1)[apart].sum())
                        run["keep_mismatch_tokens"] += int((kc != kr).any(-1)[apart].sum())
                        run["dropped_pairs"] += int((~kr).sum())
                    run["losses"].append(float(lc))
                    run["cpu_float64_losses"].append(float(lr_))
                    run["loss_rel_err"].append(abs(float(lc) - float(lr_)) / abs(float(lr_)))
                    run["grad_rel_err"].append(grad_err(gc, gr))
                    if step == 0 and mode == "einsum" and factor == base.capacity_factor:
                        with _HeldBwdCalls((), fault=lambda dq, dk, dv: (
                                dq, dk, torch.zeros_like(dv))):
                            _, gf = value_and_grad(card, p_card, cb)
                        out[f"control_{arch}_dv_zeroed"] = grad_err(gf, gr)
                        del gf
                    p_card, s_card, _ = optlib.adamw_update(opt, gc, s_card, p_card)
                    p_cpu, s_cpu, _ = optlib.adamw_update(opt, gr, s_cpu, p_cpu)
                run["bwd_on_path_max_rel_err"] = max(
                    max(c["max_rel_err"].values()) for c in held)
                run["bwd_on_path_ok"] = len(held) == 2 * cfg.n_layers and all(
                    c["ok"] for c in held)
                runs[f"{mode}_{'cap8' if factor == MOE_CAP8_FACTOR else 'full'}"] = run
                if run["route_mismatch_tokens"] or run["keep_mismatch_tokens"] \
                        or not run["bwd_on_path_ok"] \
                        or (run["dropped_pairs"] > 0) != (factor == MOE_CAP8_FACTOR) \
                        or max(run["loss_rel_err"]) > TRAIN_LOSS_F32_TOL \
                        or max(run["grad_rel_err"]) > TRAIN_GRAD_TOL:
                    bad.append((arch, mode, factor, run))
        out[arch] = {"config": base.name, "n_layers": base.n_layers,
                     "first_dense": base.first_dense, "mla": base.mla,
                     "head_dims": [base.mla_nope_dim + base.mla_rope_dim, base.mla_v_dim]
                     if base.mla else [base.d_head, base.d_head],
                     "n_experts": base.n_experts, "top_k": base.top_k,
                     "tokens": [2, 64], "runs": runs}
        if not out[f"control_{arch}_dv_zeroed"] > TRAIN_GRAD_TOL:
            bad.append((arch, "control", out[f"control_{arch}_dv_zeroed"]))
    launched = counts()
    out["launches"] = launched
    # fp32: every forward (and its remat recompute) on mma_sync, and every
    # backward call on the mma_sync backward
    out["bwd_all_mma_sync"] = launched["bwd_sm90"] == launched["sm90"] == 0 \
        and launched["bwd_mma_sync"] == launched["bwd"] > 0 \
        and launched["mma_sync"] == 2 * launched["bwd"]
    out["phase_wall_s"] = time.perf_counter() - t0
    phase("moe_train_vs_cpu", **out)
    if bad or not out["bwd_all_mma_sync"]:
        raise SystemExit(f"moe_train_vs_cpu: {bad}, launches {launched}")
    return launched


# The examples whose card run is profiled: the two that bring a kernel a
# case no other phase runs (st_scan over 20 edges with 256-shard lists;
# the decode kernel at d 32, 4 heads over 2). A profile costs seconds.
EXAMPLES_PROFILED = ("disaster_analytics", "serve_lm")
# The port's kernels by the names the profiler gives them.
EXAMPLE_KERNEL_NAMES = ("st_scan_kernel", "hash64_mod_kernel", "voronoi_assign_kernel",
                        "flash_decode", "flash_fwd_sm90", "flash_fwd_bf16", "flash_fwd_f32")


def examples_fault(o):
    """The examples phase's planted fault: a decode result with its two KV
    groups' heads swapped (lm-serve: 4 heads over 2)."""
    return o.roll(2, 2)


def examples_phase(torch, dev) -> dict:
    """The six ported datastore and serving examples (``python -m
    repro_torch.examples.<name>``), each at the reference's own sizes on the
    card and then on the CPU (``examples._common.card_vs_cpu``): integers,
    bools, ids and the reconcile audit bitwise, means and sums to rtol
    1e-5; serve_lm's logits, the CPU run fed the card's ids, within
    ``serve_lm.LOGIT_TOL`` and its ids where no such difference can part
    them (``serve_lm.compare``); every flash kernel call of a card run
    held to its plain version on its own tensors (``HeldFlashCalls``).
    Every count is set to 0 just before an example's card and CPU runs and
    read just after; every kernel of ``KERNELS[name]`` must have launched.
    The control: serve_lm again with a fault planted in every decode
    result (``examples_fault``), which both the per-call hold and the
    logits must refuse. For ``EXAMPLES_PROFILED``, a profile of a card run:
    device time by kernel name (the port's kernels' among them) and the
    device's idle share."""
    import importlib
    from repro_torch.examples._common import (EXAMPLES, card_vs_cpu, launch_counts,
                                              missing_kernels)
    out, failed = {}, []
    t_phase = time.perf_counter()
    for name in EXAMPLES:
        _reset_counts()
        got = card_vs_cpu(name, dev)
        counts = launch_counts()
        got["launches"] = {k: n for k, n in counts.items() if n}
        got["not_launched"] = missing_kernels(name, counts)
        if got["mismatches"] or got["not_launched"]:
            failed.append(name)
        out[name] = got
    totals = Counter()
    for got in out.values():
        totals.update(got["launches"])
    examples_s = time.perf_counter() - t_phase
    control = card_vs_cpu("serve_lm", dev, fault=examples_fault)
    control = {"mismatches": len(control["mismatches"]),
               "first_mismatches": control["mismatches"][:3],
               "logits_max_diff": control["logits_max_diff"],
               "flash_calls": control["flash_calls"]}
    if not (control["flash_calls"]["bad_calls"]
            and any(m.startswith(".logits") for m in control["first_mismatches"])):
        failed.append("control: a planted decode fault was not refused")
    for name in EXAMPLES_PROFILED:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        out[name]["profile"] = profile(
            torch, lambda: mod.main(device=dev, log=lambda _: None), top=4,
            kernels=EXAMPLE_KERNEL_NAMES)
    result = {"examples": out, "launches": dict(totals), "failed": failed,
              "control_decode_heads_swapped": control, "examples_s": examples_s,
              "phase_s": time.perf_counter() - t_phase}
    phase("examples", **result)
    if failed:
        raise SystemExit(f"examples disagree with the CPU or missed a kernel: {failed}")
    return result


# The analysis phase's D400 capacities: the collective multiset must not
# move between them (the second holds about 1.5 GB more log).
CONTRACT_D400_CAPACITIES = (1 << 18, 1 << 19)


def analysis_phase(torch, dev, cfg, payloads, metas, chunk, batches, specs,
                   seed: int, n_drones: int = 400) -> dict:
    """The static-analysis contracts on the card (``repro_torch.analysis``):
    the lint, clean; the canonical workload's budget (``retrace``) on the
    single store and the (4,) and (2, 2) meshes, cold then warm, each entry
    point's syncs by both counters (the TorchFunctionMode count and
    ``torch.cuda.set_sync_debug_mode``'s warnings) and its launches held to
    the TOML; the kernel builds in two child processes over an empty build
    directory (the first builds and loads st_scan, hash64 and
    voronoi_assign once each, the second builds nothing); the collective
    contract on the card's meshes; at the D400 day's config, the (4,)
    mesh's collective multiset at 2^18 and 2^19 slots (identical, kinds as
    contracted) and a ``chunk``-round ingest in place (every leaf keeps its
    storage; ``max_memory_allocated`` grows by less than one ``tup_f``
    leaf). Exits non-zero when a check fails, after the line."""
    import dataclasses
    import tempfile
    from repro_torch.analysis import collective_contract as cc
    from repro_torch.analysis import retrace
    from repro_torch.analysis.config import load_config
    from repro_torch.analysis.lint import run_lint
    from repro_torch.api.session import AerialDB
    from repro_torch.core.datastore import make_pred
    from repro_torch.data.synthetic import DroneFleet
    from repro_torch.launch.mesh import make_edge_mesh
    acfg = load_config()
    failed = []
    t_phase = time.perf_counter()

    lint = run_lint()
    if not lint["ok"]:
        failed.append(f"lint: {lint['open']} open finding(s)")

    rep = retrace.run_retrace(dev, acfg)
    failed += [v["message"] for v in rep["violations"]]
    counts = {}
    for run in rep["runs"]:
        for ph in ("cold", "warm"):
            for entry, c in run[ph].items():
                counts.setdefault(run["leg"], {}).setdefault(entry, {})[ph] = {
                    "calls": c["calls"], "syncs": c["syncs"],
                    "sync_debug": c["sync_debug"], "h2d": c["h2d"],
                    "ops": c["ops"], "launches": c["launches"],
                    "builds": c["builds"], "loads": c["loads"]}
    with tempfile.TemporaryDirectory() as tmp:
        builds = retrace.build_check(tmp)
    failed += builds["violations"]

    contract = cc.run_collective_contract(dev, acfg)
    failed += contract["violations"]

    # D400: the (4,) mesh's traffic at two capacities, 8 rounds of the fleet
    # (two sweep steps) and the main path's 5 km batch at 1 and 4 channels.
    pred = make_pred(q=64, **batches[2][3], has_spatial=True,
                     has_temporal=True, is_and=True, device=dev)
    mesh = make_edge_mesh(4, n_edges=cfg.n_edges, device=dev)
    d400 = {}
    for cap in CONTRACT_D400_CAPACITIES:
        c_cfg = dataclasses.replace(cfg, tuple_capacity=cap)
        db = AerialDB.open(c_cfg, mesh, seed=seed)
        fleet = DroneFleet(n_drones, records_per_shard=cfg.records_per_shard,
                           n_values=cfg.n_values, seed=seed + 7)
        d400[cap] = cc.contract_workload(db, fleet, pred, specs)
        del db
        torch.cuda.empty_cache()
    a, b = (d400[c] for c in CONTRACT_D400_CAPACITIES)
    d400_v = (cc.check_kinds(a, mesh, cfg.n_edges, 64, acfg, "d400")
              + cc.check_capacity_independence(a, b, "d400",
                                               CONTRACT_D400_CAPACITIES)
              + cc.check_in_place(a, "d400 mesh"))
    failed += d400_v

    # D400: one chunk of the day into a fresh single store, in place.
    db = AerialDB.open(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = cc.leaf_ptrs(db.blocks)
    db.ingest_rounds(payloads[chunk], type(metas)(*(f[chunk] for f in metas)))
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    moved = [n for (_, n, p), (_, _, q) in zip(before, cc.leaf_ptrs(db.blocks))
             if p != q]
    tup_f_bytes = db.blocks[0].tup_f.numel() * 4
    if moved or growth >= tup_f_bytes:
        failed.append(f"d400 ingest: leaves moved {moved}, peak growth "
                      f"{growth} B (one tup_f leaf {tup_f_bytes} B)")
    del db
    torch.cuda.empty_cache()
    out = {
        "lint": {k: lint[k] for k in ("files_scanned", "open", "disabled",
                                      "allowlisted", "ok")},
        "retrace_ok": rep["ok"], "counts": counts,
        "builds": builds, "contract_ok": contract["ok"],
        "contract": {r["leg"]: r["traffic"] for r in contract["runs"]},
        "d400_capacities": list(CONTRACT_D400_CAPACITIES),
        "d400_traffic": {p: cc.jsonable(t) for p, t in a["traffic"].items()},
        "d400_sweeps": a["sweeps"],
        "d400_traffic_identical": not cc.check_capacity_independence(
            a, b, "d400", CONTRACT_D400_CAPACITIES),
        "d400_ingest_rounds": chunk.stop - chunk.start,
        "d400_ingest_in_place": not moved,
        "d400_ingest_peak_growth_bytes": growth,
        "d400_tup_f_bytes": tup_f_bytes,
        "failed": failed, "phase_s": time.perf_counter() - t_phase}
    phase("analysis", **out)
    if failed:
        raise SystemExit(f"analysis: {len(failed)} check(s) failed: "
                         f"{failed[:5]}")
    return out


def small_case_timings(torch, dev, seed: int) -> dict:
    """The kernel cases that only the examples and ``train_vs_cpu`` launch,
    each beside its bound and, where one exists, one PyTorch call that
    computes the same function: st_scan on the disaster example's own scan
    inputs (20 edges, 256-shard lists; the last of its card run's calls
    with the largest batch, captured), the decode kernel at serve_lm's last
    step (8 × 1 query of 4 heads over 2, d 32, 36 of 128 keys, bf16), and
    flash_attention.cu and flash_attention_bwd.cu at lm-8m's shape (8 × 64
    tokens, 4 heads over 2, d 32, causal) in fp32 and bf16. ``ms`` is the
    call (CUDA events),
    ``device_ms`` the kernel's device time a launch (the backward's two
    launches summed), ``plain_ms`` the plain version, ``library_*`` SDPA
    (forward, or ``torch.autograd.grad`` through it)."""
    import torch.nn.functional as F
    from repro_torch.examples import disaster_analytics
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.st_scan.ref import matched_slots, st_scan_ref
    out = {}
    kernel, calls = st_ops.st_scan_cuda, []

    def capture(*a, **kw):
        calls.append((a, kw))
        return kernel(*a, **kw)
    st_ops.st_scan_cuda = capture
    try:
        disaster_analytics.main(device=dev, log=lambda _: None)
    finally:
        st_ops.st_scan_cuda = kernel
    # the last of the calls with the largest batch (a round's 8 queries)
    q_max = max(a[4].shape[0] for a, _ in calls)
    (f, sid, cnt, pred, subl, slen, rows, cap), _ = [
        c for c in calls if c[0][4].shape[0] == q_max][-1]
    k = len(rows)
    selected = (slen != 0).any(dim=0)
    live = float((torch.clamp(cnt, max=cap).double() * selected).sum())
    matched = int(matched_slots(f, sid, cnt, pred, subl, slen,
                                valid_c=cap).sum())
    listed = int(slen.clamp(0, subl.shape[2]).sum())
    q = slen.shape[0]
    nbytes = (live * 5 + matched * k) * 4 + listed * 8 + slen.numel() * 4 \
        + q * 16 * 4 + slen.numel() * 4 * (1 + 3 * k)
    scan = lambda: kernel(f, sid, cnt, pred, subl, slen, rows, cap)
    out["st_scan_disaster"] = {
        "shape": {"E": int(f.shape[0]), "C": int(f.shape[2]), "Q": q,
                  "L": int(subl.shape[2]), "K": k},
        "calls_captured": len(calls), "selected_edges": int(selected.sum()),
        "live_slots": live, "matched_slots": matched, "listed_entries": listed,
        "ms": cuda_ms(torch, scan, 50),
        "device_ms": device_ms(torch, scan, 20, "st_scan_kernel"),
        "plain_ms": cuda_ms(torch, lambda: st_scan_ref(
            f, sid, cnt, pred, subl, slen,
            channels=tuple(r - 3 for r in rows), valid_c=cap), 3),
        "bytes": nbytes, **_bound(0.0, nbytes / HBM_BYTES_PER_S),
        "library_ms": None}

    rng = np.random.default_rng(seed + 41)

    def rand(dt, *shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dev, dt)
    # serve_lm's last decode step: 12 + 24 tokens, the 36th at position 35
    b, h, kv, d, slots, pos = 8, 4, 2, 32, 128, 35
    qd, kd, vd = rand(torch.bfloat16, b, 1, h, d), rand(torch.bfloat16, b, slots, kv, d), \
        rand(torch.bfloat16, b, slots, kv, d)
    qt = qd.transpose(1, 2).contiguous()
    kt, vt = (x[:, :pos + 1].transpose(1, 2).contiguous() for x in (kd, vd))
    dec = lambda: fops.flash_attention_cuda(qd, kd, vd, causal=True, q_offset=pos)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
    flops = 4 * b * h * d * (pos + 1)
    nbytes = 2 * (2 * qd.numel() + 2 * b * (pos + 1) * kv * d)
    if fops.resolve_variant(qd, kd, vd) != "decode":
        raise SystemExit("small cases: serve_lm's step is not the decode kernel's")
    out["decode_serve_lm"] = {
        "shape": [b, 1, h, kv, d, "q_offset", pos, "Skv", slots, "bf16"],
        "ms": cuda_ms(torch, dec, 200),
        "device_ms": device_ms(torch, dec, 50, "flash_decode"),
        "plain_ms": cuda_ms(torch, lambda: flash_attention_ref(
            qd, kd, vd, causal=True, q_offset=pos), 20),
        "library_ms": cuda_ms(torch, sdpa, 200),
        "library_device_ms": device_ms(torch, sdpa, 50),
        "flops": flops, "bytes": nbytes,
        **_bound(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)}

    # lm-8m (examples/train_lm.py): 8 sequences of 64 tokens, causal
    b, s, h, kv, d = 8, 64, 4, 2, 32
    fwd_flops = 4 * b * h * d * s * (s + 1) / 2
    for dt, name, rate in ((torch.float32, "f32", FP32_FLOP_PER_S),
                           (torch.bfloat16, "bf16", BF16_FLOP_PER_S)):
        q, k_, v, do = (rand(dt, *sh) for sh in ((b, s, h, d), (b, s, kv, d),
                                                 (b, s, kv, d), (b, s, h, d)))
        if fops.resolve_variant(q, k_, v) != "mma_sync":
            raise SystemExit(f"small cases: lm-8m's {name} forward is not "
                             "flash_attention.cu's")
        fwd = lambda: fops.flash_attention_cuda(q, k_, v, causal=True)
        o = fwd()
        bwd = lambda: fops.flash_attention_bwd_cuda(q, k_, v, o, do, causal=True)
        if fops.resolve_bwd_variant(q, k_, v) != "mma_sync":
            raise SystemExit(f"small cases: lm-8m's {name} backward is not "
                             "flash_attention_bwd.cu's")
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k_, v))
        dot = do.transpose(1, 2).contiguous()
        ref_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
        sdpa = lambda: F.scaled_dot_product_attention(
            qt.detach(), kt.detach(), vt.detach(), is_causal=True, enable_gqa=True)
        sdpa_bwd = lambda: torch.autograd.grad(ref_o, (qt, kt, vt), dot,
                                               retain_graph=True)
        fwd_bytes = q.element_size() * (2 * q.numel() + k_.numel() + v.numel())
        bwd_bytes = q.element_size() * 4 * (q.numel() + k_.numel())
        out[f"flash_lm8m_{name}"] = {
            "shape": [b, s, h, kv, d, "causal", name],
            "ms": cuda_ms(torch, fwd, 200),
            "device_ms": device_ms(torch, fwd, 50, f"flash_fwd_{name}"),
            "plain_ms": cuda_ms(torch, lambda: flash_attention_ref(
                q, k_, v, causal=True), 20),
            "library_ms": cuda_ms(torch, sdpa, 200),
            "library_device_ms": device_ms(torch, sdpa, 50),
            "flops": fwd_flops, "bytes": fwd_bytes,
            **_bound(fwd_flops / rate, fwd_bytes / HBM_BYTES_PER_S)}
        out[f"flash_bwd_lm8m_{name}"] = {
            "shape": [b, s, h, kv, d, "causal", name],
            "ms": cuda_ms(torch, bwd, 100),
            "dq_device_ms": device_ms(torch, bwd, 20, f"flash_bwd_dq_{name}"),
            "dkdv_device_ms": device_ms(torch, bwd, 20, f"flash_bwd_dkdv_{name}"),
            "plain_ms": cuda_ms(torch, lambda: flash_attention_bwd_ref(
                q, k_, v, o, do, causal=True), 10),
            "library_ms": cuda_ms(torch, sdpa_bwd, 100),
            "library_device_ms": device_ms(torch, sdpa_bwd, 20),
            "flops": 2.5 * fwd_flops, "bytes": bwd_bytes,
            **_bound(2.5 * fwd_flops / rate, bwd_bytes / HBM_BYTES_PER_S)}
        r = out[f"flash_bwd_lm8m_{name}"]
        r["device_ms"] = r["dq_device_ms"] + r["dkdv_device_ms"]
    phase("small_case_timings", **out)
    return out


# Each backward kernel's two launches, by the names the profiler gives them.
BWD_KERNEL_NAMES = {"sm90": ("flash_bwd_dq_sm90", "flash_bwd_dkdv_sm90"),
                    "mma_sync": ("flash_bwd_dq_bf16", "flash_bwd_dkdv_bf16")}


# The products of size Sq x Skv each backward kernel does, (over d_qk, over
# d_v): sm90 forms S and dP once in each pass beside dQ, dK and dV (7);
# mma_sync forms S a third time in its LSE pass (8).
BWD_PRODUCTS = {"sm90": (4, 3), "mma_sync": (5, 3)}


def flash_bwd_timing(torch, dev, seed: int, shape: tuple, turns: tuple,
                     sdpa_backend=None) -> dict:
    """The backward kernels in ``turns``, forced, at ``shape`` = (b, s, h,
    kv, d_qk, d_v), causal, bf16, on inputs drawn on the card (v, where
    d_v != d_qk, the strided half of a K/V expansion, as MLA passes it),
    taken in the order of ``turns``, whose first is the kernel the wrapper
    picks here. ``o`` is the forward kernel's, held first to the plain
    forward (FLASH_BF16_TOL). For each kernel: its call ms (CUDA events)
    and device ms (torch.profiler: the call's device time, both launches,
    from one profile; and its dq and its dk/dv launch by their kernel
    names, each from a profile of its own: where a profile records no
    device time, device_ms times the whole call, so a part may then read
    as the call), the largest relative error against the
    plain version and a second call bitwise; beside them the plain
    version's ms, SDPA's backward (``torch.autograd.grad`` of
    ``F.scaled_dot_product_attention(..., is_causal=True)``, on the
    backend named ``sdpa_backend`` where given, the yardstick only) and the bound: S, dQ
    and dK over d_qk and dP and dV over d_v, 2 B H S(S+1)/2 (3 d_qk + 2 d_v)
    FLOP (2.5 x the causal forward's at equal dims) at the bf16
    tensor-core rate, against the bytes of q, k, v, o, dO and the three
    gradients."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_attention_ref)
    b, s, h, kv, dk, dv = shape
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    q, k, kvb, do = (torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)
                     for sh in ((b, s, h, dk), (b, s, kv, dk),
                                (b, s, kv, dv if dk == dv else 2 * dv), (b, s, h, dv)))
    v = kvb[..., -dv:]
    fwd_variant = fops._variant(q, k, v)
    o = fops.flash_attention_cuda(q, k, v, causal=True)
    want = flash_attention_ref(q, k, v, causal=True).float()
    fwd_err = (o.float() - want).abs()
    fwd_bad = int((fwd_err > FLASH_BF16_TOL + FLASH_BF16_TOL * want.abs()).sum())
    del want
    if fwd_bad or fops.resolve_bwd_variant(q, k, v) != turns[0]:
        raise SystemExit(f"flash bwd timing {shape}: the forward ({fwd_variant}) has "
                         f"{fwd_bad} elements beyond {FLASH_BF16_TOL}, or the wrapper "
                         f"picks another backward than {turns[0]}")
    call = {var: (lambda var=var: fops.flash_attention_bwd_cuda(
        q, k, v, o, do, causal=True, variant=var)) for var in dict.fromkeys(turns)}
    want = flash_attention_bwd_ref(q, k, v, o, do, causal=True)
    res = {var: {} for var in call}
    for var, fn in call.items():
        got = fn()
        abs_err = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)]
        res[var].update(
            max_abs_err=max(abs_err),
            max_rel_err=max(e / float(w.float().abs().max()) for e, w in zip(abs_err, want)),
            repeat_bitwise=all(torch.equal(a, b_) for a, b_ in zip(got, fn())))
        del got
    del want
    torch.cuda.empty_cache()
    times = {var: {"ms": [], "device_ms": [], "dq_device_ms": [], "dkdv_device_ms": []}
             for var in call}
    for var in turns:
        times[var]["ms"].append(cuda_ms(torch, call[var], 10))
        times[var]["device_ms"].append(device_ms(torch, call[var], 5))
        for part, name in zip(("dq", "dkdv"), BWD_KERNEL_NAMES[var]):
            times[var][f"{part}_device_ms"].append(device_ms(torch, call[var], 5, name))
    half = b * h * s * (s + 1) / 2            # causal (query, key) pairs
    for var, t in times.items():
        n_dk, n_dv = BWD_PRODUCTS[var]
        res[var].update({f"{k_}_turns": vals for k_, vals in t.items()},
                        **{k_: float(np.median(vals)) for k_, vals in t.items()},
                        kernels=list(BWD_KERNEL_NAMES[var]),
                        flops_done=2 * half * (n_dk * dk + n_dv * dv))
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    with sdpa_kernel(getattr(SDPBackend, sdpa_backend)) if sdpa_backend \
            else contextlib.nullcontext():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=h != kv)
    sdpa_bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    flops = 2 * half * (3 * dk + 2 * dv)
    nbytes = 4 * b * s * (h + kv) * (dk + dv)   # bf16 q k dQ dK at d_qk, v o dO dV at d_v
    res.update({"shape": [b, s, h, kv, dk, dv, "causal", "bf16"],
                "forward_variant": fwd_variant, "forward_max_abs_err": float(fwd_err.max()),
                "plain_ms": cuda_ms(torch, lambda: flash_attention_bwd_ref(
                    q, k, v, o, do, causal=True), 1),
                "library": " ".join(("sdpa backward", sdpa_backend or "")).strip(),
                "library_ms": cuda_ms(torch, sdpa_bwd, 10),
                "library_device_ms": device_ms(torch, sdpa_bwd, 5),
                "forward_flops": 2 * half * (dk + dv), "flops": flops, "bytes": nbytes,
                **_bound(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)})
    bad = {var: (r["max_rel_err"], r["repeat_bitwise"]) for var, r in res.items()
           if var in call and (r["max_rel_err"] > BWD_BF16_TOL or not r["repeat_bitwise"])}
    if bad:
        raise SystemExit(f"flash bwd at {shape}: (relative error, repeat) {bad}")
    return res


def _bound(ops_s: float, bytes_s: float) -> dict:
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s > bytes_s else "bytes"}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=288,
                    help="collection rounds to ingest (288 = one day)")
    ap.add_argument("--chunk", type=int, default=24,
                    help="rounds per ingest_rounds call")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--profile", action="store_true",
                    help="after each main path, print the device-time "
                         "breakdown (torch.profiler) of one ingest chunk "
                         "(into the main and the cached store), one "
                         "4-channel query batch, one prefill and one "
                         "decode step of each served model, and one "
                         "train step")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.api.session import AerialDB
    from repro_torch.core import hashing, voronoi
    from repro_torch.core.datastore import AggSpec, StoreConfig, make_pred
    from repro_torch.data.synthetic import (CityConfig, DroneFleet,
                                            make_query_workload, make_sites)
    from repro_torch.kernels import build
    from repro_torch.kernels.hash64 import ops as hash64_ops
    from repro_torch.kernels.hash64.ref import xxh64_mod_py
    from repro_torch.kernels.st_scan import ops as st_ops
    from repro_torch.kernels.voronoi_assign import ops as vor_ops
    from repro_torch.kernels.voronoi_assign.ref import (top2_relative_gap,
                                                        voronoi_assign_ref)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. environment --------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    build_s = build.build_all()
    phase("environment", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
          build_s=build_s,
          ptxas={k: build.ptxas_report(k) for k in build.KERNELS})

    # -- 2. hash64 and voronoi against their plain versions ----------------
    rng = np.random.default_rng(args.seed)
    n_keys = 1 << 20
    hi = torch.from_numpy(rng.integers(-2**31, 2**31, n_keys).astype(np.int32)).to(dev)
    lo = torch.from_numpy(rng.integers(-2**31, 2**31, n_keys).astype(np.int32)).to(dev)
    hash_bad = hash_keys = 0
    for n in (1, 8, 80, 65521, 65535):
        # views at their own 4-byte offsets go to the kernel without a copy
        for h, l in ((hi, lo), (None, lo), (hi[3:], lo[1:-2]), (None, lo[1:])):
            got = hash64_ops.xxh64_mod_cuda(h, l, n)
            want = hashing.xxh64_mod_plain(h, l, n)
            hash_bad += int((got != want).sum())
            hash_keys += l.numel()
    few = 1000
    got = hash64_ops.xxh64_mod_cuda(hi[:few], lo[:few], 80).cpu().numpy()
    oracle_bad = int((got != xxh64_mod_py(hi[:few].cpu().numpy(),
                                          lo[:few].cpu().numpy(), 80)).sum())
    if hash_bad or oracle_bad:
        raise SystemExit(f"hash64 disagrees: {hash_bad} vs plain, "
                         f"{oracle_bad} vs oracle")

    city = CityConfig()
    sites_np = make_sites(80, city, seed=3)
    sites = torch.from_numpy(sites_np).to(dev)
    cell = 0.01     # the slice grid: every cell centre of the city
    ci = np.arange(int(city.lat_min / cell), int(city.lat_max / cell) + 1)
    cj = np.arange(int(city.lon_min / cell), int(city.lon_max / cell) + 1)
    glat = ((ci[:, None] + 0.5) * cell + 0 * cj[None, :]).astype(np.float32)
    glon = ((cj[None, :] + 0.5) * cell + 0 * ci[:, None]).astype(np.float32)
    la, lo_c = torch.from_numpy(glat).to(dev), torch.from_numpy(glon).to(dev)
    got = vor_ops.voronoi_assign_cuda(la, lo_c, sites).reshape(-1)
    pts = torch.stack([la.reshape(-1), lo_c.reshape(-1)], -1)
    plain = voronoi.voronoi_assign(pts, sites)
    pts_np = pts.cpu().numpy()
    clear = top2_relative_gap(pts_np, sites_np) > 1e-6
    vor_bad = int((got != plain)[torch.from_numpy(clear).to(dev)].sum())
    vor_oracle_bad = int((got.cpu().numpy() != voronoi_assign_ref(
        pts_np, sites_np))[clear].sum())
    if vor_bad or vor_oracle_bad:
        raise SystemExit(f"voronoi_assign disagrees: {vor_bad} vs plain, "
                         f"{vor_oracle_bad} vs float64 oracle")
    phase("kernels_vs_plain", hash64_keys=hash_keys, hash64_mismatch=0,
          hash64_oracle_keys=few, voronoi_points=int(pts.shape[0]),
          voronoi_clear=int(clear.sum()),
          voronoi_mismatch_all=int((got != plain).sum()))

    # -- 3. the main path at full width ----------------------------------
    cfg = StoreConfig(n_edges=80, sites=tuple(map(tuple, sites_np.tolist())),
                      tuple_capacity=1 << 18, index_capacity=1 << 15,
                      max_shards_per_query=128, records_per_shard=60,
                      n_values=4, replication=3, planner="min_shards")
    fleet = DroneFleet(400, city, records_per_shard=60, n_values=4,
                       seed=args.seed)
    t0 = time.perf_counter()
    payloads, metas = fleet.next_rounds(args.rounds)
    gen_s = time.perf_counter() - t0

    for mod in (hash64_ops, vor_ops, st_ops):
        mod.launches = 0
    db = AerialDB.open(cfg, device="cuda")
    chunks = [slice(a, min(a + args.chunk, args.rounds))
              for a in range(0, args.rounds, args.chunk)]

    def ingest(sl):
        db.ingest_rounds(payloads[sl], type(metas)(*(f[sl] for f in metas)))

    ingest(chunks[0])                  # warm-up chunk, not timed
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    w0 = time.perf_counter()
    ev0.record()
    for sl in chunks[1:]:
        ingest(sl)
    ev1.record()
    ev1.synchronize()
    wall = time.perf_counter() - w0
    timed_rounds = args.rounds - (chunks[0].stop - chunks[0].start)
    ingest_s = ev0.elapsed_time(ev1) / 1e3
    shards = timed_rounds * fleet.n_drones
    tuples = shards * cfg.records_per_shard

    t_end = float(payloads[..., 0].max())
    qrng = np.random.default_rng(args.seed + 1)
    batches = []
    for km, win in QUERY_SIZES:
        w = make_query_workload(qrng, 64, city, t_end, km, win)
        recent = win <= RECENT_S
        if recent:     # anchor the window inside the last 30 minutes
            w["t0"] = qrng.uniform(t_end - RECENT_S, t_end - win, 64).astype(np.float32)
            w["t1"] = (w["t0"] + np.float32(win)).astype(np.float32)
        batches.append((km, win, recent, w))
    specs = (AggSpec(channel=0), AggSpec(channels=(0, 1, 2, 3)))
    results, times = {}, []
    for rep in range(3):
        for bi, (km, win, recent, w) in enumerate(batches):
            pred = make_pred(q=64, **w, has_spatial=True, has_temporal=True,
                             is_and=True, device=dev)
            for si, spec in enumerate(specs):
                torch.cuda.synchronize()
                q0 = time.perf_counter()
                res, info = db.query(pred, agg=spec)
                torch.cuda.synchronize()
                if rep > 0:            # repetition 0 is the warm-up
                    times.append((time.perf_counter() - q0) * 1e3)
                results[(bi, si)] = (res, info)
    launches = {"hash64": hash64_ops.launches,
                "voronoi_assign": vor_ops.launches,
                "st_scan": st_ops.launches}
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel never launched on the main path: {launches}")

    # Correctness: shapes, finiteness, and exact answers on retained windows.
    flat = payloads.reshape(-1, payloads.shape[-1]).astype(np.float64)
    flat = flat[flat[:, 0] >= t_end - RECENT_S - 600]
    checked, overflowed = exact_checks(results, batches, specs, flat)
    st = db.state
    phase("main_path", rounds=args.rounds, timed_rounds=timed_rounds,
          gen_s=gen_s, ingest_device_s=ingest_s, ingest_wall_s=wall,
          shards_per_s=shards / ingest_s, tuples_per_s=tuples / ingest_s,
          query_batch_p50_ms=float(np.median(times)),
          query_batch_ms=[float(t) for t in times],
          queries_checked_exact=checked, queries_overflowed=overflowed,
          matched_queries=int(sum(int((r.count > 0).sum()) for r, _ in results.values())),
          index_dropped=int(st.index.dropped.sum()),
          index_retired=int(st.index.retired.sum()),
          tup_overwritten=int(st.tup_overwritten.sum()),
          peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
          launches=launches)
    phase("planners", seed=args.seed, **planners_phase(
        torch, dev, cfg, db, batches, specs, flat, args.seed, args.profile,
        results, times))
    fields, ldb = latest_phase(torch, dev, cfg, db, fleet, payloads, metas,
                               chunks, batches, specs, args.seed, args.profile)
    phase("latest", main_path_shards_per_s=shards / ingest_s,
          cost=latest_cost(torch, dev, cfg, payloads, metas, chunks, fleet.n_drones),
          **fields)

    if args.profile:
        extra = fleet.next_rounds(args.chunk)
        pred = make_pred(q=64, **batches[2][3], has_spatial=True,
                         has_temporal=True, is_and=True, device=dev)
        phase("profile_ingest", **profile(torch, lambda: db.ingest_rounds(*extra),
                                          host_top=12))
        phase("profile_query", **profile(torch, lambda: db.query(pred, agg=specs[1])))
        # the same chunk into the cached store: the launches it adds are
        # the cache's cost
        phase("profile_ingest_latest", **profile(torch, lambda: ldb.ingest_rounds(*extra),
                                                 host_top=12))
    del ldb
    phase("resilience", **resilience_phase(torch, dev, cfg, city, args.seed, smi))
    torch.cuda.empty_cache()
    phase("streaming", **streaming_phase(torch, dev, cfg, city, args.seed, smi))
    torch.cuda.empty_cache()
    phase("chaos", **chaos_phase(torch, dev, cfg, city, args.seed, smi))
    torch.cuda.empty_cache()
    phase("federation", **federation_phase(
        torch, dev, cfg, city, payloads, metas, chunks, batches, specs,
        args.seed, smi, args.profile))
    torch.cuda.empty_cache()
    fleet = fleet_phase(torch, dev, cfg, payloads, metas, chunks, batches,
                        specs, args.seed, smi, args.profile)
    phase("fleet", **fleet)
    torch.cuda.empty_cache()
    analysis_phase(torch, dev, cfg, payloads, metas, chunks[0], batches, specs,
                   args.seed)
    torch.cuda.empty_cache()

    # -- 4. st_scan vs plain on the main path's inputs; kernel timings -------
    scan = st_scan_phase(torch, dev, cfg, st, db.alive, batches, specs)
    rows = scan["rows"]

    def bound(bytes_, ops=0.0):
        b_ms, o_ms = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
        return (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations")

    # hash64 at the insert's temporal-slice shape (B x max_t_slices H_t keys).
    buckets = hashing.time_bucket(torch.from_numpy(metas.t0[-1]).to(dev),
                                  cfg.tau)[:, None] + torch.arange(
        16, dtype=torch.int32, device=dev)
    h_plain = cuda_ms(torch, lambda: hashing.xxh64_mod_plain(None, buckets, 80), 50)
    # hash64 at each main-path shape of an insert round: the slice buckets
    # above, the shard midpoints' buckets (H_t) and the shard ids (H_i), each
    # beside an empty kernel on its grid (hash64_empty_launch) and its bytes
    # read once and written once: 8 B a key in the H_t form, 12 in the H_i.
    mid_t = 0.5 * (torch.from_numpy(metas.t0[-1]) + torch.from_numpy(metas.t1[-1])).to(dev)
    sid_hi = torch.from_numpy(metas.sid_hi[-1]).to(dev)
    sid_lo = torch.from_numpy(metas.sid_lo[-1]).to(dev)
    hash_shapes = {}
    for shape, hi_k, lo_k, key_bytes in (
            ("ht_slices", None, buckets, 8),
            ("ht_midpoints", None, hashing.time_bucket(mid_t, cfg.tau), 8),
            ("hi_shard_ids", sid_hi, sid_lo, 12)):
        call = (lambda h=hi_k, lo_=lo_k: hash64_ops.xxh64_mod_cuda(h, lo_, 80))
        keys = int(lo_k.numel())
        b_ms, b_by = bound(keys * key_bytes)
        hash_shapes[shape] = {
            "keys": keys, "high_word": hi_k is not None,
            "ms": cuda_ms(torch, call, 200),
            "device_ms": device_ms(torch, call, 50, "hash64_mod_kernel"),
            "launch_floor_device_ms": device_ms(
                torch, lambda k=keys: hash64_ops.launch_floor(k, dev), 50,
                "hash64_empty_kernel"),
            "bound_ms": b_ms, "bound_by": b_by,
            "err": int((call() != hashing.xxh64_mod_plain(hi_k, lo_k, 80)).sum())}
    h_err = sum(v.pop("err") for v in hash_shapes.values())
    h_ms, h_dev = (hash_shapes["ht_slices"][k] for k in ("ms", "device_ms"))

    # voronoi at the insert's spatial-slice shape (B x 16 x 16 cell centres).
    i0 = torch.floor(torch.from_numpy(metas.lat0[-1]).to(dev) / cell)
    j0 = torch.floor(torch.from_numpy(metas.lon0[-1]).to(dev) / cell)
    ks = torch.arange(16, device=dev, dtype=torch.float32)
    vlat = ((i0[:, None] + ks + 0.5) * cell)[:, :, None].expand(-1, 16, 16).contiguous()
    vlon = ((j0[:, None] + ks + 0.5) * cell)[:, None, :].expand(-1, 16, 16).contiguous()
    v_ms = cuda_ms(torch, lambda: vor_ops.voronoi_assign_cuda(vlat, vlon, sites), 200)
    vpts = torch.stack([vlat.reshape(-1), vlon.reshape(-1)], -1)
    v_plain = cuda_ms(torch, lambda: voronoi.voronoi_assign(vpts, sites), 50)
    c, sc, _ = voronoi.centred_sites(sites)
    vpc = vpts - c
    v_lib = cuda_ms(torch, lambda: torch.cdist(vpc, sc).argmin(1), 50)
    v_dev = device_ms(torch, lambda: vor_ops.voronoi_assign_cuda(vlat, vlon, sites),
                      50, "voronoi_assign_kernel")
    # every device activity of a call: the kernel alone, once the sites are
    # packed
    v_wrap_dev = device_ms(torch, lambda: vor_ops.voronoi_assign_cuda(
        vlat, vlon, sites), 50)
    v_lib_dev = device_ms(torch, lambda: torch.cdist(vpc, sc).argmin(1), 50)
    centred_ms = cuda_ms(torch, lambda: voronoi.centred_sites(sites), 200)
    v_err = int((vor_ops.voronoi_assign_cuda(vlat, vlon, sites).reshape(-1)
                 != voronoi.voronoi_assign(vpts, sites)).sum())
    n_pts, n_e = vpts.shape[0], sites.shape[0]
    v_ops = n_pts * (6 * n_e + 2)
    # voronoi at the insert's placement shape (the B shard midpoints).
    mlat = 0.5 * (torch.from_numpy(metas.lat0[-1]) + torch.from_numpy(metas.lat1[-1])).to(dev)
    mlon = 0.5 * (torch.from_numpy(metas.lon0[-1]) + torch.from_numpy(metas.lon1[-1])).to(dev)
    mpts = torch.stack([mlat, mlon], -1)
    mpc = mpts - c
    place = {
        "points": int(mpts.shape[0]),
        "ms": cuda_ms(torch, lambda: vor_ops.voronoi_assign_cuda(mlat, mlon, sites), 200),
        "device_ms": device_ms(torch, lambda: vor_ops.voronoi_assign_cuda(mlat, mlon, sites),
                               50, "voronoi_assign_kernel"),
        "plain_ms": cuda_ms(torch, lambda: voronoi.voronoi_assign(mpts, sites), 50),
        "library_ms": cuda_ms(torch, lambda: torch.cdist(mpc, sc).argmin(1), 50),
        "library_device_ms": device_ms(torch, lambda: torch.cdist(mpc, sc).argmin(1), 50),
        "err": int((vor_ops.voronoi_assign_cuda(mlat, mlon, sites)
                    != voronoi.voronoi_assign(mpts, sites)).sum())}
    place["bound_ms"], place["bound_by"] = bound(
        mpts.shape[0] * 12, mpts.shape[0] * (6 * n_e + 2))
    # The kernel's work per (point, site) of the plain version's E sites a
    # point: VISIT_INSTRUCTIONS a visit (static, from SASS) times the visits
    # a point's warp issues, beside the operations the bound counts.
    visits = voronoi_visits(torch, vor_ops, vlat, vlon, sites)
    p_visits = voronoi_visits(torch, vor_ops, mlat, mlon, sites)
    vor_work = {"instructions_per_visit_static_sass": VISIT_INSTRUCTIONS,
                "ahead": visits["ahead"],
                "sites_listed_per_point": visits["listed"],
                "visits_issued_per_point": visits["issued"],
                "instructions_per_point_site": VISIT_INSTRUCTIONS * visits["issued"] / n_e,
                "placement_sites_listed_per_point": p_visits["listed"],
                "placement_visits_issued_per_point": p_visits["issued"],
                "bound_operations_per_point_site": (6 * n_e + 2) / n_e}

    def recount(points, listed):
        """The bound recounted for the sites the data needs: 12 bytes a point
        and the 8 E bytes of the sites, against 2 + 6 operations a listed
        site (unfused, so at half the FMA-counted rate)."""
        b_ms = (points * 12 + n_e * 8) / HBM_BYTES_PER_S * 1e3
        o_ms = points * (2 + 6 * listed) / (FP32_FLOP_PER_S / 2) * 1e3
        return (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations")

    kernels = []
    for name, route, src, replaces, ms, dev_ms, plain_ms, (b_ms, b_by), lib_ms, \
            lib_dev, err in (
            ("st_scan", "cuda", "src/repro_torch/csrc/st_scan.cu",
             "src/repro/kernels/st_scan/st_scan.py:109", scan["ms"],
             scan["device_ms"], scan["plain_ms"], bound(scan["bytes"]), None,
             None, scan["err"]),
            ("hash64", "cuda", "src/repro_torch/csrc/hash64.cu",
             "src/repro/kernels/hash64/hash64.py:28", h_ms, h_dev, h_plain,
             bound(buckets.numel() * 8), None, None, float(h_err)),
            ("voronoi_assign", "cuda", "src/repro_torch/csrc/voronoi_assign.cu",
             "src/repro/kernels/voronoi_assign/voronoi_assign.py:32", v_ms,
             v_dev, v_plain, bound(n_pts * 12, v_ops), v_lib, v_lib_dev,
             float(v_err))):
        kernels.append({"name": name, "route": route, "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms, "device_ms": dev_ms,
                        "library_device_ms": lib_dev})
    for k in kernels:               # the fleet phase's launches beside the main path's
        k["fleet_launches"] = fleet["launches"][k["name"]]
    kernels[-1]["wrapper_device_ms"] = v_wrap_dev
    kernels[-1].update({f"placement_{k}": v for k, v in place.items() if k != "err"})
    # The ranking's bound_ms counts all E sites a point; beside it, recounted
    # for the listed sites this run's points need.
    kernels[-1]["bound_ms_recount"], kernels[-1]["bound_by_recount"] = recount(
        n_pts, visits["listed"])
    kernels[-1]["placement_bound_ms_recount"], kernels[-1]["placement_bound_by_recount"] = \
        recount(int(mpts.shape[0]), p_visits["listed"])
    kernels[0]["bound_ms_old"] = scan["old_bytes"] / HBM_BYTES_PER_S * 1e3
    phase("kernel_timings", st_scan_k1_ms=scan["k1_ms"],
          voronoi_centred_sites_ms=centred_ms,
          st_scan_shape={"E": 80, "C": cfg.padded_capacity, "Q": 64,
                         "L": cfg.max_shards_per_query, "K": len(rows),
                         "selected_edges": scan["batches"][2]["selected_edges"]},
          st_scan_checks=scan["checks"], st_scan_batches=scan["batches"],
          st_scan_bound_ms={"nine_words_every_live_slot": kernels[0]["bound_ms_old"],
                            "hot_words_plus_matched_channels": kernels[0]["bound_ms"]},
          hash64_keys=int(buckets.numel()), hash64_shapes=hash_shapes,
          launch_floor_device_ms=hash_shapes["ht_slices"]["launch_floor_device_ms"],
          voronoi_points=int(n_pts),
          voronoi_placement=place, voronoi_work=vor_work)
    if h_err or v_err or place["err"]:
        raise SystemExit(f"kernel disagrees at timing shapes: hash64 {h_err}, "
                         f"voronoi {v_err}, voronoi placement {place['err']}")
    del db, st, scan    # free the store before serving
    torch.cuda.empty_cache()

    # -- 5-7. flash_attention and the LM serving path ----------------------
    flash_err = flash_vs_plain(torch, dev, args.seed)
    phase("flash_bwd_vs_plain", **flash_bwd_vs_plain(torch, dev, args.seed))
    served = serve(torch, dev, args.seed, args.profile, sample_seeds=SAMPLE_SEEDS,
                   layers=SERVE_LAYERS)
    torch.cuda.empty_cache()        # internlm2's engine is gone
    served_d160 = serve(torch, dev, args.seed, args.profile, arch=SERVE_D160_ARCH,
                        param_dtype="bfloat16", tag="serve_stablelm",
                        layers=SERVE_D160_LAYERS)
    torch.cuda.empty_cache()
    served_ssm = serve(torch, dev, args.seed, args.profile, arch=SERVE_SSM_ARCH,
                       param_dtype="bfloat16", tag="serve_falcon", sample_seeds=(0,),
                       layers=SERVE_SSM_LAYERS)
    torch.cuda.empty_cache()
    served_d64 = serve(torch, dev, args.seed, args.profile, arch=SERVE_HYBRID_ARCH,
                       param_dtype="bfloat16", tag="serve_zamba", sample_seeds=(0,),
                       layers=SERVE_HYBRID_LAYERS)
    torch.cuda.empty_cache()
    served_grok = serve(torch, dev, args.seed, args.profile, arch=SERVE_MOE_ARCH,
                        param_dtype="bfloat16", tag="serve_grok",
                        layers=GROK_SERVE_LAYERS)
    torch.cuda.empty_cache()
    served_dsv2 = serve(torch, dev, args.seed, args.profile, arch=SERVE_MLA_ARCH,
                        param_dtype="bfloat16", tag="serve_dsv2",
                        layers=DSV2_SERVE_LAYERS)
    torch.cuda.empty_cache()
    phase("ssm_vs_cpu", **ssm_vs_cpu(torch, dev, args.seed))
    phase("hybrid_vs_cpu", **ssm_vs_cpu(torch, dev, args.seed, SERVE_HYBRID_ARCH))
    phase("moe_vs_cpu", **moe_vs_cpu(torch, dev, args.seed))
    mla_small = moe_vs_cpu(torch, dev, args.seed, SERVE_MLA_ARCH)
    phase("mla_vs_cpu", **mla_small)
    trained = train(torch, dev, args.seed, smi, args.profile)
    torch.cuda.empty_cache()
    trained_dsv2 = train(torch, dev, args.seed, smi, args.profile, arch=SERVE_MLA_ARCH,
                         layers=TRAIN_DSV2_LAYERS, batch_size=TRAIN_DSV2_BATCH,
                         seq=TRAIN_DSV2_SEQ, micro=1, per_step=TRAIN_DSV2_PER_STEP,
                         grad_checks=moe_grad_checks, tag="train_dsv2")
    torch.cuda.empty_cache()
    trained_small = train_vs_cpu(torch, dev, args.seed)
    torch.cuda.empty_cache()
    trained_moe_small = moe_train_vs_cpu(torch, dev, args.seed)
    torch.cuda.empty_cache()
    examples = examples_phase(torch, dev)["launches"]
    small = small_case_timings(torch, dev, args.seed)
    ft = flash_timings(torch, dev, args.seed)
    ft["bwd"] = flash_bwd_timing(torch, dev, args.seed, BWD_TIMING,
                                 ("sm90", "mma_sync", "mma_sync", "sm90"))
    ft["bwd_mla"] = flash_bwd_timing(torch, dev, args.seed, BWD_MLA_TIMING,
                                     ("sm90", "mma_sync", "mma_sync", "sm90"),
                                     "EFFICIENT_ATTENTION")
    flash = "src/repro/kernels/flash_attention/flash_attention.py:66"
    for sfx, launched in (("", served), ("_d160", served_d160), ("_d64", served_d64)):
        pre, dec, long = ft["prefill" + sfx], ft["decode" + sfx], ft["decode_long" + sfx]
        # The mma_sync kernel is on no main path (fp32, bf16 d 32, and bf16
        # with 1 < Sq < 64): its entry gives its forced decode-shape times,
        # with the bound of each shape it was timed at.
        kernels.append({
            "name": "flash_attention" + sfx, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu", "replaces": flash,
            "launches": launched["mma_sync"],
            "max_abs_err": flash_err["bfloat16_mma_sync" + (sfx or "_d128")],
            "ms": dec["mma_sync_ms"], "device_ms": dec["mma_sync_device_ms"],
            "host_us": dec["mma_sync_host_us"],
            "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
            "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
            "library_device_ms": dec["library_device_ms"],
            "long_device_ms": long["mma_sync_device_ms"],
            "long_bound_ms": long["bound_ms"],
            "prefill_ms": pre["mma_sync_ms"],
            "prefill_device_ms": pre["mma_sync_device_ms"],
            "prefill_bound_ms": pre["bound_ms"],
            "prefill_bound_by": pre["bound_by"],
            "prefill_library_device_ms": pre["library_device_ms"]})
        kernels.append({
            "name": "flash_attention_sm90" + sfx, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_sm90.cu", "replaces": flash,
            "launches": launched["sm90"],
            "max_abs_err": flash_err["bfloat16_sm90" + (sfx or "_d128")],
            "ms": pre["ms"], "device_ms": pre["device_ms"], "plain_ms": pre["plain_ms"],
            "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
            "library_ms": pre["library_ms"],
            "library_device_ms": pre["library_device_ms"]})
        kernels.append({
            "name": "flash_attention_decode" + sfx, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_decode.cu", "replaces": flash,
            "launches": launched["decode"],
            "max_abs_err": flash_err["bfloat16_decode" + (sfx or "_d128")],
            "ms": dec["ms"], "device_ms": dec["device_ms"], "host_us": dec["host_us"],
            "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
            "library_ms": dec["library_ms"],
            "library_device_ms": dec["library_device_ms"],
            "long_ms": long["ms"], "long_device_ms": long["device_ms"],
            "long_plain_ms": long["plain_ms"], "long_bound_ms": long["bound_ms"],
            "long_library_device_ms": long["library_device_ms"]})
    # grok-1-314b's shapes (48 heads over 8, d 128): the sm90 prefill and
    # the decode kernel at its serve path's own launches
    pre, dec = ft["prefill_grok"], ft["decode_grok"]
    for name, var, src, row in (
            ("flash_attention_sm90_grok", "sm90", "flash_attention_sm90.cu", pre),
            ("flash_attention_decode_grok", "decode", "flash_attention_decode.cu", dec)):
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/" + src,
            "replaces": flash, "launches": served_grok[var],
            "max_abs_err": flash_err[f"bfloat16_{var}_d128_g6"],
            "ms": row["ms"], "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_device_ms": row["library_device_ms"]})
    # deepseek-v2-236b's MLA shapes: the sm90 kernel at its (192, 128)
    # prefill; the mma_sync kernel in fp32 at (192, 128) (the serve's
    # dense-layer check) and at (48, 32) (mla_vs_cpu), each with its own
    # path's launches
    small_launches = sum(mla_small[k]["flash_launches"]["mma_sync"] for k in ("full", "cap8"))
    for name, src, row, launched, err in (
            ("flash_attention_sm90_mla", "flash_attention_sm90.cu", ft["prefill_mla"],
             served_dsv2["sm90"], flash_err["bfloat16_sm90_mla192"]),
            ("flash_attention_mla", "flash_attention.cu", ft["mla_f32"],
             served_dsv2["fp32_cut_mma_sync"], flash_err["float32_mma_sync_mla192"]),
            ("flash_attention_mla_smoke", "flash_attention.cu", ft["mla_smoke_f32"],
             small_launches, flash_err["float32_mma_sync_mla48"])):
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/" + src,
            "replaces": flash, "launches": launched, "max_abs_err": err,
            "ms": row["ms"], "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_device_ms": row["library_device_ms"],
            "library_backends": row["library_backends"], "shape": row["shape"]})
    kernels[-3].update(mma_sync_ms=ft["prefill_mla"]["mma_sync_ms"],
                       mma_sync_device_ms=ft["prefill_mla"]["mma_sync_device_ms"],
                       mma_sync_max_abs_err=flash_err["bfloat16_mma_sync_mla192"])
    bwd = ft["bwd"]
    for name, var, src in (("flash_attention_bwd_sm90", "sm90", "flash_attention_bwd_sm90.cu"),
                           ("flash_attention_bwd", "mma_sync", "flash_attention_bwd.cu")):
        # The sm90 kernel takes the train path's calls (bf16, d 128); the
        # mma_sync one the rest, lm-8m's d 32 in train_vs_cpu among them.
        # Both timed forced at one microbatch of the train phase.
        r = bwd[var]
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/" + src,
            "replaces": "src/repro/models/attention.py:52",
            "replaces_note": "no Pallas kernel: the JAX package takes this gradient "
                             "by autodiff of its jnp flash_attention",
            "launches": trained["bwd_" + var],
            "kernel_launches_per_call": 2, "max_abs_err": r["max_abs_err"],
            "max_rel_err": r["max_rel_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "dq_device_ms": r["dq_device_ms"],
            "dkdv_device_ms": r["dkdv_device_ms"], "plain_ms": bwd["plain_ms"],
            "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
            "library_ms": bwd["library_ms"],
            "library_device_ms": bwd["library_device_ms"]})
    # The sm90 backward at deepseek-v2-236b's train call, (192, 128):
    # train_dsv2's calls (its launches); beside it the mma_sync backward
    # forced at that call (the kernel that took it before the sm90 one was
    # templated on (d_qk, d_v)), which keeps moe_train_vs_cpu's calls at
    # (48, 32) and d 32.
    r, rs, rv = ft["bwd_mla"], ft["bwd_mla"]["sm90"], ft["bwd_mla"]["mma_sync"]
    kernels.append({
        "name": "flash_attention_bwd_mla", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
        "replaces": "src/repro/models/attention.py:52",
        "replaces_note": "no Pallas kernel: the JAX package takes this gradient "
                         "by autodiff of its jnp flash_attention (d_v != d_qk)",
        "launches": trained_dsv2["bwd_sm90"], "kernel_launches_per_call": 2,
        "max_abs_err": rs["max_abs_err"], "max_rel_err": rs["max_rel_err"],
        "ms": rs["ms"], "device_ms": rs["device_ms"], "dq_device_ms": rs["dq_device_ms"],
        "dkdv_device_ms": rs["dkdv_device_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "library_device_ms": r["library_device_ms"],
        "library": r["library"], "shape": r["shape"],
        "mma_sync_source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "mma_sync_launches": trained_dsv2["bwd_mma_sync"],
        "mma_sync_moe_train_vs_cpu_launches": trained_moe_small["bwd_mma_sync"],
        "mma_sync_max_abs_err": rv["max_abs_err"], "mma_sync_ms": rv["ms"],
        "mma_sync_device_ms": rv["device_ms"],
        "mma_sync_dq_device_ms": rv["dq_device_ms"],
        "mma_sync_dkdv_device_ms": rv["dkdv_device_ms"]})
    by_name = {k["name"]: k for k in kernels}
    by_name["flash_attention_sm90_mla"]["train_dsv2_launches"] = trained_dsv2["sm90"]
    for k in kernels:               # the training paths' launches
        name = {"flash_attention": "mma_sync", "flash_attention_sm90": "sm90",
                "flash_attention_decode": "decode",
                "flash_attention_bwd": "bwd_mma_sync",
                "flash_attention_bwd_sm90": "bwd_sm90"}.get(k["name"], k["name"])
        if name in ("mma_sync", "sm90", "decode"):
            k["ssm_serve_launches"] = served_ssm[name]     # falcon-mamba-7b: none
        if k["name"] == "flash_attention_decode":
            k["sampled_launches"] = served["sampled_decode"]
        if not k["name"].endswith(("_d160", "_d64", "_grok", "_mla", "_mla_smoke")):
            k["train_launches"] = trained[name]
            k["train_vs_cpu_launches"] = trained_small[name]
            k["examples_launches"] = examples.get(
                name if name in ("st_scan", "hash64", "voronoi_assign")
                else "flash_" + name, 0)
    # The cases only the examples and train_vs_cpu launch, beside the
    # kernel's main-path figures.
    by_name = {k["name"]: k for k in kernels}
    for name, cases in (("st_scan", ("st_scan_disaster",)),
                        ("flash_attention_decode", ("decode_serve_lm",)),
                        ("flash_attention", ("flash_lm8m_f32", "flash_lm8m_bf16")),
                        ("flash_attention_bwd", ("flash_bwd_lm8m_f32",
                                                 "flash_bwd_lm8m_bf16"))):
        for case in cases:
            by_name[name][case] = small[case]
    phase("flash_timings", **ft)
    phase("device_ms_profiles", calls=len(DEVICE_MS_PROFILES),
          profiles=sum(DEVICE_MS_PROFILES),
          retried=[i for i, k in enumerate(DEVICE_MS_PROFILES) if k > 1],
          timed_by_events=DEVICE_MS_EVENTS,
          records_short={i: list(r) for i, r in enumerate(DEVICE_MS_RECORDED)
                         if r[0] < r[1]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
