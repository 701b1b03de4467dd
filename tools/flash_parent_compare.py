#!/usr/bin/env python3
"""Hold this tree's flash kernels to another checkout's, at the d 128 serve
and train shapes and the d 160 prefill, on one card.

    python tools/flash_parent_compare.py --parent DIR [--rounds 5] [--iters 20]

DIR is a checkout of another commit (for example a ``git archive`` of the
parent, unpacked). Its ``csrc/flash_attention_sm90.cu`` and
``csrc/flash_attention_decode.cu`` are built with the same nvcc flags into
``build/parent_kernels/`` and called through this tree's wrapper (the
wrapper's library is swapped), on the same inputs as this tree's kernels:
the sm90 kernel at internlm2-1.8b's prefill (8 x 2048, 16 heads over 8,
causal) and at stablelm-12b's (32 heads over 8, d 160), and the decode
kernel at 192 of 256 and 4096 of 4096 keys. Prints
one JSON line: whether each pair of outputs is bitwise equal, and each
kernel's call time (CUDA events around ``--iters`` back-to-back calls; a
decode call's is the host's) and device time (``chip_smoke.device_ms``,
torch.profiler), taken in turns (parent, this, this, parent) for
``--rounds`` rounds, with the card's name and power limit.

The backward too: the other checkout's ``csrc/flash_attention_bwd.cu``
(the mma_sync backward; forced through this tree's wrapper with its
library swapped) against this tree's sm90 backward, on the same inputs, at
one microbatch of the train phase (4 x 4096, 16 heads over 8, d 128,
causal; ``bwd_train``) and at train_dsv2's call (1 x 4096, 128 heads over
128, q/k 192 and v 128, v the strided half of a K/V expansion;
``bwd_mla``). Their gradients are held to the plain version within
``chip_smoke.BWD_BF16_TOL`` of each one's largest magnitude, not bitwise
(the two kernels round P and dS in different places); device time is a
call's, both launches, from one profile.

And the backwards' equal-dim instances against the other checkout's,
bitwise: the mma_sync one at d 32, 64, 128 and 160, fp32 and bf16, forced,
over ``chip_smoke.BWD_CASES`` (``bwd_equal_dims``), and the sm90 one at d
128 over ``chip_smoke.BWD_SM90_CASES`` and the train microbatch, where the
two are also timed in turns (``bwd_sm90_equal_dims``). The other
checkout's backwards must have this tree's C entries (the mma_sync one's
takes v's head dim beside q/k's). Exits 1 unless every forward pair and
every equal-dim backward pair is bitwise equal and every backward is
within tolerance.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

KERNELS = ("flash_attention_sm90", "flash_attention_decode")
BWD = ("flash_attention_bwd", "flash_attention_bwd_sm90")


def build_parent(parent: Path) -> dict:
    """The parent's libraries, built into build/parent_kernels/."""
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in KERNELS + BWD:
        src = parent / "src" / "repro_torch" / "csrc" / f"{name}.cu"
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(out_dir / f"lib{name}.so"), str(src)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the parent's {name}.cu:\n{err}")
    return {name: ctypes.CDLL(str(out_dir / f"lib{name}.so")) for name in KERNELS + BWD}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch
    from chip_smoke import (BWD_BF16_TOL, BWD_CASES, BWD_MLA_TIMING, BWD_SM90_CASES,
                            BWD_TIMING, device_ms)
    if not torch.cuda.is_available():
        print("flash_parent_compare: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    libs = {"this": {n: build.load(n) for n in KERNELS + BWD},
            "parent": build_parent(args.parent)}
    def use(side: str) -> None:
        for name in KERNELS + BWD:
            build._LIBS[name] = libs[side][name]
        fops._decode_fn.cache_clear()
        fops._bwd_fn.cache_clear()
        fops._bwd_sm90_fn.cache_clear()

    rng = np.random.default_rng(args.seed)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dev, torch.bfloat16)

    b, h, kv, d = 8, 16, 8, 128
    cases = {"sm90_prefill": ("sm90", (rand(b, 2048, h, d), rand(b, 2048, kv, d),
                                       rand(b, 2048, kv, d)), 0),
             "decode_192": ("decode", (rand(b, 1, h, d), rand(b, 256, kv, d),
                                       rand(b, 256, kv, d)), 191),
             "decode_4096": ("decode", (rand(b, 1, h, d), rand(b, 4096, kv, d),
                                        rand(b, 4096, kv, d)), 4095),
             "sm90_prefill_d160": ("sm90", (rand(b, 2048, 32, 160), rand(b, 2048, kv, 160),
                                            rand(b, 2048, kv, 160)), 0)}

    def call(variant, qkv, pos):
        return fops.flash_attention_cuda(*qkv, causal=True, q_offset=pos,
                                         variant=variant)

    def timed(fn, iters) -> float:
        fn()
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / iters

    out = {"card": smi, "iters": args.iters, "rounds": args.rounds}
    for key, (variant, qkv, pos) in cases.items():
        got = {}
        for side in ("parent", "this"):
            use(side)
            got[side] = call(variant, qkv, pos)
        ms = {"parent": [], "this": []}
        dev_ms = {"parent": [], "this": []}
        kernel = "flash_fwd_sm90" if variant == "sm90" else "flash_decode"
        for _ in range(args.rounds):
            for side in ("parent", "this", "this", "parent"):
                use(side)
                ms[side].append(timed(lambda: call(variant, qkv, pos), args.iters))
                dev_ms[side].append(device_ms(
                    torch, lambda: call(variant, qkv, pos), args.iters, kernel))
        out[key] = {"bitwise_equal": bool(torch.equal(got["parent"], got["this"])),
                    **{f"{side}_{what}": vals[side]
                       for what, vals in (("ms", ms), ("device_ms", dev_ms))
                       for side in ("parent", "this")},
                    **{f"{side}_median_{what}": float(np.median(vals[side]))
                       for what, vals in (("ms", ms), ("device_ms", dev_ms))
                       for side in ("parent", "this")}}
    def bwd_inputs(b, sq, skv, h, kv, dk, dv, dtype=torch.bfloat16):
        """q, k, v, dO from the seeded generator; v, where d_v != d_qk, the
        strided half of a K/V expansion, as MLA passes it."""
        q, k, kvb, do = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                         .to(dev, dtype) for sh in ((b, sq, h, dk), (b, skv, kv, dk),
                                                    (b, skv, kv, dv if dk == dv else 2 * dv),
                                                    (b, sq, h, dv)))
        return q, k, kvb[..., -dv:], do

    def backward(shape) -> dict:
        """The parent's mma_sync backward (forced) against this tree's sm90
        backward at ``shape`` = (b, s, h, kv, d_qk, d_v), causal, in turns,
        each held to the plain version within ``BWD_BF16_TOL``."""
        from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
        b, s, h, kv, dk, dv = shape
        q, k, v, do = bwd_inputs(b, s, s, h, kv, dk, dv)
        use("this")
        o = fops.flash_attention_cuda(q, k, v, causal=True)
        variant = {"parent": "mma_sync", "this": "sm90"}
        calls = {side: (lambda side=side: fops.flash_attention_bwd_cuda(
            q, k, v, o, do, causal=True, variant=variant[side])) for side in variant}
        want = flash_attention_bwd_ref(q, k, v, o, do, causal=True)
        rel = {}
        for side, fn in calls.items():
            use(side)
            got = fn()
            rel[side] = max(float((g.float() - w.float()).abs().max())
                            / float(w.float().abs().max()) for g, w in zip(got, want))
            del got
        del want
        ms = {side: [] for side in calls}
        dev_ms = {side: [] for side in calls}
        for _ in range(args.rounds):
            for side in ("parent", "this", "this", "parent"):
                use(side)
                ms[side].append(timed(calls[side], 5))
                dev_ms[side].append(device_ms(torch, calls[side], 3))
        med = {side: float(np.median(dev_ms[side])) for side in calls}
        return {"shape": [b, s, h, kv, dk, dv, "causal", "bf16"], "variants": variant,
                "max_rel_err": rel, "tol": BWD_BF16_TOL,
                "within_tol": all(r <= BWD_BF16_TOL for r in rel.values()),
                **{f"{side}_ms": ms[side] for side in calls},
                **{f"{side}_device_ms": dev_ms[side] for side in calls},
                **{f"{side}_median_ms": float(np.median(ms[side])) for side in calls},
                **{f"{side}_median_device_ms": med[side] for side in calls},
                "this_faster": med["this"] < med["parent"],
                "this_over_parent": med["this"] / med["parent"]}

    def equal_dims() -> dict:
        """The mma_sync backward at every equal head dim, fp32 and bf16,
        over chip_smoke.BWD_CASES: this tree's gradients against the
        parent's on the same inputs, bitwise."""
        differ = []
        n = 0
        for dtype in (torch.float32, torch.bfloat16):
            for d in fops.HEAD_DIMS:
                for bb, sq, skv, hh, kvh, causal, off in BWD_CASES:
                    x = bwd_inputs(bb, sq, skv, hh, kvh, d, d, dtype)
                    use("this")
                    o = fops.flash_attention_cuda(*x[:3], causal=causal, q_offset=off)
                    got = {}
                    for side in ("parent", "this"):
                        use(side)
                        got[side] = fops.flash_attention_bwd_cuda(
                            *x[:3], o, x[3], causal=causal, q_offset=off,
                            variant="mma_sync")
                    n += 1
                    if not all(torch.equal(a, b_) for a, b_ in zip(got["parent"],
                                                                   got["this"])):
                        differ.append([str(dtype), d, bb, sq, skv, hh, kvh, causal, off])
        return {"calls": n, "differ": differ, "bitwise_equal": not differ}

    def sm90_equal_dims() -> dict:
        """The sm90 backward at d 128 over chip_smoke.BWD_SM90_CASES and the
        train microbatch (BWD_TIMING): this tree's gradients against the
        parent's on the same inputs, bitwise; and both timed in turns at the
        train microbatch (a call's device ms, both launches)."""
        b, s, h, kv, d, _ = BWD_TIMING
        cases = list(BWD_SM90_CASES) + [(b, s, s, h, kv, True, 0)]
        differ = []
        for bb, sq, skv, hh, kvh, causal, off in cases:
            q, k, v, do = bwd_inputs(bb, sq, skv, hh, kvh, d, d)
            use("this")
            o = fops.flash_attention_cuda(q, k, v, causal=causal, q_offset=off)
            got = {}
            for side in ("parent", "this"):
                use(side)
                got[side] = fops.flash_attention_bwd_cuda(
                    q, k, v, o, do, causal=causal, q_offset=off, variant="sm90")
            if not all(torch.equal(a, b_) for a, b_ in zip(got["parent"], got["this"])):
                differ.append([bb, sq, skv, hh, kvh, causal, off])
            del got
        call = lambda: fops.flash_attention_bwd_cuda(q, k, v, o, do, causal=True,
                                                     variant="sm90")
        dev_ms = {"parent": [], "this": []}
        for _ in range(args.rounds):
            for side in ("parent", "this", "this", "parent"):
                use(side)
                dev_ms[side].append(device_ms(torch, call, 3))
        med = {side: float(np.median(v_)) for side, v_ in dev_ms.items()}
        return {"calls": len(cases), "differ": differ, "bitwise_equal": not differ,
                "timed_shape": [b, s, h, kv, d, d, "causal", "bf16"],
                **{f"{side}_device_ms": dev_ms[side] for side in dev_ms},
                **{f"{side}_median_device_ms": med[side] for side in med},
                "this_over_parent": med["this"] / med["parent"]}

    out["bwd_train"] = backward(BWD_TIMING)
    out["bwd_mla"] = backward(BWD_MLA_TIMING)
    out["bwd_equal_dims"] = equal_dims()
    out["bwd_sm90_equal_dims"] = sm90_equal_dims()
    use("this")
    print(json.dumps(out), flush=True)
    ok = all(out[k]["bitwise_equal"] for k in cases) \
        and all(out[k]["within_tol"] for k in ("bwd_train", "bwd_mla")) \
        and all(out[k]["bitwise_equal"] for k in ("bwd_equal_dims", "bwd_sm90_equal_dims"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
