#!/usr/bin/env python3
"""Hold this tree's flash kernels to another checkout's, at the d 128 serve
shapes, on one card.

    python tools/flash_parent_compare.py --parent DIR [--rounds 5] [--iters 20]

DIR is a checkout of another commit (for example a ``git archive`` of the
parent, unpacked). Its ``csrc/flash_attention_sm90.cu`` and
``csrc/flash_attention_decode.cu`` are built with the same nvcc flags into
``build/parent_kernels/`` and called through this tree's wrapper (the
wrapper's library is swapped), on the same inputs as this tree's kernels:
the sm90 kernel at internlm2-1.8b's prefill (8 x 2048, 16 heads over 8,
causal) and the decode kernel at 192 of 256 and 4096 of 4096 keys. Prints
one JSON line: whether each pair of outputs is bitwise equal, and each
kernel's call time (CUDA events around ``--iters`` back-to-back calls; a
decode call's is the host's) and device time (``chip_smoke.device_ms``,
torch.profiler), taken in turns (parent, this, this, parent) for
``--rounds`` rounds, with the card's name and power limit.
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


def build_parent(parent: Path) -> dict:
    """The parent's libraries, built into build/parent_kernels/."""
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in KERNELS:
        src = parent / "src" / "repro_torch" / "csrc" / f"{name}.cu"
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(out_dir / f"lib{name}.so"), str(src)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the parent's {name}.cu:\n{err}")
    return {name: ctypes.CDLL(str(out_dir / f"lib{name}.so")) for name in KERNELS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch
    from chip_smoke import device_ms
    if not torch.cuda.is_available():
        print("flash_parent_compare: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    libs = {"this": {n: build.load(n) for n in KERNELS},
            "parent": build_parent(args.parent)}

    def use(side: str) -> None:
        for name in KERNELS:
            build._LIBS[name] = libs[side][name]
        fops._decode_fn.cache_clear()

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
                                        rand(b, 4096, kv, d)), 4095)}

    def call(variant, qkv, pos):
        return fops.flash_attention_cuda(*qkv, causal=True, q_offset=pos,
                                         variant=variant)

    def timed(variant, qkv, pos) -> float:
        call(variant, qkv, pos)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(args.iters):
            call(variant, qkv, pos)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / args.iters

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
                ms[side].append(timed(variant, qkv, pos))
                dev_ms[side].append(device_ms(
                    torch, lambda: call(variant, qkv, pos), args.iters, kernel))
        out[key] = {"bitwise_equal": bool(torch.equal(got["parent"], got["this"])),
                    **{f"{side}_{what}": vals[side]
                       for what, vals in (("ms", ms), ("device_ms", dev_ms))
                       for side in ("parent", "this")},
                    **{f"{side}_median_{what}": float(np.median(vals[side]))
                       for what, vals in (("ms", ms), ("device_ms", dev_ms))
                       for side in ("parent", "this")}}
    use("this")
    print(json.dumps(out), flush=True)
    return 0 if all(out[k]["bitwise_equal"] for k in cases) else 1


if __name__ == "__main__":
    sys.exit(main())
