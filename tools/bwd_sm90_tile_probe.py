#!/usr/bin/env python3
"""The sm90 backward's dk/dv query tile at (q/k, v) = (192, 128): the
kernel as it is (32-row tiles) against a build with 64-row tiles, on one
card.

    python tools/bwd_sm90_tile_probe.py [--rounds 3]

Builds ``csrc/flash_attention_bwd_sm90.cu`` twice with the same nvcc flags
into ``build/tile_probe/``: as it is, and with ``Layout::QT`` at 64 for
every instance. For each build it prints ptxas's registers and spills of
every kernel, holds the (192, 128) backward to the plain version
(``chip_smoke.BWD_BF16_TOL`` of each gradient's largest magnitude, a
second call bitwise) over a few shapes with v the strided half of a K/V
expansion, and times both at train_dsv2's call (``BWD_MLA_TIMING``) in
turns (qt32, qt64, qt64, qt32 for ``--rounds`` rounds): call ms (CUDA
events) and device ms (``chip_smoke.device_ms``, both launches). Prints
one JSON line with the card's name and power limit. Exits 1 if a build
fails or a result is out of tolerance.
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

NAME = "flash_attention_bwd_sm90"
QT_LINE = "static constexpr int QT = DK == 128 ? 64 : 32;"
# (b, sq, skv, h, kv, causal, q_offset): least rows and keys, ragged with a
# q_offset, bidirectional over a GQA group of 2, and 128 heads over 128.
CASES = [(2, 64, 64, 4, 2, True, 0), (2, 77, 131, 4, 2, True, 54),
         (2, 200, 200, 8, 4, False, 0), (1, 512, 512, 128, 128, True, 0)]


def build(out_dir: Path) -> dict:
    """Both builds' libraries and ptxas lines, nvcc started for both at once."""
    from repro_torch.kernels import build as kbuild
    src = (kbuild.CSRC / f"{NAME}.cu").read_text()
    if QT_LINE not in src:
        raise SystemExit(f"{NAME}.cu no longer sets QT as `{QT_LINE}`")
    texts = {"qt32": src, "qt64": src.replace(QT_LINE, "static constexpr int QT = 64;")}
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, text in texts.items():
        (out_dir / f"{tag}.cu").write_text(text)
        procs[tag] = subprocess.Popen(
            [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", str(out_dir / f"lib{tag}.so"),
             str(out_dir / f"{tag}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {}
    for tag, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {tag} build:\n{log}")
        out[tag] = {"lib": ctypes.CDLL(str(out_dir / f"lib{tag}.so")),
                    "ptxas": [l.strip() for l in log.splitlines()
                              if "registers" in l or "spill" in l or "Function properties" in l]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("bwd_sm90_tile_probe: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import BWD_BF16_TOL, BWD_MLA_TIMING, cuda_ms, device_ms
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    builds = build(ROOT / "build" / "tile_probe")

    def use(tag: str) -> None:
        kbuild._LIBS[NAME] = builds[tag]["lib"]
        fops._bwd_sm90_fn.cache_clear()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def inputs(b, sq, skv, h, kv, causal, off, dk=192, dv=128):
        q, k, kvb, do = (torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)
                         for sh in ((b, sq, h, dk), (b, skv, kv, dk), (b, skv, kv, 2 * dv),
                                    (b, sq, h, dv)))
        v = kvb[..., dv:]
        return q, k, v, fops.flash_attention_cuda(q, k, v, causal=causal, q_offset=off), do

    out = {"card": smi, "rounds": args.rounds, "tol": BWD_BF16_TOL,
           **{tag: {"ptxas": b["ptxas"], "max_rel_err": 0.0, "repeat_bitwise": True}
              for tag, b in builds.items()}}
    for case in CASES:
        x = inputs(*case)
        *_, causal, off = case
        want = flash_attention_bwd_ref(*x, causal=causal, q_offset=off)
        for tag in builds:
            use(tag)
            got = fops.flash_attention_bwd_cuda(*x, causal=causal, q_offset=off, variant="sm90")
            again = fops.flash_attention_bwd_cuda(*x, causal=causal, q_offset=off,
                                                  variant="sm90")
            rel = max(float((g.float() - w.float()).abs().max()) / float(w.float().abs().max())
                      for g, w in zip(got, want))
            out[tag]["max_rel_err"] = max(out[tag]["max_rel_err"], rel)
            out[tag]["repeat_bitwise"] &= all(torch.equal(a, b_) for a, b_ in zip(got, again))
        del x, want, got, again

    b, s, h, kv, dk, dv = BWD_MLA_TIMING
    x = inputs(b, s, s, h, kv, True, 0, dk, dv)
    call = lambda: fops.flash_attention_bwd_cuda(*x, causal=True, variant="sm90")
    for tag in builds:
        out[tag].update(ms=[], device_ms=[])
    for _ in range(args.rounds):
        for tag in ("qt32", "qt64", "qt64", "qt32"):
            use(tag)
            out[tag]["ms"].append(cuda_ms(torch, call, 10))
            out[tag]["device_ms"].append(device_ms(torch, call, 5))
    for tag in builds:
        for what in ("ms", "device_ms"):
            out[tag][f"median_{what}"] = float(np.median(out[tag][what]))
    out["timed_shape"] = [b, s, h, kv, dk, dv, "causal", "bf16"]
    use("qt32")
    print(json.dumps(out), flush=True)
    ok = all(out[tag]["max_rel_err"] <= BWD_BF16_TOL and out[tag]["repeat_bitwise"]
             for tag in builds)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
