#!/usr/bin/env python3
"""Repeat the fp32 smoke decoder's card-vs-CPU comparison and find what varies.

    python tools/smoke_model_repeat.py --processes 20 --out DIR
    python tools/smoke_model_repeat.py --summarize DIR
    python tools/smoke_model_repeat.py --cos-probe 40 [--threads 1]

A run does what ``tests/test_torch_kernels_cuda.py::
test_smoke_model_on_card_matches_cpu`` does: the smoke qwen3 decoder
(4 layers, d_model 128, fp32, weights from ``Generator().manual_seed(0)``)
runs ``Model.forward`` on 2 x 70 tokens on the card (through
``csrc/flash_attention.cu``) and on the CPU (through the plain version).
Each run records both hidden states and, from a second forward under a
dispatch mode, a digest of every operation's output in call order on
each side, with the host and card it ran on. ``--summarize`` compares
every side with itself across all the runs it finds (bitwise), names the
first operation where two runs of a side part, and gives the card-vs-CPU
gap of each run. ``--processes N`` starts N processes one after another
(``--runs`` runs each, the CPU side on ``--threads`` threads, the
default torch's own), writes one file each under ``--out`` and prints
the summary. ``--cos-probe N`` starts N processes that each touch the
card, then take rope's cos table of the smoke model (2 x 70 x 16 float32)
twice on the CPU, and counts the processes whose first cos differs from
their second (the largest relative difference, and the entries apart in
each half of the table). Needs a CUDA card for a run and the probe; the
summary runs anywhere.
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import json
import os
import platform
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs.base import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

TOL = 1e-4          # the card test's rtol and atol


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


class OpDigests(TorchDispatchMode):
    """Records (op name, output digest) for every op inside the block, and
    with ``keep`` a CPU copy of each output."""

    def __init__(self, keep: bool = False):
        super().__init__()
        self.ops, self.outputs, self.keep = [], [], keep

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if isinstance(o, torch.Tensor) and o.dtype.is_floating_point:
                self.ops.append((str(func), _digest(o)))
                if self.keep:
                    self.outputs.append(o.detach().cpu().clone())
        return out


def first_apart(a: OpDigests, b: OpDigests):
    """Where two recorded forwards first part: the op's index, name and
    shape, the largest absolute and relative difference of its output and
    where; None when every output is equal."""
    for k, (x, y) in enumerate(zip(a.ops, b.ops)):
        if x != y:
            u, v = a.outputs[k].double(), b.outputs[k].double()
            d = (u - v).abs()
            return {"index": k, "of": len(a.ops), "op": x[0],
                    "shape": list(u.shape), "max_abs": float(d.max()),
                    "max_rel": float((d / v.abs().clamp(min=1e-30)).max()),
                    "entries_apart": int((d > 0).sum()),
                    "at": [int(i) for i in np.unravel_index(int(d.argmax()), d.shape)]}
    return None


def _host() -> dict:
    cpu = ""
    try:
        for line in open("/proc/cpuinfo"):
            if line.startswith("model name"):
                cpu = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    props = torch.cuda.get_device_properties(0)
    return {"cpu_model": cpu or platform.processor(),
            "cpu_count": os.cpu_count(),
            "torch_threads": torch.get_num_threads(),
            "cpu_capability": torch.backends.cpu.get_cpu_capability(),
            "mkl": torch.backends.mkl.is_available(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "card": torch.cuda.get_device_name(0),
            "sms": props.multi_processor_count}


def run(n: int) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda")
    cfg = reduce_for_smoke(get_config("qwen3-14b")).replace(
        compute_dtype_str="float32")
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    cparams = tree_map(lambda a: a.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 70)).astype(np.int32))
    runs = []
    for _ in range(n):
        # as the test: the card's forward is queued, and the CPU's (recorded)
        # runs while the card may still work
        h_card = card.forward(cparams, {"tokens": toks.to(cuda)})[0]
        with OpDigests(keep=True) as first:
            h_first = cpu.forward(params, {"tokens": toks})[0]
        h_card = h_card.cpu()
        h_cpu = cpu.forward(params, {"tokens": toks})[0]
        with OpDigests(keep=True) as again:
            cpu.forward(params, {"tokens": toks})
        with OpDigests() as rec:
            h = card.forward(cparams, {"tokens": toks.to(cuda)})[0]
        sides = {"card": {"ops": rec.ops, "traced_equal": bool(torch.equal(h.cpu(), h_card))},
                 "cpu": {"ops": first.ops, "traced_equal": bool(torch.equal(h_first, h_cpu)),
                         "first_apart_from_next": first_apart(first, again)}}
        gap = (h_card - h_cpu).abs()
        bound = TOL + TOL * h_cpu.abs()
        runs.append({
            "h_card": _digest(h_card), "h_cpu": _digest(h_cpu),
            "max_abs_diff": float(gap.max()),
            "beyond_tol": int((gap > bound).sum()),
            "worst_at": [int(i) for i in np.unravel_index(int(gap.argmax()),
                                                          gap.shape)],
            "sides": sides,
            "h_card_f32_b64": base64.b64encode(h_card.numpy().tobytes()).decode(),
            "h_cpu_f32_b64": base64.b64encode(h_cpu.numpy().tobytes()).decode()})
    return {"host": _host(), "runs": runs}


def cos_once() -> dict:
    """The first and a second CPU cos of the smoke model's rope angles in a
    process that has touched the card: entries apart in each half."""
    torch.zeros(1, device="cuda")
    cfg = reduce_for_smoke(get_config("qwen3-14b"))
    pos = torch.arange(70, dtype=torch.int32)[None, :].expand(2, 70)
    ang = pos[..., None].to(torch.float32) * layers.rope_freqs(cfg.d_head, cfg.rope_theta)
    first, second = torch.cos(ang), torch.cos(ang)
    d = (first.double() - second.double()).abs()
    return {"apart": [int((d[b] > 0).sum()) for b in range(2)],
            "max_rel": float((d / second.double().abs().clamp(min=1e-30)).max())}


def summarize(root: Path) -> dict:
    runs = []
    for path in sorted(root.rglob("t*_p*.json")):       # one file a process
        doc = json.loads(path.read_text())
        for i, r in enumerate(doc["runs"]):
            runs.append((f"{path.relative_to(root)}#{i}", doc["host"], r))
    out = {"runs": len(runs), "hosts": sorted({json.dumps(h, sort_keys=True)
                                               for _, h, _ in runs})}
    for side in ("card", "cpu"):
        variants = {}
        for name, host, r in runs:
            variants.setdefault(r[f"h_{side}"], []).append(name)
        first = None
        if len(variants) > 1:
            a, b = (next(r for _, _, r in runs if r[f"h_{side}"] == v)
                    for v in list(variants)[:2])
            for k, (x, y) in enumerate(zip(a["sides"][side]["ops"],
                                           b["sides"][side]["ops"])):
                if x != y:
                    first = {"index": k, "op": x[0], "of": len(a["sides"][side]["ops"])}
                    break
        out[side] = {"variants": {v: len(names) for v, names in variants.items()},
                     "first_op_apart": first,
                     "hosts_by_variant": {v: sorted({runs_host(runs, n) for n in names})
                                          for v, names in variants.items()}}
    out["gaps"] = [{"run": n, "max_abs_diff": r["max_abs_diff"],
                    "beyond_tol": r["beyond_tol"], "worst_at": r["worst_at"],
                    "traced_equal": [r["sides"][s]["traced_equal"] for s in ("card", "cpu")],
                    "cpu_first_apart": r["sides"]["cpu"].get("first_apart_from_next")}
                   for n, _, r in runs]
    return out


def runs_host(runs, name) -> str:
    host = next(h for n, h, _ in runs if n == name)
    return f"{host['cpu_model']} / {host['cpu_capability']} / {host['card']}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--processes", type=int, default=0)
    ap.add_argument("--threads", type=int, default=0,
                    help="CPU threads for the CPU side (0: torch's default)")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--summarize", type=Path)
    ap.add_argument("--cos-probe", type=int, default=0)
    ap.add_argument("--cos-once", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.summarize:
        print(json.dumps(summarize(args.summarize), indent=1))
        return 0
    if not torch.cuda.is_available():
        print("smoke_model_repeat: a run needs a CUDA card", file=sys.stderr)
        return 1
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.cos_once:
        print(json.dumps(cos_once()))
        return 0
    if args.cos_probe:
        odd = []
        for _ in range(args.cos_probe):
            out = subprocess.run([sys.executable, __file__, "--cos-once",
                                  "--threads", str(args.threads)],
                                 check=True, capture_output=True, text=True).stdout
            r = json.loads(out.strip().splitlines()[-1])
            if sum(r["apart"]):
                odd.append(r)
        print(json.dumps({"cos_probe": args.cos_probe, "threads": args.threads
                          or torch.get_num_threads(), "processes_apart": len(odd),
                          "apart": odd}))
        return 0
    if args.processes:
        for i in range(args.processes):
            subprocess.run([sys.executable, __file__, "--runs", str(args.runs),
                            "--threads", str(args.threads),
                            "--out", str(args.out / f"t{args.threads}_p{i}.json")],
                           check=True, capture_output=True)
        print(json.dumps(summarize(args.out), indent=1))
        return 0
    doc = run(args.runs)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(doc))
    for r in doc["runs"]:
        print(json.dumps({k: r[k] for k in ("h_card", "h_cpu", "max_abs_diff",
                                            "beyond_tol", "worst_at")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
