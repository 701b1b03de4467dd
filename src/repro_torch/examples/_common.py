"""What the ported examples share: the command line, the card's sync before
a time is read, the kernels' launch counts, and the comparison of a run on
the card with one on the CPU (``card_vs_cpu``: their results, and each
flash kernel call against its plain version)."""

from __future__ import annotations

import argparse
import importlib
import math
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.hash64 import ops as hash64_ops
from repro_torch.kernels.st_scan import ops as st_scan_ops
from repro_torch.kernels.voronoi_assign import ops as voronoi_ops


def launch_counts() -> dict:
    """Every kernel's launch count so far: the datastore's three kernels by
    name, the flash forward's by variant (``flash_sm90``, ``flash_decode``,
    ``flash_mma_sync``; ``flash_bwd`` counts backward calls)."""
    return {"st_scan": st_scan_ops.launches, "hash64": hash64_ops.launches,
            "voronoi_assign": voronoi_ops.launches,
            **{f"flash_{v}": n for v, n in flash_ops.launches_by_variant.items()}}


def launches_since(before: dict) -> dict:
    """The launches each kernel made since ``before = launch_counts()``."""
    return {k: n - before[k] for k, n in launch_counts().items()}


def sync(device: torch.device) -> None:
    """Wait for the card's queue, so that a host clock read after it counts
    the work; nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cli(main, doc: str, argv=None) -> dict:
    """``python -m repro_torch.examples.<name> [--device cuda|cpu]``: the card
    by default, which raises without CUDA; ``--device cpu`` runs the plain
    PyTorch versions on the host."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    return main(device=ap.parse_args(argv).device)


# Results under these keys are float reductions whose order differs between
# the kernels and their plain versions: held to RTOL. Every other value is
# held bitwise (NaN equal to NaN).
REDUCED = ("mean", "vmean", "sum")
RTOL = 1e-5


def _mismatches(got, want, path: str, reduced: bool) -> list:
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            return [path]
        return [m for k in want for m in _mismatches(
            got[k], want[k], f"{path}.{k}", reduced or k in REDUCED)]
    if isinstance(want, (list, tuple, np.ndarray)):
        got, want = np.asarray(got), np.asarray(want)
        if got.shape != want.shape or got.dtype.kind != want.dtype.kind:
            return [path]
        if want.dtype.kind == "f" and reduced:
            ok = np.isclose(got, want, rtol=RTOL, atol=0.0, equal_nan=True)
        elif want.dtype.kind == "f":
            ok = (got == want) | (np.isnan(got) & np.isnan(want))
        else:
            ok = got == want
        return [f"{path}{list(map(int, i))}"
                for i in zip(*np.nonzero(~np.atleast_1d(ok)))]
    if isinstance(want, float):
        if math.isnan(want) and isinstance(got, float) and math.isnan(got):
            return []
        close = (reduced and isinstance(got, float)
                 and abs(got - want) <= RTOL * abs(want))
        return [] if got == want or close else [path]
    return [] if type(got) is type(want) and got == want else [path]


def hold(got: dict, want: dict, skip=("launches",)) -> list:
    """Where an example's result ``got`` differs from ``want`` (another run
    of the same example): integers, bools, strings, ids and audits bitwise,
    floats under a ``REDUCED`` key to ``RTOL``, other floats bitwise; keys
    in ``skip`` are not compared. Returns the paths that differ."""
    return _mismatches({k: v for k, v in got.items() if k not in skip},
                       {k: v for k, v in want.items() if k not in skip},
                       "", False)


DATASTORE = ("quickstart", "query_api_tour", "disaster_analytics",
             "federated_quickstart", "streaming_ingest_demo")
EXAMPLES = DATASTORE + ("serve_lm",)
# The kernels each example launches on the card ("flash": any forward
# variant). The streaming demo's one query is ``Query().latest()``, which
# reads the hot cache and runs no scan.
KERNELS = {**{name: ("st_scan", "hash64", "voronoi_assign") for name in DATASTORE},
           "streaming_ingest_demo": ("hash64", "voronoi_assign"),
           "serve_lm": ("flash",)}


def missing_kernels(name: str, launches: dict) -> list:
    """The kernels of ``KERNELS[name]`` that ``launches`` (named as in
    ``launch_counts``) shows launched no time."""
    flash = sum(n for k, n in launches.items()
                if k.startswith("flash_") and k != "flash_bwd")
    return [k for k in KERNELS[name]
            if (flash if k == "flash" else launches[k]) <= 0]


# A flash result's elements are held to tol + tol * |plain| (one bf16 ulp
# of outputs of order 1 is 0.0078).
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


class HeldFlashCalls:
    """Within ``with``, keeps every flash forward kernel call
    (``flash_attention_cuda``): its inputs as far as the call reads them
    (copies: a decode step's KV cache is written again later) and its
    result. ``errors()`` then holds each result to the plain version of the
    kernel that ran, on the same tensors: the decode kernel's to
    ``flash_decode_split_ref`` with the launch's own key splits, the
    others' to ``flash_attention_ref``, every element within ``FLASH_TOL``.
    A ``fault`` (out -> out) alters every result before it is held and
    before the model receives it: a planted kernel fault, the hold's
    control."""

    def __init__(self, fault=None):
        self.fault, self.calls = fault, []

    def __enter__(self):
        self.kernel = kernel = flash_ops.flash_attention_cuda

        def held(q, k, v, *, causal, q_offset=0, variant=None):
            ran = flash_ops.resolve_variant(q, k, v, variant)
            out = kernel(q, k, v, causal=causal, q_offset=q_offset, variant=variant)
            if self.fault is not None:
                out = self.fault(out)
            n = min(k.shape[1], int(q_offset) + q.shape[1]) if causal else k.shape[1]
            self.calls.append((ran, q.clone(), k[:, :n].clone(), v[:, :n].clone(),
                               causal, int(q_offset), out))
            return out

        flash_ops.flash_attention_cuda = held
        return self

    def __exit__(self, *exc):
        flash_ops.flash_attention_cuda = self.kernel

    def errors(self) -> dict:
        """The calls by kernel variant, the largest difference from the
        plain version, and the calls with an element beyond ``FLASH_TOL``
        or not finite."""
        from repro_torch.kernels.flash_attention.ref import (
            flash_attention_ref, flash_decode_split_ref)
        by_variant, worst, bad = {}, 0.0, 0
        for ran, q, k, v, causal, off, got in self.calls:
            if ran == "decode":
                want = flash_decode_split_ref(
                    q, k, v, causal=causal, q_offset=off,
                    n_split=flash_ops.decode_splits(q.shape[0], k.shape[2], k.shape[1]))
            else:
                want = flash_attention_ref(q, k, v, causal=causal, q_offset=off)
            tol = FLASH_TOL[q.dtype]
            err = (got.float() - want.float()).abs()
            bad += bool((err > tol + tol * want.float().abs()).any()
                        or not torch.isfinite(got).all())
            worst = max(worst, float(err.max()))
            by_variant[ran] = by_variant.get(ran, 0) + 1
        self.calls.clear()
        return {"calls": by_variant, "max_abs_err": worst, "bad_calls": bad}


def _unpaired(dev):
    return {}, lambda card: {}


def _hold(card: dict, cpu: dict) -> dict:
    return {"mismatches": hold(card, cpu)}


def card_vs_cpu(name: str, device="cuda", fault=None) -> dict:
    """Run example ``name`` on the card and then on the CPU, and hold the
    two: by the example's own ``compare(card, cpu) -> dict`` where it has
    one (its ``"mismatches"`` beside what it read), else by ``hold``. An
    example whose runs need more than a device (serve_lm: the card's
    seeded weights, and the card's ids fed to the CPU run) gives them by
    ``paired_kwargs(dev) -> (card_kw, cpu_kw(card_result))``. Every flash
    call of the card run is held to its plain version (``HeldFlashCalls``,
    with ``fault`` planted). Returns the card's printed lines, both walls,
    the comparison (``mismatches`` lists what differs) and the flash
    calls' hold."""
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    dev = resolve_device(device)
    card_kw, cpu_kw = getattr(mod, "paired_kwargs", _unpaired)(dev)
    lines = []
    with HeldFlashCalls(fault) as flash:
        sync(dev)
        t0 = time.perf_counter()
        card = mod.main(device=dev, log=lines.append, **card_kw)
        sync(dev)
        card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = mod.main(device="cpu", log=lambda _: None, **cpu_kw(card))
    cpu_s = time.perf_counter() - t0
    out = {"lines": lines, "card_s": card_s, "cpu_s": cpu_s,
           **getattr(mod, "compare", _hold)(card, cpu),
           "flash_calls": flash.errors()}
    if out["flash_calls"]["bad_calls"]:
        out["mismatches"].append("flash calls beyond FLASH_TOL")
    return out
