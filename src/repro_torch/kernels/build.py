"""Build and load the port's CUDA kernels.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds). Libraries go to ``build/kernels/`` at the repository
root (``$REPRO_TORCH_BUILD_DIR`` overrides), named by a digest of the source
and the flags, so an edited source is rebuilt and a stale library is never
loaded. Nothing is downloaded: the sources in the checkout and the CUDA
toolkit are all a build needs.

``build_all()`` starts one ``nvcc`` per source at once and waits for all of
them; ``load(name)`` builds on first use. Each C entry point launches on the
stream it is given and returns ``cudaGetLastError()``; ``check`` raises on a
non-zero code.

``builds`` and ``loads`` count, by kernel name, the ``nvcc`` processes
started and the libraries loaded with ``ctypes`` in this process: a warm
process builds and loads nothing (``repro_torch.analysis.retrace``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
KERNELS = ("st_scan", "hash64", "voronoi_assign", "flash_attention",
           "flash_attention_sm90", "flash_attention_decode",
           "flash_attention_bwd", "flash_attention_bwd_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
builds: Counter = Counter()
loads: Counter = Counter()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the port's CUDA kernels are built from csrc/ at first use.")
    return found


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:12]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    out = lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    builds[name] += 1
    return proc


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    rc = proc.wait()
    out = lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if rc != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {rc}):\n"
                           + out.with_suffix(".log").read_text())
    os.replace(tmp, out)        # atomic: a reader never sees half a library


def build_all(names: Iterable[str] = KERNELS) -> float:
    """Build every listed kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns the wall seconds it took."""
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in names}
    for n, proc in procs.items():
        _finish(n, proc)
    return time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """``ptxas -v`` lines (each kernel's mangled name, then its registers,
    shared memory and spills) of a build."""
    log = lib_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(l for l in log.read_text().splitlines()
                     if "registers" in l or "spill" in l
                     or "Function properties" in l)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        loads[name] += 1
        _LIBS[name] = lib
    return lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
