"""Atomic checkpoints in the reference's on-disk format (port of
``repro.train.checkpoint``), so either package reads the other's.

A checkpoint of ``step`` is the directory ``step_{step:08d}`` under
``ckpt_dir``: written first as ``.tmp_step_{step:08d}`` and renamed when
complete, so a crash mid-write never leaves a half checkpoint where
``latest_step`` looks. It holds ``shard_00000.npz``, one raw-byte uint8
array ``a{i}`` a leaf, and ``MANIFEST.json`` with ``step``, ``time``,
``n_arrays``, ``treedef``, ``shapes``, ``dtypes`` (numpy names:
``"bfloat16"``, ``"float32"``, ``"int32"``) and ``shards``. The leaves go in
JAX's flatten order (dict keys sorted, NamedTuple fields in order, None
dropped). ``treedef`` is informational: a restore checks only
``n_arrays``, as the reference does. The reference's elastic re-sharding
(``shardings``) is mesh-only and not ported; ``restore_checkpoint`` puts
each leaf on the device of the matching leaf of ``tree_like``.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_unflatten


def _treedef(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return f"{type(tree).__name__}(" + ", ".join(
            f"{f}={_treedef(x)}" for f, x in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_treedef(x) for x in tree) + ")"
    return "*"


def _to_numpy(x: torch.Tensor) -> tuple[np.ndarray, str]:
    """The leaf's bytes as a flat uint8 array, and its dtype's numpy name."""
    x = x.detach().cpu().reshape(-1)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint8), "bfloat16"
    arr = x.numpy()
    return arr.view(np.uint8), str(arr.dtype)


def _from_bytes(raw: np.ndarray, dtype: str, shape, device) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = raw.view(np.int16).reshape(shape).copy()
        return torch.from_numpy(arr).view(torch.bfloat16).to(device)
    arr = raw.view(np.dtype(dtype)).reshape(shape).copy()
    return torch.from_numpy(arr).to(device)


def save_checkpoint(ckpt_dir, step: int, tree, *, keep: int = 3) -> Path:
    """Write a checkpoint atomically; returns its final directory."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    flat = tree_leaves(tree)
    raw = [_to_numpy(x) for x in flat]
    np.savez(tmp / "shard_00000.npz",
             **{f"a{i}": r for i, (r, _) in enumerate(raw)})
    manifest = {
        "step": step,
        "time": time.time(),
        "n_arrays": len(flat),
        "treedef": _treedef(tree),
        "shapes": [list(x.shape) for x in flat],
        "dtypes": [dt for _, dt in raw],
        "shards": ["shard_00000.npz"],
    }
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic visibility
    _gc_old(ckpt_dir, keep)
    return final


def _gc_old(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p)


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(ckpt_dir.glob("step_*"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def restore_checkpoint(ckpt_dir, tree_like, *, step: int | None = None):
    """Restore into the structure of ``tree_like`` (each leaf onto the
    device of ``tree_like``'s leaf). Returns (tree, step)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    flat_like = tree_leaves(tree_like)
    if manifest["n_arrays"] != len(flat_like):
        raise ValueError("checkpoint/tree structure mismatch: "
                         f"{manifest['n_arrays']} vs {len(flat_like)} arrays")
    with np.load(d / "shard_00000.npz") as data:
        flat = [_from_bytes(data[f"a{i}"], manifest["dtypes"][i],
                            tuple(manifest["shapes"][i]), like.device)
                for i, like in enumerate(flat_like)]
    return tree_unflatten(tree_like, flat), step
