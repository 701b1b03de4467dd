"""Carry store state across the two packages as numpy.

``state_from_numpy(tree, device)`` builds the port's ``StoreState`` from a
state whose leaves read as numpy arrays — a nested dict
(``state_to_numpy``'s output) or a JAX ``StoreState`` itself, whose leaves
``np.asarray`` reads without this module importing JAX. ``state_to_numpy``
turns the port's state back into a nested dict of numpy arrays, so the two
packages can be compared leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.datastore import StoreState
from repro_torch.core.index import IndexState
from repro_torch.device import resolve_device


def _leaves(tree: Any, fields) -> Dict[str, Any]:
    if isinstance(tree, dict):
        return {f: tree[f] for f in fields}
    return {f: getattr(tree, f) for f in fields}


def state_from_numpy(tree: Any, device="cuda") -> StoreState:
    """The port's StoreState on ``device`` from numpy-readable leaves."""
    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x)).to(dev)
    top = _leaves(tree, StoreState._fields)
    index = IndexState(**{k: t(v) for k, v in
                          _leaves(top["index"], IndexState._fields).items()})
    return StoreState(index=index, **{k: t(v) for k, v in top.items()
                                      if k != "index"})


def state_to_numpy(state: StoreState) -> Dict[str, Any]:
    """Nested dict of numpy arrays: every StoreState leaf, and the
    IndexState leaves under ``"index"``."""
    out = {k: v.detach().cpu().numpy() for k, v in state._asdict().items()
           if k != "index"}
    out["index"] = {k: v.detach().cpu().numpy()
                    for k, v in state.index._asdict().items()}
    return out
