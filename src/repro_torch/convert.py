"""Carry store state and model weights across the two packages as numpy.

``state_from_numpy(tree, device)`` builds the port's ``StoreState`` from a
state whose leaves read as numpy arrays — a nested dict
(``state_to_numpy``'s output) or a JAX ``StoreState`` itself, whose leaves
``np.asarray`` reads without this module importing JAX. ``state_to_numpy``
turns the port's state back into a nested dict of numpy arrays, so the two
packages can be compared leaf by leaf.

``params_from_numpy(tree, device)`` does the same for model weights: any
nested dict whose leaves ``np.asarray`` reads (the JAX package's params
tree, or ``params_to_numpy``'s output) becomes the port's params tree,
leaf for leaf (a stack's ``first`` leaf of leading dense layers and MLA's
attention leaves alike), so both packages compute with the same weights. bfloat16
leaves (numpy's ``bfloat16`` extension dtype, as JAX hands them out) are
read bit for bit; ``params_to_numpy`` widens bfloat16 to float32, which
keeps every value.

``opt_state_from_numpy(state, device)`` builds the port's AdamW
``OptState`` from the JAX package's (or from ``opt_state_to_numpy``'s
dict): the step a 0-d int32 tensor, the moment and master trees through
``params_from_numpy`` (bf16 moments bit for bit). ``opt_state_to_numpy``
gives the dict back (``step``, ``mu``, ``nu``, ``master`` or None), its
trees as ``params_to_numpy`` gives them.

``key_from_numpy(words)`` reads a PRNG key from its uint32 words
(``np.asarray(jax.random.key_data(k))``): a ``(2,)`` array gives one key of
the port (a pair of ints on the host), a ``(..., 2)`` array a batch of keys
(an int64 tensor on ``device``). ``key_to_numpy`` gives the words back as
uint32.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.core.datastore import StoreState
from repro_torch.core.index import IndexState
from repro_torch.device import resolve_device
from repro_torch.train.optimizer import OptState


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


def params_from_numpy(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The port's params tree on ``device`` from numpy-readable leaves."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    arr = np.asarray(tree).copy()       # writable, owned by torch
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dict of numpy arrays, leaf for leaf."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if params.dtype == torch.bfloat16:
        params = params.to(torch.float32)
    return params.detach().cpu().numpy()


def opt_state_from_numpy(state: Any, device="cuda") -> OptState:
    """The port's OptState on ``device`` from numpy-readable leaves."""
    top = _leaves(state, OptState._fields)
    dev = resolve_device(device)
    step = torch.from_numpy(np.array(top["step"], dtype=np.int32)).to(dev)
    return OptState(step=step, mu=params_from_numpy(top["mu"], dev),
                    nu=params_from_numpy(top["nu"], dev),
                    master=None if top["master"] is None
                    else params_from_numpy(top["master"], dev))


def opt_state_to_numpy(state: OptState) -> Dict[str, Any]:
    """Dict of the state's fields as numpy (trees as ``params_to_numpy``)."""
    return {"step": state.step.detach().cpu().numpy(),
            "mu": params_to_numpy(state.mu), "nu": params_to_numpy(state.nu),
            "master": None if state.master is None
            else params_to_numpy(state.master)}


def key_from_numpy(words, device="cuda") -> Union[threefry.Key, torch.Tensor]:
    """One key (a pair of ints) from a (2,) array of uint32 words, or a
    (..., 2) int64 batch of keys on ``device`` from a larger array."""
    arr = np.asarray(words).astype(np.uint32)
    if arr.shape == (2,):
        return int(arr[0]), int(arr[1])
    return torch.from_numpy(arr.astype(np.int64)).to(resolve_device(device))


def key_to_numpy(key: Union[threefry.Key, torch.Tensor]) -> np.ndarray:
    """The uint32 words of one key, (2,), or of a batch, (..., 2)."""
    if isinstance(key, torch.Tensor):
        return key.detach().cpu().numpy().astype(np.uint32)
    return np.asarray(key, dtype=np.uint32)
