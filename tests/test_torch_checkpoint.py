"""The port's checkpoints (``repro_torch.train.checkpoint``) held to the JAX
package's on-disk format on the CPU: each package restores the other's
checkpoint of params and AdamW state bitwise, every leaf; ``keep``
garbage-collects, ``latest_step`` finds the newest; a restored run trains
on exactly as the original (the reference's tests/test_runtime.py:57-97,
in the port); and the example's restart (6 steps straight against 3, a
save, a restore into fresh objects and 3 more) ends bitwise equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.models.model import Model as JModel
from repro.train import checkpoint as jckpt
from repro.train import optimizer as joptlib
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.examples import train_lm
from repro_torch.models.model import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as optlib
from repro_torch.train.train_loop import make_train_step
from repro_torch.tree import tree_leaves, tree_unflatten

# tests/test_runtime.py's TINY
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv=2, d_head=16, d_ff=128, vocab=128, loss_chunk=64,
            attn_chunk_kv=32)


def _jax_state(keep_master=False):
    """JAX params and an AdamW state after one update (bf16 moments, step 1;
    bf16 params with an fp32 master copy when ``keep_master``)."""
    jm = JModel(JConfig(**TINY, param_dtype_str="bfloat16" if keep_master
                        else "float32"))
    params = jm.init(jax.random.key(0))
    cfg = joptlib.OptConfig(keep_master=keep_master)
    state = joptlib.init_opt_state(cfg, params)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.25, p.dtype), params)
    params, state, _ = joptlib.adamw_update(cfg, grads, state, params)
    return params, state


def _port_tree(params, state):
    return {"params": convert.params_from_numpy(params, "cpu"),
            "opt": convert.opt_state_from_numpy(state, "cpu")}


def _bits(x):
    """A leaf's raw bytes and dtype name, from either package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes(), "bfloat16"
        return x.numpy().tobytes(), str(x.numpy().dtype)
    a = np.asarray(x)
    return a.tobytes(), str(a.dtype)


def _assert_same_leaves(port_tree, jax_tree):
    got = tree_leaves(port_tree)
    want = jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        assert _bits(g) == _bits(w)


@pytest.mark.parametrize("keep_master", [False, True])
def test_jax_checkpoint_restores_in_the_port(tmp_path, keep_master):
    params, state = _jax_state(keep_master)
    tree = {"params": params, "opt": state}
    jckpt.save_checkpoint(tmp_path, 7, tree)
    like = _port_tree(params, state)
    restored, step = ckpt.restore_checkpoint(tmp_path, like)
    assert step == 7
    assert isinstance(restored["opt"], optlib.OptState)
    assert restored["opt"].step.dtype == torch.int32
    _assert_same_leaves(restored, tree)


@pytest.mark.parametrize("keep_master", [False, True])
def test_port_checkpoint_restores_in_jax(tmp_path, keep_master):
    params, state = _jax_state(keep_master)
    port = _port_tree(params, state)
    ckpt.save_checkpoint(tmp_path, 3, port)
    restored, step = jckpt.restore_checkpoint(tmp_path, {"params": params,
                                                         "opt": state})
    assert step == 3
    _assert_same_leaves(port, restored)
    manifest = json.loads((tmp_path / "step_00000003" / "MANIFEST.json").read_text())
    assert set(manifest["dtypes"]) == ({"bfloat16", "float32", "int32"})
    assert manifest["shards"] == ["shard_00000.npz"]


def test_manifest_matches_the_reference(tmp_path):
    """Both packages write the same arrays, shapes, dtypes and step for the
    same tree; only the time and the informational treedef differ."""
    params, state = _jax_state()
    jckpt.save_checkpoint(tmp_path / "jax", 1, {"params": params, "opt": state})
    ckpt.save_checkpoint(tmp_path / "port", 1, _port_tree(params, state))
    mj, mp = (json.loads((tmp_path / d / "step_00000001" / "MANIFEST.json").read_text())
              for d in ("jax", "port"))
    for key in ("step", "n_arrays", "shapes", "dtypes", "shards"):
        assert mj[key] == mp[key], key
    with np.load(tmp_path / "jax" / "step_00000001" / "shard_00000.npz") as a, \
            np.load(tmp_path / "port" / "step_00000001" / "shard_00000.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])


def _trainer(seed=0):
    """tests/test_runtime.py's make_trainer in the port, on the CPU."""
    model = Model(ModelConfig(**TINY), device="cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    opt_cfg = optlib.OptConfig(lr=1e-2, warmup_steps=5, total_steps=100,
                               clip_norm=1.0)
    return model, params, optlib.init_opt_state(opt_cfg, params), \
        make_train_step(model, opt_cfg)


def _fixed_batch(b=4, s=32, seed=7):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, TINY["vocab"], (b, s + 1)).astype(np.int32))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _clone(tree):
    return tree_unflatten(tree, [x.clone() for x in tree_leaves(tree)])


def test_checkpoint_roundtrip(tmp_path):
    """The reference's test_checkpoint_roundtrip: save after 3 steps, restore;
    the leaves are equal and one more step from either gives the same loss.
    The step updates in place, so each side works on its own clone."""
    model, params, opt_state, step = _trainer()
    batch = _fixed_batch()
    for _ in range(3):
        params, opt_state, _ = step(params, opt_state, batch)
    ckpt.save_checkpoint(tmp_path, 3, {"params": params, "opt": opt_state})
    restored, got_step = ckpt.restore_checkpoint(
        tmp_path, {"params": params, "opt": opt_state})
    assert got_step == 3
    for a, b in zip(tree_leaves(restored), tree_leaves(
            {"params": params, "opt": opt_state})):
        assert torch.equal(a, b)
    _, _, m1 = step(*_clone((params, opt_state)), batch)
    _, _, m2 = step(restored["params"], restored["opt"], batch)
    assert float(m1["loss"]) == float(m2["loss"])


def test_checkpoint_gc_and_latest(tmp_path):
    _, params, _, _ = _trainer()
    assert ckpt.latest_step(tmp_path) is None
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(tmp_path, s, {"p": params}, keep=2)
    assert ckpt.latest_step(tmp_path) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp_path / "none", {"p": params})
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore_checkpoint(tmp_path, {"p": params, "q": params})


def test_example_restart_is_bitwise(tmp_path):
    """examples/train_lm.py's simulated restart on the CPU: 6 steps straight
    against 3 steps, a checkpoint, a fresh run that restores it and 3 more;
    the params and the optimizer state end bitwise equal, and so do the
    losses of the steps both took."""
    log = lambda *_: None
    straight = train_lm.run(6, None, 50, "cpu", log=log)
    first = train_lm.run(6, tmp_path, 3, "cpu", stop=3, log=log)
    assert ckpt.latest_step(tmp_path) == 3 and first["start"] == 0
    second = train_lm.run(6, tmp_path, 3, "cpu", log=log)
    assert second["start"] == 3
    assert first["losses"] + second["losses"] == straight["losses"]
    for a, b in zip(tree_leaves({"p": second["params"], "o": second["opt"]}),
                    tree_leaves({"p": straight["params"], "o": straight["opt"]})):
        assert torch.equal(a, b)
    assert ckpt.latest_step(tmp_path) == 6
