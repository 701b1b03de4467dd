"""The port's training path (``repro_torch.train``, ``Model.loss``, the
flash-attention gradient and the AerialDB-backed data pipeline) held
against the JAX package on the CPU.

Inputs come from ``np.random.default_rng``; JAX weights reach the port
through ``params_from_numpy`` and its optimizer state through
``opt_state_from_numpy``. Tolerances, each with its reason:

- attention gradients in fp32, 2e-5 (as the forward in
  ``tests/test_torch_model.py``): the same function, summed in another order
  (JAX differentiates its chunked scan; the port's plain backward applies
  the FlashAttention-2 formula);
- the loss and its gradients in fp32, the loss to 1e-5 relative and each
  gradient leaf to 1e-4 of its largest magnitude: the ulps of rope and the
  norm (``tests/test_torch_model.py``) through a few layers, forward and
  back;
- remat "full" against "none": bitwise (the recompute runs the same ops on
  the same values, in the same order);
- AdamW given JAX's exact grads, params and state: 1 ulp in fp32 and 1 bf16
  ulp in the moments (XLA and torch may round ``pow`` and the per-leaf sums
  of the global norm an ulp apart), against JAX's ``adamw_update`` run op by
  op, the order the port follows: under ``jit`` XLA fuses the schedule's
  float32 constants and lands the learning rate 1-4 ulps from either;
- three training steps: the losses to 1e-5 relative in fp32 compute, and
  to 2e-2 in the example's bf16 compute (the JAX chunked attention keeps
  its accumulator in bf16, the port in fp32);
- the pipeline: the store's leaves, the window counts and the tokens
  bitwise, the window sums to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.data.pipeline import AerialPipeline as JPipeline
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.models import attention as jattn
from repro.models.model import Model as JModel
from repro.train import optimizer as joptlib
from repro.train import train_loop as jtrain
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import AerialPipeline, PipelineConfig, tokenize
from repro_torch.examples.train_lm import LM_8M
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
from repro_torch.models import attention as tattn
from repro_torch.models.model import Model
from repro_torch.train import optimizer as optlib
from repro_torch.train.train_loop import (loss_with_microbatch,
                                         make_train_step, value_and_grad)
from repro_torch.tree import tree_leaves, tree_unflatten


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close_rel(got, want, rel, what=""):
    """Every element within ``rel`` of ``want``'s largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err} > {rel} x {scale}"


# ---------------------------------------------------------------------------
# (a), (b): the attention gradient
# ---------------------------------------------------------------------------

BWD_CASES = [  # (b, sq, skv, h, kv, dh, causal, q_offset, chunk_kv)
    (2, 64, 64, 4, 2, 32, True, 0, 16),       # GQA group 2
    (2, 64, 64, 4, 2, 32, False, 0, 16),
    (1, 48, 96, 8, 2, 16, True, 48, 32),      # Sq != Skv, q_offset, G 4
    (1, 40, 40, 2, 2, 64, True, 0, 20),       # G 1
    (2, 33, 60, 4, 1, 32, False, 0, 20),      # MQA, ragged rows
]


def _bwd_inputs(case, seed):
    b, sq, skv, h, kv, dh = case[:6]
    rng = np.random.default_rng(seed)
    return (_normal(rng, b, sq, h, dh), _normal(rng, b, skv, kv, dh),
            _normal(rng, b, skv, kv, dh), _normal(rng, b, sq, h, dh))


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_bwd_ref_matches_jax_vjp(case):
    """flash_attention_bwd_ref against jax.vjp of the JAX package's chunked
    flash_attention and of naive_attention, fp32, at 2e-5."""
    _, _, _, _, _, _, causal, off, ck = case
    q, k, v, do = _bwd_inputs(case, sum(case[:6]))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o = jattn.flash_attention(jq, jk, jv, causal=causal, q_offset=off, chunk_kv=ck)
    got = flash_attention_bwd_ref(_t(q), _t(k), _t(v), _t(o), _t(do),
                                  causal=causal, q_offset=off, chunk_q=16)
    for fn in (lambda a, b_, c: jattn.flash_attention(
                   a, b_, c, causal=causal, q_offset=off, chunk_kv=ck),
               lambda a, b_, c: jattn.naive_attention(
                   a, b_, c, causal=causal, q_offset=off)):
        _, vjp = jax.vjp(fn, jq, jk, jv)
        for name, g, w in zip("qkv", got, vjp(jdo)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                       atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_autograd_function_matches_naive_autograd(case):
    """flash_attention under grad goes through FlashAttentionFn on the CPU;
    its gradients equal autograd through the port's naive_attention (fp32,
    2e-5), and the output carries a grad_fn."""
    _, _, _, _, _, _, causal, off, ck = case
    q, k, v, do = map(_t, _bwd_inputs(case, 7 + sum(case[:6])))
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tattn.flash_attention(*xs, causal=causal, q_offset=off, chunk_kv=ck)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, xs, do)
    ys = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(tattn.naive_attention(*ys, causal=causal,
                                                     q_offset=off), ys, do)
    for name, g, w in zip("qkv", got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5, msg=f"d{name}")


def test_no_grad_calls_build_no_graph():
    q = torch.zeros((1, 8, 2, 16), requires_grad=True)
    with torch.no_grad():
        out = fops.flash_attention(q, q, q, causal=True)
    assert out.grad_fn is None
    out = fops.flash_attention(q.detach(), q.detach(), q.detach(), causal=True)
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# (c), (d), (f): Model.loss, remat, microbatches
# ---------------------------------------------------------------------------

# A small fp32 config: vocab 300 pads to 512 (the padded columns are
# masked), 80 tokens in blocks of 48 (the reference drops the tail block).
SMALL = dict(name="small", family="dense", n_layers=3, d_model=64, n_heads=4,
             n_kv=2, d_head=32, d_ff=128, vocab=300, loss_chunk=48,
             attn_chunk_kv=20, param_dtype_str="float32",
             compute_dtype_str="float32")


def _pair(**kw):
    cfg = {**SMALL, **kw}
    jm = JModel(JConfig(**cfg))
    jp = jm.init(jax.random.key(0))
    tm = Model(ModelConfig(**cfg), device="cpu")
    return jm, jp, tm, convert.params_from_numpy(jp, device="cpu")


def _batch(vocab, b=2, s=40, seed=3, masked=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels.reshape(-1)[rng.choice(b * s, masked, replace=False)] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _assert_grads_close(tgrads, jgrads, rel=1e-4):
    want = convert.params_to_numpy(convert.params_from_numpy(jgrads, "cpu"))
    got = convert.params_to_numpy(tgrads)
    paths = jax.tree_util.tree_leaves_with_path(want)
    assert len(paths) == len(tree_leaves(tgrads))
    for path, w in paths:
        g = got
        for key in path:
            g = g[key.key]
        _close_rel(g, w, rel, jax.tree_util.keystr(path))


def test_loss_and_grads_match_jax():
    jm, jp, tm, tp = _pair()
    batch = _batch(tm.cfg.vocab)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: _t(v) for k, v in batch.items()}
    loss, grads = value_and_grad(tm, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    with torch.no_grad():
        assert float(tm.loss(tp, tb)) == float(loss)      # no-grad path, same bits
    _assert_grads_close(grads, jgrads)


def test_remat_full_and_none_give_the_same_bits():
    _, _, tm, tp = _pair()
    tb = {k: _t(v) for k, v in _batch(tm.cfg.vocab, seed=4).items()}
    none = Model(tm.cfg.replace(remat="none"), device="cpu")
    l1, g1 = value_and_grad(tm, tp, tb)
    l2, g2 = value_and_grad(none, tp, tb)
    assert torch.equal(l1, l2)
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        assert torch.equal(a, b)


def test_loss_with_microbatch_matches_reference():
    jm, jp, tm, tp = _pair()
    batch = _batch(tm.cfg.vocab, b=4, s=24, seed=9)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtrain.loss_with_microbatch(jm, p, jb, 2))(jp)
    tb = {k: _t(v) for k, v in batch.items()}
    loss, grads = value_and_grad(tm, tp, tb, 2)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_grads_close(grads, jgrads)
    with pytest.raises(ValueError, match="microbatches"):
        loss_with_microbatch(tm, tp, tb, 3)


# ---------------------------------------------------------------------------
# (e): AdamW
# ---------------------------------------------------------------------------

def _ulps(got, want, dtype):
    """Largest distance in units in the last place of ``dtype`` (float32 or
    bfloat16) between two float32 arrays holding values of that dtype."""
    bits = lambda x: np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    g, w = bits(got), bits(want)
    if dtype == "bfloat16":
        g, w = g >> 16, w >> 16
    # order the sign-magnitude integers
    top = 1 << (31 if dtype == "float32" else 15)
    g = np.where(g < 0, -(g + top), g)
    w = np.where(w < 0, -(w + top), w)
    return int(np.abs(g - w).max()) if g.size else 0


def _opt_inputs(rng, param_dtype):
    shapes = {"stack": {"w": (3, 6, 8), "ln": (3, 8)}, "emb": (16, 8),
              "norm": (8,)}

    def tree(fn):
        return jax.tree.map(fn, shapes, is_leaf=lambda x: isinstance(x, tuple))
    params = tree(lambda s: jnp.asarray(_normal(rng, *s), param_dtype))
    return params, shapes, tree


@pytest.mark.parametrize("keep_master", [False, True])
def test_adamw_update_matches_jax(keep_master):
    """Four steps from state steps 0, 1, 5 and 9 (warmup, its end, the
    cosine branch), gradients both clipped and not; at each step the port
    is given JAX's exact inputs."""
    rng = np.random.default_rng(11)
    pdt = jnp.bfloat16 if keep_master else jnp.float32
    params, shapes, tree = _opt_inputs(rng, pdt)
    cfg = joptlib.OptConfig(lr=1e-2, warmup_steps=2, total_steps=12,
                            keep_master=keep_master)
    tcfg = optlib.OptConfig(lr=1e-2, warmup_steps=2, total_steps=12,
                            keep_master=keep_master)
    state = joptlib.init_opt_state(cfg, params)
    upd = lambda g, s, p: joptlib.adamw_update(cfg, g, s, p)
    for step0, gscale in ((0, 3.0), (1, 0.01), (5, 1.0), (9, 0.02)):
        state = state._replace(step=jnp.int32(step0))
        grads = tree(lambda s: jnp.asarray(gscale * _normal(rng, *s)))
        tparams = convert.params_from_numpy(params, "cpu")
        tstate = convert.opt_state_from_numpy(state, "cpu")
        tgrads = convert.params_from_numpy(grads, "cpu")
        params, state, m = upd(grads, state, params)
        tparams, tstate, tm = optlib.adamw_update(tcfg, tgrads, tstate, tparams)
        assert int(tstate.step) == int(state.step) == step0 + 1
        assert _ulps(tm["lr"].numpy(), np.asarray(m["lr"]), "float32") <= 1
        assert _ulps(tm["grad_norm"].numpy(), np.asarray(m["grad_norm"]), "float32") <= 1
        got, want = convert.opt_state_to_numpy(tstate), state
        pairs = [("params", convert.params_to_numpy(tparams),
                  jax.tree.map(lambda x: np.asarray(x, np.float32), params),
                  "bfloat16" if keep_master else "float32"),
                 ("mu", got["mu"], jax.tree.map(lambda x: np.asarray(x, np.float32), want.mu),
                  "bfloat16"),
                 ("nu", got["nu"], jax.tree.map(lambda x: np.asarray(x, np.float32), want.nu),
                  "bfloat16")]
        if keep_master:
            pairs.append(("master", got["master"],
                          jax.tree.map(np.asarray, want.master), "float32"))
        for name, g, w, dt in pairs:
            for gl, wl in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
                assert _ulps(gl, wl, dt) <= 1, (name, step0)


def test_global_norm_sums_leaves_in_flatten_order():
    tree = {"b": torch.tensor([3.0]), "a": {"y": torch.tensor([4.0]),
                                            "x": torch.tensor([12.0])}}
    assert [float(x) for x in tree_leaves(tree)] == [12.0, 4.0, 3.0]
    assert float(optlib.global_norm(tree)) == 13.0


# ---------------------------------------------------------------------------
# (g): three steps of the example's training loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_three_train_steps_match_the_example(compute, rel):
    """The port's make_train_step against examples/train_lm.py's jitted step
    (value_and_grad of Model.loss, then adamw_update) from the same weights
    on the same batches: lm-8m, the example's OptConfig."""
    kw = {f: getattr(LM_8M, f) for f in ("name", "family", "n_layers", "d_model",
                                         "n_heads", "n_kv", "d_head", "d_ff",
                                         "vocab", "loss_chunk", "attn_chunk_kv")}
    jm = JModel(JConfig(**kw, compute_dtype_str=compute))
    jp = jm.init(jax.random.key(0))
    jcfg = joptlib.OptConfig(lr=3e-3, warmup_steps=20, total_steps=200)
    jstate = joptlib.init_opt_state(jcfg, jp)
    tm = Model(LM_8M.replace(compute_dtype_str=compute), device="cpu")
    tp = convert.params_from_numpy(jp, "cpu")
    tstate = optlib.init_opt_state(
        optlib.OptConfig(lr=3e-3, warmup_steps=20, total_steps=200), tp)
    step = make_train_step(tm, optlib.OptConfig(lr=3e-3, warmup_steps=20,
                                                total_steps=200))

    @jax.jit
    def jstep(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jm.loss)(params, batch)
        params, opt_state, _ = joptlib.adamw_update(jcfg, grads, opt_state, params)
        return params, opt_state, loss

    for s in range(3):
        toks = np.random.default_rng(s).integers(0, 512, (8, 65)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        jp, jstate, jloss = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, tstate, m = step(tp, tstate, {k: _t(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=rel)
    assert int(tstate.step) == 3


# ---------------------------------------------------------------------------
# (i): the AerialDB-backed data pipeline
# ---------------------------------------------------------------------------

PIPE_KW = dict(rounds=3, n_drones=8, batch=2, seq=16)   # tests/test_runtime.py's
STEPS = (5, 0, 1, 17)


@pytest.fixture(scope="module")
def pipes():
    return (JPipeline(JPipelineConfig(**PIPE_KW)),
            AerialPipeline(PipelineConfig(**PIPE_KW), device="cpu"))


def _state_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _state_leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def test_pipeline_store_matches_reference(pipes):
    jp, tp = pipes
    want = dict(_state_leaves(convert.state_to_numpy(
        convert.state_from_numpy(jp.db.state, "cpu"))))
    got = dict(_state_leaves(convert.state_to_numpy(tp.db.state)))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert tp.t_max == jp.t_max


@pytest.mark.parametrize("step", STEPS)
def test_pipeline_windows_and_tokens_match_reference(pipes, step):
    jp, tp = pipes
    jres = jp._window_stats(step, jp.cfg.batch)
    tres = tp._window_stats(step, tp.cfg.batch)
    np.testing.assert_array_equal(tres.count.numpy(), np.asarray(jres.count))
    np.testing.assert_allclose(tres.vsum.numpy(), np.asarray(jres.vsum),
                               rtol=1e-5)
    jstats = np.stack([np.asarray(jres.count, np.float32),
                       np.asarray(jres.vsum, np.float32)], axis=1)
    jb = jp.get_batch(step)
    # the tokenizer on JAX's own stats, bitwise
    toks = tokenize(jstats, jp.cfg.seed, step, jp.cfg.vocab, jp.cfg.seq)
    np.testing.assert_array_equal(toks[:, :-1], np.asarray(jb["tokens"]))
    # the whole batch through the port's store
    tb = tp.get_batch(step)
    assert tb["tokens"].dtype == tb["labels"].dtype == torch.int32
    assert tuple(tb["tokens"].shape) == (PIPE_KW["batch"], PIPE_KW["seq"])
    np.testing.assert_array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))
    np.testing.assert_array_equal(tb["labels"].numpy(), np.asarray(jb["labels"]))


def test_pipeline_deterministic_resume():
    """A second pipeline from the same config gives the same batch (the
    reference's test_pipeline_deterministic_resume)."""
    a = AerialPipeline(PipelineConfig(**PIPE_KW), device="cpu").get_batch(5)
    b = AerialPipeline(PipelineConfig(**PIPE_KW), device="cpu").get_batch(5)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"], b["labels"])
