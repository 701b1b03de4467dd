"""MoE and MLA training (the attention gradient at MLA's unequal head dims,
the MoE FFN's dispatch and combine under grad, ``Model.loss`` with its aux
term and ``train_loop.value_and_grad``) held against the JAX package on the
CPU.

Inputs come from ``np.random.default_rng``. The smoke models' weights are
drawn by the port's ``Model.init`` (a jitted JAX init of deepseek-v2's
smoke config takes seconds this file cannot spend), handed to JAX as arrays
and carried back through ``params_from_numpy``, so both packages compute
with the same weights. JAX's loss and gradients are computed once per
(config, dispatch mode, capacity) in a module fixture. Tolerances, as the
train tests' (``tests/test_torch_train.py``), each with its reason:

- the plain backward at (d_qk, d_v) = (48, 32) and (192, 128) in fp32,
  2e-5 against ``jax.vjp`` of the JAX package's chunked ``flash_attention``
  (the same function, summed in another order), and ``FlashAttentionFn``
  to 2e-5 against autograd of the port's ``naive_attention``;
- ``value_and_grad(Model.loss)`` of deepseek-v2's and grok-1's smoke
  models in fp32, in both dispatch modes, at the config's capacity and at
  one that drops pairs: the loss to 1e-5 relative and each gradient leaf
  to 1e-4 of its largest magnitude (the ulps of rope, the norms and the
  routing softmax through four layers, forward and back), after the
  routes and kept masks are asserted equal to JAX's, bitwise;
- remat "full" against "none": bitwise (the recompute runs the same ops
  on the same values, in the same order);
- three AdamW steps of deepseek-v2's smoke model: the losses to 1e-5
  relative of the JAX package's jitted train step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.models import attention as jattn
from repro.models.model import Model as JModel
from repro.train import optimizer as joptlib
from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
from repro_torch.models import attention as tattn
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.train import optimizer as optlib
from repro_torch.train.train_loop import make_train_step, value_and_grad
from repro_torch.tree import tree_leaves
from test_torch_moe import _jax_keep, _RouteLog
from test_torch_train import _assert_grads_close

DSV2, GROK = "deepseek-v2-236b", "grok-1-314b"
FP32 = dict(param_dtype_str="float32", compute_dtype_str="float32")
B, S = 2, 24
# 48 tokens, 4 experts, top-2: the config's factor 1.25 gives 128 slots an
# expert (no drops); 0.02 gives int(48 * 2 / 4 * 0.02) = 0, the least
# capacity, 8 slots against a mean load of 24 (drops).
FULL, DROPS = 1.25, 0.02


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the tensors are tiny, and on a shared CPU the
    intra-op pool's hand-offs cost more than the products."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


# ---------------------------------------------------------------------------
# the attention gradient at MLA's unequal head dims
# ---------------------------------------------------------------------------

BWD_CASES = [  # (b, sq, skv, h, kv, d_qk, d_v, causal, q_offset, chunk_kv)
    (2, 24, 24, 4, 2, 48, 32, True, 0, 8),         # the smoke's dims, GQA group 2
    (2, 24, 24, 4, 2, 48, 32, False, 0, 8),        # bidirectional
    (1, 19, 48, 4, 2, 48, 32, True, 29, 16),       # Sq < Skv, q_offset
    (1, 32, 32, 4, 2, 192, 128, True, 0, 16),      # deepseek-v2-236b's dims
    (1, 24, 24, 2, 2, 192, 128, False, 0, 8),
    (1, 9, 64, 4, 2, 192, 128, True, 55, 16),
]


def _mla_inputs(case, seed):
    b, sq, skv, h, kv, dk, dv = case[:7]
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return n(b, sq, h, dk), n(b, skv, kv, dk), n(b, skv, kv, dv), n(b, sq, h, dv)


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_bwd_ref_at_mla_dims_matches_jax_vjp(case):
    """flash_attention_bwd_ref against jax.vjp of the JAX package's chunked
    flash_attention at q/k d_qk and v d_v, fp32, at 2e-5; dV has v's
    shape."""
    *_, causal, off, ck = case
    q, k, v, do = _mla_inputs(case, sum(case[:7]))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    fn = lambda a, b_, c: jattn.flash_attention(a, b_, c, causal=causal,
                                                q_offset=off, chunk_kv=ck)
    o, vjp = jax.vjp(fn, jq, jk, jv)
    got = flash_attention_bwd_ref(*map(torch.from_numpy, (q, k, v)),
                                  torch.from_numpy(np.array(o)),
                                  torch.from_numpy(do), causal=causal,
                                  q_offset=off, chunk_q=16)
    assert tuple(got[2].shape) == v.shape
    for name, g, w in zip("qkv", got, vjp(jdo)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_autograd_function_at_mla_dims_matches_naive(case):
    """flash_attention under grad at an MLA pair, v the strided half of a
    K/V expansion as mla_attend passes it: FlashAttentionFn's gradients of
    q, k and the expansion equal autograd through naive_attention (2e-5)."""
    *_, causal, off, ck = case
    dv = case[6]
    q, k, v, do = map(torch.from_numpy, _mla_inputs(case, 3 + sum(case[:7])))
    kvb = torch.cat([torch.zeros_like(v), v], dim=-1)

    def grads(attend):
        xs = [x.clone().requires_grad_() for x in (q, k, kvb)]
        out = attend(xs[0], xs[1], xs[2][..., dv:])
        return out, torch.autograd.grad(out, xs, do)

    out, got = grads(lambda a, b_, c: tattn.flash_attention(
        a, b_, c, causal=causal, q_offset=off, chunk_kv=ck))
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    _, want = grads(lambda a, b_, c: tattn.naive_attention(
        a, b_, c, causal=causal, q_offset=off))
    assert float(got[2][..., :dv].abs().max()) == 0.0
    for name, g, w in zip(("q", "k", "kv expansion"), got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5, msg=f"d{name}")


@pytest.mark.parametrize("dk,dv", fops.MLA_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_variant_of_an_mla_pair_is_mma_sync(dk, dv, dtype):
    """An MLA pair's backward at the train shape (4096 rows) goes to the
    mma_sync kernel, but for bf16 (192, 128), deepseek-v2-236b's training
    call, which the sm90 backward takes; forcing the sm90 backward on any
    other raises; mma_sync may be forced on each; a pair outside
    MLA_HEAD_DIMS is not taken."""
    q = torch.empty((1, 4096, 2, dk), dtype=dtype)
    v = torch.empty((1, 4096, 2, dv), dtype=dtype)
    sm90 = (dk, dv, dtype) == (192, 128, torch.bfloat16)
    assert fops._bwd_variant(q, q, v) == ("sm90" if sm90 else "mma_sync")
    assert fops.resolve_bwd_variant(q, q, v, "mma_sync") == "mma_sync"
    if sm90:
        assert fops.resolve_bwd_variant(q, q, v, "sm90") == "sm90"
    else:
        with pytest.raises(ValueError, match="sm90 backward"):
            fops.resolve_bwd_variant(q, q, v, "sm90")
    assert fops.head_dims_supported(dk, dv)
    assert not fops.head_dims_supported(dk, 64)


# The sm90 backward's boundary shapes at (192, 128), bf16: (b, sq, skv, h,
# kv, causal, q_offset): the least rows and keys; 77 rows over 131 keys
# with a q_offset (ragged, Sq < Skv); GQA group 2.
SM90_MLA_BF16_CASES = [(1, 64, 64, 2, 2, True, 0), (1, 77, 131, 4, 2, True, 54),
                       (1, 96, 96, 4, 2, False, 0)]


@pytest.mark.parametrize("case", SM90_MLA_BF16_CASES, ids=str)
def test_bf16_bwd_ref_at_the_sm90_mla_pair_matches_jax_grad(case):
    """flash_attention_bwd_ref in bf16 at (d_qk, d_v) = (192, 128), v the
    strided half of a K/V expansion, against jax.grad of the JAX package's
    chunked flash_attention on the same bf16 inputs, each gradient within
    3e-2 of its largest magnitude (the bf16 attention tolerance of
    tests/test_torch_model.py: the two round P, the accumulator and the
    gradients to bf16 in different places)."""
    b, sq, skv, h, kv, causal, off = case
    dk, dv = 192, 128
    rng = np.random.default_rng(sum(case[:5]))
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v, do = n(b, sq, h, dk), n(b, skv, kv, dk), n(b, skv, kv, dv), n(b, sq, h, dv)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jdo = jnp.asarray(do, jnp.bfloat16).astype(jnp.float32)

    def loss(a, b_, c):
        o = jattn.flash_attention(a, b_, c, causal=causal, q_offset=off)
        return jnp.sum(o.astype(jnp.float32) * jdo)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, do))
    kvb = torch.cat([torch.zeros_like(torch.from_numpy(v)), torch.from_numpy(v)],
                    dim=-1).to(torch.bfloat16)
    tv = kvb[..., dv:]
    o = tattn.flash_attention(tq, tk, tv, causal=causal, q_offset=off)
    got = flash_attention_bwd_ref(tq, tk, tv, o, tdo, causal=causal, q_offset=off)
    for name, g, w, x in zip("qkv", got, want, (tq, tk, tv)):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape, name
        w = np.asarray(w.astype(jnp.float32))
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= 3e-2 * float(np.abs(w).max()), (name, err, float(np.abs(w).max()))


# ---------------------------------------------------------------------------
# value_and_grad of Model.loss
# ---------------------------------------------------------------------------

def _cfgs(arch, **kw):
    return (jax_reduce(jax_get_config(arch)).replace(**FP32, **kw),
            reduce_for_smoke(get_config(arch)).replace(**FP32, **kw))


@functools.cache
def _weights(arch):
    """The smoke model's weights as numpy, drawn by the port's init."""
    tm = Model(reduce_for_smoke(get_config(arch)).replace(**FP32), device="cpu")
    return params_to_numpy(tm.init(torch.Generator().manual_seed(0)))


def _batch(vocab, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels.reshape(-1)[rng.choice(B * S, 5, replace=False)] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


class _PortRoutes:
    """Records the expert indices of every port ``moe._route`` call."""

    def __enter__(self):
        self.idx, self.orig = [], moe._route

        def route(p, x, cfg):
            out = self.orig(p, x, cfg)
            self.idx.append(out[0].clone())
            return out
        moe._route = route
        return self

    def __exit__(self, *exc):
        moe._route = self.orig


@pytest.fixture(scope="module")
def jax_runs():
    """(arch, mode, factor) -> (loss, grads, routes) of the JAX package:
    ``jax.value_and_grad(Model.loss)`` jitted, and the routes of each MoE
    layer from a freshly traced jitted forward (an ordered callback)."""

    @functools.cache
    def run(arch, mode, factor):
        jcfg, _ = _cfgs(arch, moe_dispatch=mode, capacity_factor=factor)
        jm, jp = JModel(jcfg), _to_jax(_weights(arch))
        jb = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab).items()}
        loss, grads = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
        with _RouteLog() as log:
            jax.jit(lambda *a: jm.forward(*a))(jp, {"tokens": jb["tokens"]})
            jax.effects_barrier()
        return float(loss), jax.tree.map(np.asarray, grads), log.idx
    return run


MODEL_CASES = [(arch, mode, factor) for arch in (DSV2, GROK)
               for mode in ("einsum", "scatter") for factor in (FULL, DROPS)]


@pytest.mark.parametrize("arch,mode,factor", MODEL_CASES,
                         ids=[f"{a.split('-')[0]}-{m}-{'drops' if f == DROPS else 'full'}"
                              for a, m, f in MODEL_CASES])
def test_value_and_grad_matches_jax(jax_runs, arch, mode, factor):
    """The port's value_and_grad of Model.loss against JAX's: routes and
    kept masks bitwise, pairs dropped exactly at the small capacity, the
    loss to 1e-5 relative, every leaf (the gate, the routed and shared
    experts, MLA's and the ``first`` leaf's among them) to 1e-4 of its
    largest magnitude."""
    _, tcfg = _cfgs(arch, moe_dispatch=mode, capacity_factor=factor)
    tm, tp = Model(tcfg, device="cpu"), params_from_numpy(_weights(arch), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab).items()}
    with _PortRoutes() as log:
        loss, grads = value_and_grad(tm, tp, tb)
    jloss, jgrads, jidx = jax_runs(arch, mode, factor)
    n_moe = tcfg.n_layers - tcfg.first_dense
    assert len(jidx) == n_moe and len(log.idx) >= n_moe
    cap = moe._capacity(B * S, tcfg)
    dropped = 0
    for ti, ji in zip(log.idx[:n_moe], jidx):        # the forward's calls
        np.testing.assert_array_equal(ti.numpy(), ji)
        keep = moe.slots(ti, tcfg.n_experts, cap)[1].numpy()
        np.testing.assert_array_equal(keep, _jax_keep(jnp.asarray(ji),
                                                      tcfg.n_experts, cap))
        dropped += int((~keep).sum())
    assert (dropped > 0) == (factor == DROPS), dropped
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    _assert_grads_close(grads, jgrads)
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))


@pytest.mark.parametrize("arch", [DSV2, GROK])
def test_remat_full_and_none_give_the_same_bits(arch):
    _, tcfg = _cfgs(arch, capacity_factor=DROPS)
    tp = params_from_numpy(_weights(arch), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab, seed=4).items()}
    l1, g1 = value_and_grad(Model(tcfg, device="cpu"), tp, tb)
    l2, g2 = value_and_grad(Model(tcfg.replace(remat="none"), device="cpu"), tp, tb)
    assert torch.equal(l1, l2)
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        assert torch.equal(a, b)


def test_three_adamw_steps_of_deepseek_smoke_match_jax():
    """make_train_step against the JAX package's jitted step
    (value_and_grad of Model.loss, then adamw_update) from the same weights
    on the same batches: losses to 1e-5 relative."""
    jcfg, tcfg = _cfgs(DSV2)
    jm, jp = JModel(jcfg), _to_jax(_weights(DSV2))
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=20)
    jopt = joptlib.OptConfig(**kw)
    jstate = joptlib.init_opt_state(jopt, jp)
    tm = Model(tcfg, device="cpu")
    tp = params_from_numpy(_weights(DSV2), device="cpu")
    topt = optlib.OptConfig(**kw)
    tstate = optlib.init_opt_state(topt, tp)
    step = make_train_step(tm, topt)

    @jax.jit
    def jstep(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jm.loss)(params, batch)
        params, opt_state, _ = joptlib.adamw_update(jopt, grads, opt_state, params)
        return params, opt_state, loss

    for s in range(3):
        batch = _batch(tcfg.vocab, seed=10 + s)
        jp, jstate, jloss = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, tstate, m = step(tp, tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
    assert int(tstate.step) == 3


def test_adamw_in_slices_of_the_flattened_leaf_gives_the_same_bits(monkeypatch):
    """AdamW updates a leaf in slices of its flattened view (a routed-expert
    leaf of deepseek-v2-236b is 1.26e9 elements): slices of 7 elements,
    which cut across rows, give the bits of one slice a leaf."""
    rng = np.random.default_rng(12)
    shapes = {"w": (3, 6, 8), "norm": (8,), "s": ()}
    tree = lambda scale: {k: torch.from_numpy(np.asarray(
        scale * rng.standard_normal(s), np.float32)) for k, s in shapes.items()}
    params, grads = tree(1.0), tree(0.5)
    cfg = optlib.OptConfig(lr=1e-2, warmup_steps=2, total_steps=12)

    def steps():
        p = {k: v.clone() for k, v in params.items()}
        state = optlib.init_opt_state(cfg, p)
        for _ in range(3):
            p, state, _ = optlib.adamw_update(cfg, grads, state, p)
        return tree_leaves((p, state.mu, state.nu))

    whole = steps()
    monkeypatch.setattr(optlib, "_CHUNK_ELEMS", 7)
    for a, b in zip(steps(), whole):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError):          # a write through a copy would be lost
        optlib.adamw_update(cfg, {"w": grads["w"]}, optlib.init_opt_state(
            cfg, {"w": params["w"]}), {"w": params["w"].transpose(0, 2)})
