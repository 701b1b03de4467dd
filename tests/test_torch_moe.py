"""The MoE family (``repro_torch.models.moe``, the moe branch of the decoder
stack and ``Model``, grok-1-314b's config) held against the JAX package on
the CPU.

Inputs come from ``np.random.default_rng``; JAX weights reach the port
through ``params_from_numpy``. Tolerances, each with its reason:

- routing: expert indices bitwise, ties included (``top_k`` breaks them as
  ``lax.top_k``: the lower index first); weights and the aux loss within
  1e-6 (XLA's and torch's ``exp`` in the softmax differ by ulps);
- ``moe_apply`` in fp32 within 1e-5: the dispatch and the combine give the
  reference's bits or its sums of two terms, so only the batched expert
  products sum in another order; the kept mask bitwise;
- ``moe_apply`` in bf16 within 2e-2 + 1e-2 |want| (about two bf16 ulps at
  the outputs' magnitudes, up to 2.7): the routes and the kept mask are
  still bitwise, but XLA's bf16 ``sigmoid`` is not the correctly rounded
  one ``F.silu`` gives (it differs in about a third of its outputs, by an
  ulp), and each expert product rounds once to bf16 after it;
- the smoke model (4 layers, d_model 128, 4 heads over 1, 4 experts top-2,
  expert width 64, vocab 512) in fp32 within 1e-4 for the forward and the
  decode logits, as the dense model is held; its loss and aux within 1e-5
  relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.models import moe as jmoe
from repro.models.model import Model as JModel
from repro_torch.configs.base import ModelConfig, get_config, reduce_for_smoke
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.serve.engine import Engine, ServeConfig
from test_torch_serve import _assert_greedy_ids_match, _assert_prefill_step_matches

ARCH = "grok-1-314b"
FP32 = dict(param_dtype_str="float32", compute_dtype_str="float32")
BF16 = dict(param_dtype_str="float32", compute_dtype_str="bfloat16")
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=2e-2)
# 32 tokens, 4 experts, top-2: int(32 * 2 / 4 * 0.05) = 0 gives the least
# capacity, 8 slots an expert against a mean load of 16 (drops); 1.25 gives
# 128 (no drops).
CAP8_FACTOR, FULL_FACTOR = 0.05, 1.25


def _cfgs(dtype=FP32, **kw):
    """The reference's and the port's grok smoke config with ``kw``."""
    return (jax_reduce(jax_get_config(ARCH)).replace(**dtype, **kw),
            reduce_for_smoke(get_config(ARCH)).replace(**dtype, **kw))


def _layer_pair(seed, jcfg):
    """One MoE layer's JAX params and the port's copy."""
    p = jmoe.init_moe(jax.random.key(seed), jcfg)
    return p, params_from_numpy(p, device="cpu")


def _x(seed, dtype, shape=(2, 16, 128)):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype is FP32 else (jnp.bfloat16, torch.bfloat16)
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _jax_keep(idx, e, cap):
    """The reference's kept mask of each (token, choice) pair, by its own
    two rank rules: the einsum mode's (``moe.py:109-111``) and the scatter
    mode's (``:135-138``), which must agree."""
    t, k = idx.shape
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot.sum(1), axis=0) - onehot.sum(1)
    keep_einsum = jnp.take_along_axis(pos < cap, idx, axis=1)
    flat_e = idx.reshape(-1)
    rank = (jnp.cumsum(flat_e[:, None] == jnp.arange(e), axis=0) - 1)[
        jnp.arange(t * k), flat_e]
    keep_scatter = (rank < cap).reshape(t, k)
    assert np.array_equal(np.asarray(keep_einsum), np.asarray(keep_scatter))
    return np.asarray(keep_einsum)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_top_k_breaks_ties_as_jax(k):
    """Rows of few distinct values, so most rows tie inside or across the
    k-th place: values and indices bitwise against ``lax.top_k``."""
    x = np.random.default_rng(k).integers(0, 3, (512, 8)).astype(np.float32) / 4
    wv, wi = jax.lax.top_k(jnp.asarray(x), k)
    gv, gi = moe.top_k(torch.from_numpy(x), k)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gv.numpy(), np.asarray(wv))


def _tied_route_inputs(seed, e=8):
    """A sparse x of small integers and a gate of small integers over 4:
    every logit is an exact sum, the same in both packages in any order,
    and equal logits are common."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-2, 3, (256, 128)) * (rng.random((256, 128)) < 0.03)
         ).astype(np.float32)
    gate = rng.integers(-2, 3, (128, e)).astype(np.float32) / 4
    return x, gate


@pytest.mark.parametrize("case", ["fp32", "bf16", "ties_fp32", "ties_bf16"])
def test_route_matches_jax(case):
    """Indices bitwise, weights and aux within 1e-6, at grok's 8 experts
    top-2. The ``ties`` cases have exact equal logits in many rows (the
    test counts them); bf16 gate logits tie often on their own."""
    dtype = BF16 if case.endswith("bf16") else FP32
    jcfg, tcfg = _cfgs(dtype, n_experts=8, top_k=2)
    if case.startswith("ties"):
        x, gate = _tied_route_inputs(3)
        p = {"gate": jnp.asarray(gate)}
        logits = x @ gate
        top3 = np.sort(logits, axis=1)[:, -3:]
        # rows tied inside the top 2, or across the second place (70 of them)
        tied = int(np.sum((top3[:, 1] == top3[:, 2]) | (top3[:, 0] == top3[:, 1])))
        assert tied > 100, tied
        xj = jnp.asarray(x, jnp.float32 if dtype is FP32 else jnp.bfloat16)
        xt = torch.from_numpy(x).to(tcfg.compute_dtype)
    else:
        p, _ = _layer_pair(1, jcfg)
        xj, xt = _x(1, dtype, (256, 128))
    tp = params_from_numpy({"gate": p["gate"]}, device="cpu")
    jidx, jw, jaux = jmoe._route(p, xj, jcfg)
    tidx, tw, taux = moe._route(tp, xt, tcfg)
    assert tidx.dtype == torch.int64 and tw.dtype == tcfg.compute_dtype
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.float().numpy(), np.asarray(jw, np.float32),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t,cf", [(32, 0.05), (32, 1.25), (16384, 1.25),
                                  (1024, 1.25), (8, 1.25), (100, 3.0)])
def test_capacity_matches_jax(t, cf):
    """grok's capacities at its timed prefill (5120), prompt prefill (384)
    and decode step (128), and the least one (8)."""
    jcfg = jax_get_config(ARCH).replace(capacity_factor=cf)
    tcfg = get_config(ARCH).replace(capacity_factor=cf)
    assert moe._capacity(t, tcfg) == jmoe._capacity(t, jcfg)


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor", [CAP8_FACTOR, FULL_FACTOR], ids=["cap8", "full"])
@pytest.mark.parametrize("mode", ["einsum", "scatter"])
@pytest.mark.parametrize("dtype", [FP32, BF16], ids=["fp32", "bf16"])
def test_moe_apply_matches_jax(dtype, mode, factor):
    jcfg, tcfg = _cfgs(dtype, capacity_factor=factor, moe_dispatch=mode)
    p, tp = _layer_pair(2, jcfg)
    xj, xt = _x(4, dtype)
    t, e = 32, jcfg.n_experts
    cap = jmoe._capacity(t, jcfg)
    assert cap == moe._capacity(t, tcfg) == (8 if factor == CAP8_FACTOR else 128)
    jidx, _, _ = jmoe._route(p, xj.reshape(t, -1), jcfg)
    tidx, _, _ = moe._route(tp, xt.reshape(t, -1), tcfg)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    want_keep = _jax_keep(jidx, e, cap)
    _, keep = moe.slots(tidx, e, cap)
    assert np.array_equal(keep.numpy(), want_keep)
    dropped = int((~want_keep).sum())
    assert dropped > 0 if factor == CAP8_FACTOR else dropped == 0
    jy, jaux = jmoe.moe_apply(p, xj, jcfg)
    ty, taux = moe.moe_apply(tp, xt, tcfg)
    assert ty.dtype == tcfg.compute_dtype and ty.shape == jy.shape
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               **(FP32_TOL if dtype is FP32 else BF16_TOL))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=1e-6)
    # a dropped pair adds nothing: tokens with both choices dropped get 0
    both = want_keep.sum(1) == 0
    if both.any():
        assert not ty.reshape(t, -1)[torch.from_numpy(both)].any()


@pytest.mark.parametrize("factor", [8.0, CAP8_FACTOR])
def test_port_dispatch_modes_agree(factor):
    """The port's einsum and scatter modes agree, as
    ``tests/test_model_equivalence.py::test_moe_dispatch_modes_agree`` holds
    the reference's (its config, and the least capacity besides)."""
    cfg = ModelConfig(d_model=32, n_experts=4, top_k=2, d_ff_expert=16,
                      capacity_factor=factor, n_shared=0, **FP32)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16 if factor < 1 else 8, 32)).astype(np.float32))
    y1, a1 = moe.moe_apply(p, x, cfg.replace(moe_dispatch="einsum"))
    y2, a2 = moe.moe_apply(p, x, cfg.replace(moe_dispatch="scatter"))
    torch.testing.assert_close(y1, y2, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(a1, a2, rtol=1e-5, atol=0)


def test_moe_init_matches_the_reference_layout():
    """init_moe draws the reference's leaves (shapes, dtypes, the shared
    MLP with n_shared) at the scale of each leaf's fan-in."""
    jcfg, tcfg = _cfgs(FP32, n_shared=1)
    want = jax.eval_shape(lambda k: jmoe.init_moe(k, jcfg), jax.random.key(0))
    got = moe.init_moe(torch.Generator().manual_seed(0), tcfg)
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(jax.tree_util.tree_leaves(params_to_numpy(got)))
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
    for name, fan_in in (("gate", 128), ("wi", 128), ("wg", 128), ("wo", 64)):
        assert abs(float(got[name].std()) * fan_in ** 0.5 - 1) < 0.1, name


@pytest.mark.parametrize("mode", ["einsum", "scatter"])
def test_shared_expert_matches_jax(mode):
    jcfg, tcfg = _cfgs(FP32, n_shared=1, moe_dispatch=mode)
    p, tp = _layer_pair(7, jcfg)
    assert "shared" in tp and tp["shared"]["wi"].shape == (128, 64)
    xj, xt = _x(8, FP32)
    jy, jaux = jmoe.moe_apply(p, xj, jcfg)
    ty, taux = moe.moe_apply(tp, xt, tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FP32_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# grok-1-314b's smoke model
# ---------------------------------------------------------------------------

def _smoke_pair(seed=0, dtype=FP32, **kw):
    """(JAX model, JAX params, port model, port params) at grok's smoke size."""
    jcfg, tcfg = _cfgs(dtype, **kw)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(seed))
    return jm, jp, Model(tcfg, device="cpu"), params_from_numpy(jp, device="cpu")


@pytest.mark.parametrize("mode", ["einsum", "scatter"])
def test_grok_smoke_forward_aux_and_loss_match_jax(mode):
    jm, jp, tm, tp = _smoke_pair(0, moe_dispatch=mode)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, tm.cfg.vocab, (2, 24)).astype(np.int32)
    labels = rng.integers(-1, tm.cfg.vocab, (2, 24)).astype(np.int32)
    jh, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    th, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL_TOL)
    assert taux.shape == () and float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    batch = {"tokens": toks, "labels": labels}
    jl = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    # the aux term is in the loss: without it the loss moves by its weight
    tl0 = Model(tm.cfg.replace(aux_loss_weight=0.0), device="cpu").loss(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl - tl0), 0.01 * float(taux) / 4, rtol=1e-4)


def test_grok_smoke_decode_matches_jax_and_its_forward():
    jm, jp, tm, tp = _smoke_pair(1)
    b, s = 2, 12
    toks = np.random.default_rng(12).integers(0, tm.cfg.vocab, (b, s)).astype(np.int32)
    th, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    tl = tm.logits(tp, th).numpy()
    jcache, tcache = jm.init_cache(b, s), tm.init_cache(b, s)
    assert tcache["k"].shape == (4, b, s, 1, 32)
    jstep = jax.jit(jm.decode_step)
    for t in range(s):
        jcache, jlg = jstep(jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                            jnp.int32(t))
        tcache, tlg = tm.decode_step(tp, tcache,
                                     {"tokens": torch.from_numpy(toks[:, t:t + 1])}, t)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **MODEL_TOL)
        np.testing.assert_allclose(tlg.numpy(), tl[:, t], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]), **MODEL_TOL)


def test_grok_smoke_forward_with_drops_matches_jax():
    """The whole stack at the least capacity: 2 x 24 tokens at factor
    0.02 (int(48 * 2 / 4 * 0.02) = 0) give 8 slots an expert against a
    mean load of 24."""
    jm, jp, tm, tp = _smoke_pair(2, capacity_factor=0.02)
    toks = np.random.default_rng(13).integers(0, tm.cfg.vocab, (2, 24)).astype(np.int32)
    assert moe._capacity(48, tm.cfg) == 8
    jh, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    th, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_grok_params_round_trip_bitwise_and_layout():
    jm, jp, tm, tp = _smoke_pair(3)
    assert tp["stack"]["layers"]["moe"]["wi"].shape == (4, 4, 128, 64)
    assert "mlp" not in tp["stack"]["layers"]
    back = params_to_numpy(tp)
    flat = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        assert node.dtype == np.asarray(leaf).dtype
        np.testing.assert_array_equal(node, np.asarray(leaf))
    # Model.init draws the same tree: keys, shapes, dtypes
    want = jax.eval_shape(jm.init, jax.random.key(0))
    got = tm.init(torch.Generator().manual_seed(0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).removeprefix("torch.") == str(leaf.dtype), path


@pytest.mark.parametrize("seed", [7, 8])
def test_grok_greedy_ids_match_jax_engine(seed):
    _assert_greedy_ids_match(*_smoke_pair(0), seed)


def test_grok_prefill_step_matches_jax_forward():
    _assert_prefill_step_matches(*_smoke_pair(0))


def test_grok_loss_under_remat_backpropagates():
    """The training path's remat wraps each MoE layer with its aux output:
    the loss under grad equals the loss without, and every leaf, the gate
    and the experts among them, gets a finite gradient."""
    _, _, tm, tp = _smoke_pair(4)
    toks = np.random.default_rng(14).integers(0, tm.cfg.vocab, (2, 16)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
    with torch.no_grad():
        want = tm.loss(tp, batch)
    leaves = {k: v.requires_grad_() for k, v in tp["stack"]["layers"]["moe"].items()}
    got = tm.loss(tp, batch)
    got.backward()
    assert float(got.detach()) == float(want)
    for name, leaf in leaves.items():
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all(), name
        assert leaf.grad.abs().sum() > 0, name


# ---------------------------------------------------------------------------
# why chip_smoke's bf16 grok serve may be held by the mean logit gap
# ---------------------------------------------------------------------------

MOE_MEAN_TOL = 0.25     # chip_smoke.MOE_PREFILL_DECODE_MEAN_TOL
PREFILL_DECODE_TOL = 0.5  # chip_smoke.PREFILL_DECODE_TOL


def _prefill_vs_decode(forward_logits, decode_step, cache, toks, zero_from):
    """(largest, mean) gap between the last position's forward logits and
    the logits after stepping ``decode_step`` over ``toks``; from step
    ``zero_from`` on every cache leaf is zeroed before each step (the
    control: a decode that loses its K/V cache)."""
    for t in range(toks.shape[1]):
        if t >= zero_from:
            cache = {k: v * 0 for k, v in cache.items()}
        cache, lg = decode_step(cache, toks[:, t:t + 1], t)
    d = np.abs(np.asarray(lg, np.float32) - forward_logits)
    return float(d.max()), float(d.mean())


def test_bf16_moe_parts_at_the_largest_logit():
    """In bf16 a tiny difference upstream can swap a token's second and
    third experts, which moves its FFN output by an expert's output, not
    by rounding: the JAX package's own bf16 forward and its token-by-token
    decode part so at the largest logit, beyond chip_smoke's dense limit
    PREFILL_DECODE_TOL, where and only where their routes part, while the
    mean gap stays under MOE_MEAN_TOL in both packages and a decode that
    loses its K/V cache in its last 16 of 32 steps exceeds it.
    grok-1-314b's heads, experts and vocab padding, 2 layers as the card
    serves it, but d_model 128, expert width 2048 and vocab 4096; 2 x 32
    tokens (capacity 128: nothing dropped), JAX's routes recorded.
    Measured (seeds 0-3): JAX's largest 0.055, 0.053, 1.72, 0.34, its
    (token, layer) routes parted at 0, 0, 5, 5, its mean 0.011-0.160; the
    control's mean 1.08-1.15; the port on one CPU thread parts by at most
    0.023 here."""
    kw = dict(n_layers=2, d_model=128, vocab=4096, d_ff_expert=2048,
              param_dtype_str="bfloat16", compute_dtype_str="bfloat16")
    jm = JModel(jax_get_config(ARCH).replace(**kw))
    tm = Model(get_config(ARCH).replace(**kw), device="cpu")
    jinit, jstep = jax.jit(jm.init), jax.jit(jm.decode_step)
    s = 32
    parted = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for seed in range(4):
            jp = jinit(jax.random.key(seed))
            tp = Engine(tm, params_from_numpy(jp, device="cpu"), ServeConfig()).params
            toks = np.random.default_rng(8 + seed).integers(0, 4096, (2, s)).astype(np.int32)

            def jdec(c, tok, t, step=jstep):
                return step(jp, c, {"tokens": jnp.asarray(tok)}, jnp.int32(t))
            # traced anew (fresh functions, not jit's cache), with the recorder
            with _RouteLog() as log:
                jh, _ = jax.jit(lambda *a: jm.forward(*a))(jp, {"tokens": jnp.asarray(toks)})
                jl = np.asarray(jm.logits(jp, jh[:, -1:]).astype(jnp.float32))[:, 0]
                rec = jax.jit(lambda *a: jm.decode_step(*a))
                j_max, j_mean = _prefill_vs_decode(
                    jl, lambda c, tok, t: jdec(c, tok, t, rec), jm.init_cache(2, s), toks, s)
                jax.effects_barrier()
            j_flips = route_flips(log.idx, 2, 2, s)
            _, j_ctl = _prefill_vs_decode(jl, jdec, jm.init_cache(2, s), toks, s // 2)
            assert j_mean <= MOE_MEAN_TOL < j_ctl, (seed, j_mean, j_ctl)
            assert (j_max > PREFILL_DECODE_TOL) <= (j_flips > 0), (seed, j_max, j_flips)
            parted.append(j_max > PREFILL_DECODE_TOL)
            with torch.no_grad():
                th, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
                tl = tm.logits(tp, th[:, -1:])[:, 0].float().numpy()

                def tdec(c, tok, t):
                    c, lg = tm.decode_step(tp, c, {"tokens": torch.from_numpy(np.asarray(tok))}, t)
                    return c, lg.float()
                _, t_mean = _prefill_vs_decode(tl, tdec, tm.init_cache(2, s), toks, s)
                _, t_ctl = _prefill_vs_decode(tl, tdec, tm.init_cache(2, s), toks, s // 2)
            assert t_mean <= MOE_MEAN_TOL < t_ctl, (seed, t_mean, t_ctl)
    finally:
        torch.set_num_threads(threads)
    assert any(parted), parted


class _RouteLog:
    """Records, as numpy, the expert indices of every ``_route`` call of
    the reference's ``moe``; its calls run traced (inside ``lax.scan``), so
    an ordered callback reads them."""

    def __enter__(self):
        self.idx, self._route = [], jmoe._route

        def route(*a, **kw):
            out = self._route(*a, **kw)
            jax.debug.callback(lambda i: self.idx.append(np.asarray(i)), out[0],
                               ordered=True)
            return out
        jmoe._route = route
        return self

    def __exit__(self, *exc):
        jmoe._route = self._route


def route_flips(idx, n_layers, b, s):
    """(token, layer) pairs whose expert set differs between a forward
    (the first ``n_layers`` records, each (b * s, k)) and the ``s`` decode
    steps after it (``n_layers`` records of (b, k) a step)."""
    fwd = np.sort(np.stack(idx[:n_layers]), -1)                # (L, b*s, k)
    dec = np.stack(idx[n_layers:n_layers + n_layers * s])      # (s*L, b, k)
    dec = dec.reshape(s, n_layers, b, -1).transpose(1, 2, 0, 3).reshape(n_layers, b * s, -1)
    return int((fwd != np.sort(dec, -1)).any(-1).sum())
