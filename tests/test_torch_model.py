"""Port of the LM serving path (``repro_torch.models``, ``configs`` and the
flash_attention plain version) held against the JAX package on the CPU.

Inputs come from ``np.random.default_rng``; JAX weights from
``Model(cfg).init(jax.random.key(0))`` reach the port through
``params_from_numpy``. The JAX Pallas kernel runs in interpret mode, as the
JAX package's own tests run it. Tolerances, each with its reason:

- attention in fp32, 2e-5 (as ``tests/test_kernels.py``): the same online
  softmax, summed in another order;
- attention in bf16, 3e-2 (as ``tests/test_kernels.py``): the JAX jnp
  chunked path keeps its accumulator in bf16 (``attention.py:98``) while
  the Pallas kernel and the port keep it in fp32;
- layers in fp32, 1e-5: XLA's and torch's ``pow``/``sin``/``cos``/``rsqrt``
  may differ by an ulp, so rope and the norm are not bitwise;
- the model in fp32, 1e-4 against JAX (the ulps above through 4 layers),
  and the port's decode against its own forward at 2e-3, as
  ``tests/test_model_equivalence.py`` holds the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.kernels.flash_attention.ops import flash_attention_pallas
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     flash_decode_split_ref)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model

ARCHS = ["internlm2-1.8b", "qwen3-14b",      # qwen3: the qk_norm branch
         "deepseek-7b", "stablelm-12b"]     # deepseek: MHA (G 1 at smoke size)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _qkv(seed, b, sq, skv, h, kv, dh):
    rng = np.random.default_rng(seed)
    return (_normal(rng, b, sq, h, dh), _normal(rng, b, skv, kv, dh),
            _normal(rng, b, skv, kv, dh))


def _port_flash(q, k, v, dtype=torch.float32, **kw):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    return tattn.flash_attention(*t, **kw).to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,kv,dh,bq,bk,causal", [
    (2, 256, 8, 2, 32, 64, 128, True),     # GQA group 4
    (1, 384, 4, 1, 64, 128, 128, False),   # MQA, bidirectional
    (1, 256, 16, 8, 128, 128, 128, True),  # serve heads: the sm90 kernel's oracle
    (1, 256, 4, 1, 160, 128, 128, True),   # stablelm-12b's head dim
    (1, 256, 8, 2, 160, 64, 64, False),    # d 160, bidirectional, G 4
])
def test_plain_flash_matches_pallas_interpret(b, s, h, kv, dh, bq, bk, causal):
    q, k, v = _qkv(s + h, b, s, s, h, kv, dh)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, block_q=bq,
                                  block_k=bk, interpret=True)
    got = _port_flash(q, k, v, causal=causal, chunk_kv=64)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_plain_flash_q_offset_matches_pallas_interpret():
    """A 128-row q block at offset 128 attends only to k[:128 + row]."""
    q, k, v = _qkv(11, 1, 128, 256, 2, 2, 32)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, q_offset=128,
                                  interpret=True)
    got = _port_flash(q, k, v, causal=True, q_offset=128, chunk_kv=64)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_jax_flash_and_naive(causal):
    q, k, v = _qkv(0, 2, 256, 256, 8, 2, 32)
    got = _port_flash(q, k, v, causal=causal, chunk_kv=64)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want in (jattn.flash_attention(jq, jk, jv, causal=causal, chunk_kv=64),
                 jattn.naive_attention(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    naive = tattn.naive_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal).numpy()
    np.testing.assert_allclose(naive, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_plain_flash_decode_row_at_offset():
    """Sq == 1 at position 77 equals row 77 of full causal attention (the
    JAX package computes decode with naive_attention)."""
    q, k, v = _qkv(1, 2, 128, 128, 4, 4, 16)
    p = 77
    got = _port_flash(q[:, p:p + 1], k, v, causal=True, q_offset=p,
                      chunk_kv=32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    one = jattn.flash_attention(jq[:, p:p + 1], jk, jv, causal=True,
                                q_offset=p, chunk_kv=32)
    full = jattn.naive_attention(jq, jk, jv, causal=True)
    np.testing.assert_allclose(got, np.asarray(one), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[:, 0], np.asarray(full[:, p]), rtol=2e-5,
                               atol=2e-5)


def test_plain_flash_bf16():
    q, k, v = _qkv(9, 1, 256, 256, 4, 4, 64)
    got = _port_flash(q, k, v, torch.bfloat16, causal=True, chunk_kv=64)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, interpret=True)
    chunked = jattn.flash_attention(jq, jk, jv, causal=True, chunk_kv=64)
    exact = jattn.naive_attention(*(x.astype(jnp.float32) for x in (jq, jk, jv)),
                                  causal=True)
    for want in (pallas, chunked, exact):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=3e-2, atol=3e-2)


DECODE_OFFSETS = (0, 1, 23, 191, 255)     # over a 256-slot cache


@pytest.mark.parametrize("n_split", [1, 2, 3, 8])
@pytest.mark.parametrize("g", [1, 2, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_ref_matches_flash_ref_and_jax_naive(n_split, g, dtype):
    """The decode kernel's plain version (key splits, each an online
    softmax over 32-key tiles, merged in rank order) against the chunked
    plain version and the JAX package's naive_attention (its decode path),
    at each position of a 256-slot cache. fp32 to 2e-5 against both; bf16
    to 1e-2 against the chunked version (the kernels' tolerance) and 3e-2
    against exact attention of the same bf16 values."""
    kv, dh = 2, 64
    q, k, v = _qkv(10 * g + n_split, 2, 1, 256, kv * g, kv, dh)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x.float().numpy()) for x in (tq, tk, tv))
    tol_ref, tol_jax = (2e-5, 2e-5) if dtype == torch.float32 else (1e-2, 3e-2)
    for off in DECODE_OFFSETS:
        got = flash_decode_split_ref(tq, tk, tv, causal=True, q_offset=off,
                                     n_split=n_split)
        assert got.dtype == dtype and got.shape == (2, 1, kv * g, dh)
        want = flash_attention_ref(tq, tk, tv, causal=True, q_offset=off)
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   rtol=tol_ref, atol=tol_ref)
        naive = jattn.naive_attention(jq, jk, jv, causal=True, q_offset=off)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(naive),
                                   rtol=tol_jax, atol=tol_jax)


@pytest.mark.parametrize("n_split", [1, 3, 8])
def test_decode_split_ref_without_causal_mask(n_split):
    """Non-causal decode reads every key, however q_offset is set."""
    q, k, v = _qkv(3, 2, 1, 77, 8, 2, 32)
    got = flash_decode_split_ref(*map(torch.from_numpy, (q, k, v)),
                                 causal=False, q_offset=5, n_split=n_split)
    want = jattn.naive_attention(*map(jnp.asarray, (q, k, v)), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("n_split", [1, 3, 4, 6, 7, 8])
def test_decode_split_ref_at_d160_matches_jax_naive(n_split):
    """stablelm-12b's head dim (d 160, GQA group 4) through the decode
    kernel's plain version, at splits that do and do not divide the 80
    column pairs, against the JAX package's naive_attention at each
    position of a 256-slot cache: fp32 to 2e-5, bf16 to 3e-2 (exact
    attention of the same bf16 values, as above)."""
    q, k, v = _qkv(160 + n_split, 2, 1, 256, 8, 2, 160)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
        jq, jk, jv = (jnp.asarray(x.float().numpy()) for x in (tq, tk, tv))
        for off in DECODE_OFFSETS:
            got = flash_decode_split_ref(tq, tk, tv, causal=True, q_offset=off,
                                         n_split=n_split)
            assert got.dtype == dtype and got.shape == (2, 1, 8, 160)
            naive = jattn.naive_attention(jq, jk, jv, causal=True, q_offset=off)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(naive),
                                       rtol=tol, atol=tol)


def test_decode_split_ref_refuses_more_than_one_row():
    q, k, v = map(torch.from_numpy, _qkv(4, 1, 2, 16, 2, 2, 32))
    with pytest.raises(ValueError, match="Sq == 1"):
        flash_decode_split_ref(q, k, v, causal=True, q_offset=3, n_split=2)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(2)
    x, scale = _normal(rng, 2, 7, 128), _normal(rng, 128)
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("start", [0, 4000])
def test_apply_rope_matches_jax(start):
    rng = np.random.default_rng(3)
    x = _normal(rng, 2, 64, 4, 128)
    pos = np.broadcast_to(np.arange(start, start + 64, dtype=np.int32),
                          (2, 64)).copy()
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_mlp_and_embed_match_jax():
    jp = jlayers.init_mlp(jax.random.key(4), 64, 160, jnp.float32)
    emb = jlayers.init_embed(jax.random.key(5), 512, 64, jnp.float32)
    rng = np.random.default_rng(4)
    x = _normal(rng, 2, 5, 64)
    got = tlayers.mlp_apply(params_from_numpy(jp, device="cpu"),
                            torch.from_numpy(x), torch.float32)
    want = jlayers.mlp_apply(jp, jnp.asarray(x), jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    toks = rng.integers(0, 512, (2, 9)).astype(np.int32)
    got = tlayers.embed_apply(params_from_numpy(emb, device="cpu"),
                              torch.from_numpy(toks), torch.float32)
    want = jlayers.embed_apply(emb, jnp.asarray(toks), jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _smoke_pair(arch):
    """(JAX model, JAX params, port model, port params), fp32 smoke size."""
    kw = dict(param_dtype_str="float32", compute_dtype_str="float32")
    jm = JModel(jax_reduce(jax_get_config(arch)).replace(**kw))
    jp = jm.init(jax.random.key(0))
    tm = Model(reduce_for_smoke(get_config(arch)).replace(**kw), device="cpu")
    return jm, jp, tm, params_from_numpy(jp, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_match_jax(arch):
    jm, jp, tm, tp = _smoke_pair(arch)
    assert (tm.cfg.n_layers, tm.cfg.d_model, tm.cfg.n_heads, tm.cfg.d_head,
            tm.cfg.vocab) == (4, 128, 4, 32, 512)
    b, s = 2, 12
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab, (b, s)).astype(np.int32)
    jh, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    jl = np.asarray(jm.logits(jp, jh))
    th, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    tl = tm.logits(tp, th).numpy()
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)

    jcache, tcache = jm.init_cache(b, s), tm.init_cache(b, s)
    jstep = jax.jit(jm.decode_step)
    for t in range(s):
        jcache, jlg = jstep(jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                            jnp.int32(t))
        tcache, tlg = tm.decode_step(tp, tcache,
                                     {"tokens": torch.from_numpy(toks[:, t:t + 1])}, t)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(tlg.numpy(), tl[:, t], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-4, atol=1e-4)


def _narrow_pair():
    """stablelm-12b's smoke config with its own head dim kept (the smoke
    rule sets d_head 32): d_head 160, 2 layers, 4 query heads over 1 KV
    head; (JAX model, JAX params, port model, port params), fp32."""
    kw = dict(param_dtype_str="float32", compute_dtype_str="float32",
              n_layers=2, n_heads=4, n_kv=1, d_head=160)
    jm = JModel(jax_reduce(jax_get_config("stablelm-12b")).replace(**kw))
    jp = jm.init(jax.random.key(3))
    tm = Model(reduce_for_smoke(get_config("stablelm-12b")).replace(**kw),
               device="cpu")
    return jm, jp, tm, params_from_numpy(jp, device="cpu")


def test_narrow_d160_forward_and_decode_match_jax():
    """stablelm-12b's attention at its real head dim, d 160, through the
    model: forward and cached decode against JAX's Model at 1e-4, decode
    against the port's own forward at 2e-3 (as above)."""
    jm, jp, tm, tp = _narrow_pair()
    assert (tm.cfg.n_layers, tm.cfg.n_heads, tm.cfg.n_kv, tm.cfg.d_head) == (2, 4, 1, 160)
    assert tp["stack"]["layers"]["attn"]["wq"].shape == (2, 128, 4 * 160)
    b, s = 2, 12
    toks = np.random.default_rng(12).integers(0, tm.cfg.vocab, (b, s)).astype(np.int32)
    jh, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    jl = np.asarray(jm.logits(jp, jh))
    th, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    tl = tm.logits(tp, th).numpy()
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    jcache, tcache = jm.init_cache(b, s), tm.init_cache(b, s)
    assert tcache["k"].shape == (2, b, s, 1, 160)
    jstep = jax.jit(jm.decode_step)
    for t in range(s):
        jcache, jlg = jstep(jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                            jnp.int32(t))
        tcache, tlg = tm.decode_step(tp, tcache,
                                     {"tokens": torch.from_numpy(toks[:, t:t + 1])}, t)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(tlg.numpy(), tl[:, t], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["stablelm-12b", "deepseek-7b", "grok-1-314b"])
def test_new_configs_equal_the_reference(arch):
    """Every field the port's ModelConfig has equals the reference's, for
    the full config and for its smoke reduction."""
    import dataclasses
    names = [f.name for f in dataclasses.fields(get_config(arch))]
    for got, want in ((get_config(arch), jax_get_config(arch)),
                      (reduce_for_smoke(get_config(arch)),
                       jax_reduce(jax_get_config(arch)))):
        assert {n: getattr(got, n) for n in names} == \
            {n: getattr(want, n) for n in names}
        assert got.vocab_padded == want.vocab_padded
    assert get_config(arch).family == ("moe" if arch == "grok-1-314b" else "dense")


def test_init_tree_matches_jax_layout():
    """Model.init draws the JAX package's tree: same keys, shapes, dtypes."""
    cfg = reduce_for_smoke(get_config("qwen3-14b"))
    jm = JModel(jax_reduce(jax_get_config("qwen3-14b")))
    want = jax.eval_shape(jm.init, jax.random.key(0))
    got = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))

    def walk(g, w, path=""):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), path
            for key in w:
                walk(g[key], w[key], f"{path}/{key}")
        else:
            assert tuple(g.shape) == tuple(w.shape), path
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
    walk(got, want)
    again = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert torch.equal(got["out"], again["out"])


def test_params_round_trip_bitwise():
    jm = JModel(jax_reduce(jax_get_config("internlm2-1.8b")))
    jp = jm.init(jax.random.key(1))
    back = params_to_numpy(params_from_numpy(jp, device="cpu"))
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        node = back
        for key in path:
            node = node[key.key]
        assert node.dtype == np.asarray(leaf).dtype
        np.testing.assert_array_equal(node, np.asarray(leaf))
    # bf16 leaves, as JAX hands them out, are read bit for bit.
    w = jnp.asarray(jp["out"], jnp.bfloat16)
    t = params_from_numpy({"w": w}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(params_to_numpy({"w": t})["w"],
                                  np.asarray(w, np.float32))


def test_params_round_trip_bitwise_d160():
    """stablelm-12b's narrow tree at d_head 160 (wq (L, d, H*160), wk and
    wv (L, d, KV*160)) goes into the port and back bit for bit."""
    _, jp, _, tp = _narrow_pair()
    assert tp["stack"]["layers"]["attn"]["wk"].shape == (2, 128, 160)
    back = params_to_numpy(tp)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = back
        for key in path:
            node = node[key.key]
        assert node.dtype == np.asarray(leaf).dtype
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_unported_configs_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("seamless-m4t-large-v2")
    with pytest.raises(NotImplementedError, match="10.3"):
        get_config("qwen2-vl-72b")
    cfg = reduce_for_smoke(get_config("internlm2-1.8b"))
    mamba = reduce_for_smoke(get_config("falcon-mamba-7b"))
    grok = reduce_for_smoke(get_config("grok-1-314b"))
    for bad in (cfg.replace(mrope=True), cfg.replace(family="moe"),
                cfg.replace(family="encdec"), mamba.replace(ssm_version=2),
                grok.replace(moe_group_tokens=64), cfg.replace(mla=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Model(bad, device="cpu")
    for bad, what in ((cfg.replace(mla=True), "MLA"),
                      (grok.replace(moe_group_tokens=64), "grouped")):
        with pytest.raises(NotImplementedError, match=what):
            Model(bad, device="cpu")
    # MLA and leading dense layers are the moe family's since deepseek-v2
    Model(grok, device="cpu")
    Model(grok.replace(first_dense=1), device="cpu")
    Model(reduce_for_smoke(get_config("deepseek-v2-236b")), device="cpu")
