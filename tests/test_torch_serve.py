"""Port of the serving entry points (``repro_torch.serve.engine``,
``repro_torch.train.train_loop.make_serve_steps``) held against the JAX
package on the CPU, at the smoke size of internlm2-1.8b (4 layers, d 128,
4 heads over 2 KV heads, d_h 32, vocab 512) with JAX's weights.

- Greedy ids, fp32 compute: bitwise equal to JAX's ``Engine``. The prompts
  are seeded, and the test asserts that JAX's top-2 logit gap is at least
  1e-3 at every generated position, 100x the 1e-5 the two packages'
  fp32 logits differ by, so no argmax sits on a tie.
- bf16 compute: decode logits within 0.125 absolute of JAX's. The logits
  are of order 4, where one bf16 ulp is 0.03125, and the packages round
  to bf16 at different places through 4 layers.
- ``prefill_step``: ``forward`` plus the last position's logits, against
  JAX's ``Model.forward`` and ``logits`` (the JAX factory needs a mesh),
  at 1e-4 in fp32.
- stablelm-12b narrowed with its head dim kept (d_head 160; 2 layers, 4
  query heads over 1 KV head, the smoke widths otherwise): greedy ids and
  ``prefill_step`` as above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduce_for_smoke as jax_reduce
from repro.models.model import Model as JModel
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train.train_loop import make_serve_steps
from test_torch_model import _narrow_pair

ARCH = "internlm2-1.8b"


def _pair(compute_dtype):
    kw = dict(param_dtype_str="float32", compute_dtype_str=compute_dtype)
    jm = JModel(jax_reduce(jax_get_config(ARCH)).replace(**kw))
    jp = jm.init(jax.random.key(0))
    tm = Model(reduce_for_smoke(get_config(ARCH)).replace(**kw), device="cpu")
    return jm, jp, tm, params_from_numpy(jp, device="cpu")


def _assert_greedy_ids_match(jm, jp, tm, tp, seed):
    prompts = np.random.default_rng(seed).integers(
        0, tm.cfg.vocab, (2, 6)).astype(np.int32)
    new = 8
    want = JEngine(jm, jp, JServeConfig(max_new_tokens=new, max_seq=16)
                   ).generate(prompts)
    got = Engine(tm, tp, ServeConfig(max_new_tokens=new, max_seq=16)
                 ).generate(prompts)
    seq = np.concatenate([prompts, want], axis=1)
    hidden, _ = jm.forward(jp, {"tokens": jnp.asarray(seq)})
    lg = np.asarray(jm.logits(jp, hidden))[:, prompts.shape[1] - 1:-1]
    top2 = np.sort(lg, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() >= 1e-3
    assert got.dtype == np.int32 and got.shape == (2, new)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [7, 8])
def test_greedy_ids_match_jax_engine(seed):
    _assert_greedy_ids_match(*_pair("float32"), seed)


@pytest.mark.parametrize("seed", [7, 8])
def test_greedy_ids_match_jax_engine_d160(seed):
    _assert_greedy_ids_match(*_narrow_pair(), seed)


def test_bf16_decode_logits_match_jax():
    jm, jp, tm, tp = _pair("bfloat16")
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab, (2, 12)).astype(np.int32)
    jcache, tcache = jm.init_cache(2, 12), tm.init_cache(2, 12)
    assert tcache["k"].dtype == torch.bfloat16
    jstep = jax.jit(jm.decode_step)
    for t in range(12):
        jcache, jlg = jstep(jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                            jnp.int32(t))
        tcache, tlg = tm.decode_step(
            tp, tcache, {"tokens": torch.from_numpy(toks[:, t:t + 1])}, t)
        assert tlg.dtype == torch.bfloat16
        np.testing.assert_allclose(tlg.float().numpy(),
                                   np.asarray(jlg, np.float32), rtol=0,
                                   atol=0.125)


def test_prefill_step_matches_jax_forward():
    _assert_prefill_step_matches(*_pair("float32"))


def test_prefill_step_matches_jax_forward_d160():
    _assert_prefill_step_matches(*_narrow_pair())


def _assert_prefill_step_matches(jm, jp, tm, tp):
    toks = np.random.default_rng(6).integers(0, tm.cfg.vocab, (3, 10)).astype(np.int32)
    hidden, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    want = np.asarray(jm.logits(jp, hidden[:, -1:, :]))[:, 0]
    prefill_step, decode_step = make_serve_steps(tm)
    got = prefill_step(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (3, tm.cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # decode_step is the model's; stepping it over the prompt ends on the
    # same last-position logits.
    cache = tm.init_cache(3, 10)
    for t in range(10):
        cache, lg = decode_step(tp, cache,
                                {"tokens": torch.from_numpy(toks[:, t:t + 1])}, t)
    np.testing.assert_allclose(lg.numpy(), got.numpy(), rtol=2e-3, atol=2e-3)


def test_engine_refuses_what_it_does_not_serve():
    _, _, tm, tp = _pair("float32")
    prompts = np.zeros((1, 4), np.int32)
    with pytest.raises(NotImplementedError, match="enc-dec"):
        Engine(tm, tp, ServeConfig()).generate(prompts, enc_embeds=np.zeros(3))
    with pytest.raises(ValueError, match="max_seq"):
        Engine(tm, tp, ServeConfig(max_new_tokens=8, max_seq=10)).generate(prompts)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    cfg = reduce_for_smoke(get_config(ARCH))
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
