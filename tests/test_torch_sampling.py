"""Temperature sampling: the port's threefry at 8 and 16 bits, its bf16
uniforms and gumbels, ``categorical``, and the sampled ``Engine`` held
against ``jax.random`` and JAX's ``Engine`` on the CPU.

Policy, each with its reason:

- 8- and 16-bit bits and bf16 uniforms bitwise (the same integer recipe;
  bf16 rounds each op, as torch's bf16 ops do);
- bf16 gumbels bitwise over 2^20 draws (each ``log`` is rounded to bf16,
  and no float32 ``log`` within a few ulps can move a bf16 rounding: the
  margin is checked below);
- ``categorical``: in fp32 ids equal wherever JAX's perturbed top-2 gap
  (gumbel plus logits) exceeds 1e-5 (the float32 gumbels differ by the
  ulps of ``log``, at most 9.54e-7), with at least 95 % of the rows so
  checked; in bf16 every row equal (bitwise gumbels), which holds more
  than the rows whose gap exceeds 2 bf16 ulps;
- the sampled ``Engine`` (fp32, smoke internlm2-1.8b and falcon-mamba-7b)
  along one sequence: JAX's engine steps its decode over the port's ids
  (teacher forcing, as ``serve_lm.compare`` holds the examples) and
  samples with its own ``_sample`` at every step; the ids equal wherever
  JAX's perturbed top-2 gap exceeds 1e-5.
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
from repro_torch.core import threefry as tf
from repro_torch.models.model import Model
from repro_torch.serve.engine import Engine, ServeConfig

BF16_TINY = float(jnp.finfo(jnp.bfloat16).tiny)
N_DRAWS = 1 << 20


@pytest.fixture(scope="module", autouse=True)
def warm_vector_math():
    """One large float32 ``log`` on the CPU before the module's tests, as
    ``tests/test_torch_threefry.py`` makes it: in a process that has run
    XLA, torch's first parallel transcendental op on the CPU can return
    other bits on part of its output (ROADMAP Queue 3)."""
    torch.log(torch.rand(1 << 20, generator=torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("width,dtype", [(16, jnp.uint16), (8, jnp.uint8)])
@pytest.mark.parametrize("shape", [(1,), (6, 3), (64, 128, 3)])
def test_narrow_bits_match_jax(width, dtype, shape):
    want = np.asarray(jax.random.bits(jax.random.key(11), shape, dtype))
    got = tf.random_bits(tf.key(11), shape, device="cpu", width=width)
    assert got.shape == shape and int(got.max()) < 1 << width
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_narrow_bits_are_the_low_bits_of_the_word():
    """Partitionable threefry draws one 32-bit word an element whatever the
    width: the 16-bit draw is that word's low half."""
    k = tf.fold_in(tf.key(0), 3)
    word = tf.random_bits(k, (4096,), device="cpu")
    half = tf.random_bits(k, (4096,), device="cpu", width=16)
    assert torch.equal(half, word & 0xFFFF)
    with pytest.raises(ValueError, match="width"):
        tf.random_bits(k, (2,), device="cpu", width=64)


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (BF16_TINY, 1.0), (-2.0, 3.0),
                                    (0.1, 0.7), (-1.3, 1e4)])
def test_bf16_uniform_bitwise(bounds):
    lo, hi = bounds
    want = np.asarray(jax.random.uniform(jax.random.key(5), (N_DRAWS,),
                                         jnp.bfloat16, lo, hi))
    got = tf.uniform(tf.key(5), (N_DRAWS,), lo, hi, device="cpu",
                     dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("bounds,apart", [((-2.0, 3.0), 254295), ((0.1, 0.7), 196702),
                                          ((-1.3, 1e4), 65557)])
def test_bf16_uniform_rounds_each_op(bounds, apart):
    """Why the bf16 scale and shift round twice: computed in float32 and
    rounded once, ``apart`` of these 2^20 draws land elsewhere than JAX's."""
    lo, hi = bounds
    want = np.asarray(jax.random.uniform(jax.random.key(5), (N_DRAWS,),
                                         jnp.bfloat16, lo, hi)).astype(np.float32)
    bits = tf.random_bits(tf.key(5), (N_DRAWS,), device="cpu", width=8)
    f = ((bits >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16) - 1.0
    lo_b, hi_b = (torch.tensor(v, dtype=torch.bfloat16) for v in bounds)
    once = ((f.float() * float(hi_b - lo_b) + float(lo_b)).to(torch.bfloat16)
            .clamp_min(float(lo_b)).float().numpy())
    assert int((once != want).sum()) == apart


@pytest.mark.parametrize("seed", [9, 42])
def test_bf16_gumbel_bitwise(seed):
    """Over 2^20 draws, 0 differ; rounding once at the end instead of after
    each ``log``, 45 % would."""
    want = np.asarray(jax.random.gumbel(jax.random.key(seed), (N_DRAWS,),
                                        jnp.bfloat16))
    got = tf.gumbel(tf.key(seed), (N_DRAWS,), device="cpu", dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert int((got.view(torch.int16).numpy() != want.view(np.int16)).sum()) == 0
    u = tf.uniform(tf.key(seed), (N_DRAWS,), BF16_TINY, 1.0, device="cpu",
                   dtype=torch.bfloat16)
    once = (-torch.log(-torch.log(u.float()))).to(torch.bfloat16)
    apart = int((once.view(torch.int16).numpy() != want.view(np.int16)).sum())
    assert 0.4 * N_DRAWS < apart < 0.5 * N_DRAWS


def test_bf16_gumbel_is_the_same_on_any_accurate_log():
    """All 128 bf16 uniforms: each ``log`` on the way lies at least 2e-6
    (relative) from a bf16 rounding midpoint, 8 float32 ulps and more, so a
    float32 ``log`` within a few ulps (torch's on the CPU or the card,
    XLA's) rounds as a float64 one does."""
    u = torch.tensor([max(i / 128, BF16_TINY) for i in range(128)],
                     dtype=torch.float64)

    def margin(x):
        ulp = 2.0 ** (torch.floor(torch.log2(x.abs())) - 7)
        frac = (x.abs() / ulp) % 1.0
        return float(((frac - 0.5).abs() * ulp / x.abs()).min())
    inner = torch.log(u)
    outer = torch.log(-inner.to(torch.bfloat16).double())
    assert margin(inner) > 8 * 2.0 ** -23
    assert margin(outer[outer != 0]) > 8 * 2.0 ** -24
    g64 = -outer.to(torch.bfloat16)
    g32 = -torch.log(-torch.log(u.float()).to(torch.bfloat16).float()).to(torch.bfloat16)
    assert torch.equal(g64, g32)


def _perturbed_gap(key, logits):
    """JAX's gumbel plus the logits, and the gap of its two largest."""
    p = np.asarray((jax.random.gumbel(key, logits.shape, logits.dtype) + logits)
                   .astype(jnp.float32))
    top2 = np.sort(p, -1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_categorical_matches_jax_fp32(seed):
    """Ids equal wherever JAX's perturbed top-2 gap exceeds 1e-5, on at
    least 95 % of the rows."""
    rng = np.random.default_rng(seed)
    logits = jnp.asarray(rng.standard_normal((256, 1000)).astype(np.float32) * 3)
    key = jax.random.fold_in(jax.random.key(seed), 5)
    want = np.asarray(jax.random.categorical(key, logits))
    got = tf.categorical(tf.fold_in(tf.key(seed), 5),
                         torch.from_numpy(np.array(logits)))
    assert got.dtype == torch.int32 and got.shape == (256,)
    held = _perturbed_gap(key, logits) > 1e-5
    assert held.mean() >= 0.95
    np.testing.assert_array_equal(got.numpy()[held], want[held])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_categorical_matches_jax_bf16(seed):
    """In bf16 the gumbels are bitwise and the sum rounds as XLA's does, so
    every row is equal, the rows within 2 bf16 ulps of a tie (15 % of
    these: 128 gumbel values over bf16 logits) included."""
    rng = np.random.default_rng(seed)
    logits = jnp.asarray(rng.standard_normal((256, 1000)).astype(np.float32) * 3,
                         jnp.bfloat16)
    key = jax.random.fold_in(jax.random.key(seed), 5)
    want = np.asarray(jax.random.categorical(key, logits))
    tl = torch.from_numpy(np.array(logits.astype(jnp.float32))).to(torch.bfloat16)
    got = tf.categorical(tf.fold_in(tf.key(seed), 5), tl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_ties_pick_the_first_index():
    """Equal perturbed values: the first index, as ``jnp.argmax``."""
    logits = torch.full((4, 8), -1e9, dtype=torch.bfloat16)
    logits[:, 3] = 0
    got = tf.categorical(tf.key(0), logits)
    assert got.tolist() == [3, 3, 3, 3]
    flat = torch.zeros((1, 2), dtype=torch.bfloat16)
    k = tf.key(0)
    g = tf.gumbel(k, (1, 2), device="cpu", dtype=torch.bfloat16)
    assert tf.categorical(k, flat).item() == int(torch.argmax(g))


def _pair(arch, seed=0):
    kw = dict(param_dtype_str="float32", compute_dtype_str="float32")
    jm = JModel(jax_reduce(jax_get_config(arch)).replace(**kw))
    jp = jm.init(jax.random.key(seed))
    tm = Model(reduce_for_smoke(get_config(arch)).replace(**kw), device="cpu")
    return jm, jp, tm, params_from_numpy(jp, device="cpu")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "falcon-mamba-7b"])
@pytest.mark.parametrize("seed", [0, 3])
def test_sampled_engine_matches_jax_along_one_sequence(arch, seed):
    jm, jp, tm, tp = _pair(arch)
    prompts = np.random.default_rng(seed + 20).integers(
        0, tm.cfg.vocab, (4, 6)).astype(np.int32)
    scfg = dict(max_new_tokens=12, max_seq=24, temperature=0.7, seed=seed)
    got = Engine(tm, tp, ServeConfig(**scfg)).generate(prompts)
    assert got.dtype == np.int32 and got.shape == (4, 12)
    # JAX's engine stepped over the port's ids, sampling at every step.
    je = JEngine(jm, jp, JServeConfig(**scfg))
    cache = jm.init_cache(4, scfg["max_seq"])
    for t in range(prompts.shape[1]):
        cache, logits = je._decode(jp, cache, {"tokens": jnp.asarray(prompts[:, t:t + 1])},
                                   jnp.int32(t))
    key = jax.random.key(seed)
    held = 0
    for i in range(scfg["max_new_tokens"]):
        want = np.asarray(je._sample(logits, key, i))
        gap = _perturbed_gap(jax.random.fold_in(key, i), logits / scfg["temperature"])
        ok = gap > 1e-5
        held += int(ok.sum())
        np.testing.assert_array_equal(got[ok, i], want[ok], err_msg=f"step {i}")
        cache, logits = je._decode(jp, cache, {"tokens": jnp.asarray(got[:, i:i + 1])},
                                   jnp.int32(prompts.shape[1] + i))
    assert held >= 0.95 * got.size
    # The seed decides the draw: the same seed repeats, another one differs.
    again = Engine(tm, tp, ServeConfig(**scfg)).generate(prompts)
    other = Engine(tm, tp, ServeConfig(**dict(scfg, seed=seed + 1))).generate(prompts)
    np.testing.assert_array_equal(again, got)
    assert (other != got).any()


def test_sampling_divides_by_the_temperature_in_the_logits_dtype():
    """bf16 logits divided by bf16(0.7) = 0.69921875, as JAX's eager
    ``logits / 0.7``; a float32 0.7 moves some of them."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal((8, 4096)) * 4,
                    jnp.bfloat16)
    want = np.asarray((x / 0.7).astype(jnp.float32))
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    got = tx / torch.full((), 0.7, dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert ((tx / 0.7).float().numpy() != want).any()
