"""The port's threefry2x32 (``repro_torch.core.threefry``) held against
``jax.random`` under its defaults (impl ``threefry2x32``, partitionable
counters, 32-bit seeds): keys, splits, folds, 32-bit bits and uniforms bit
for bit, gumbels to the ulps of ``log``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import threefry as tf


@pytest.fixture(scope="module", autouse=True)
def warm_vector_math():
    """One large float32 ``log`` on the CPU before the module's tests. In a
    process that has already run XLA, the first parallel transcendental op
    torch runs on the CPU can return other bits on part of its output (up to
    1e-4 off in ``log``; any later call, of any such op, is stable), as if
    the vector-math dispatch were still being set up on some threads. The
    gumbel comparison below would otherwise hold that first call, not the
    port, to JAX."""
    torch.log(torch.rand(1 << 20, generator=torch.Generator().manual_seed(0)))


def _words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k))


def test_defaults_are_the_ones_ported():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**32 + 5, -1])
def test_key_matches_jax(seed):
    want = _words(jax.random.key(seed))
    got = tf.key(seed)
    assert isinstance(got, tuple) and all(type(w) is int for w in got)
    np.testing.assert_array_equal(convert.key_to_numpy(got), want)


@pytest.mark.parametrize("n", [2, 7])
def test_split_matches_jax(n):
    k = jax.random.key(42)
    got = tf.split(convert.key_from_numpy(_words(k)), n)
    assert len(got) == n
    np.testing.assert_array_equal(np.array(got, np.uint32),
                                  _words(jax.random.split(k, n)))


@pytest.mark.parametrize("data", [0, 1, 2**31, 2**32 - 1])
def test_fold_in_matches_jax(data):
    k = jax.random.key(7)
    want = _words(jax.random.fold_in(k, data))
    np.testing.assert_array_equal(convert.key_to_numpy(tf.fold_in(tf.key(7), data)),
                                  want)
    # the batch form over a tensor of data gives the same words
    batch = tf.fold_in(tf.key(7), torch.tensor([data, 0], dtype=torch.int64))
    np.testing.assert_array_equal(convert.key_to_numpy(batch)[0], want)


def test_fold_in_batch_matches_vmapped_jax():
    k = jax.random.key(3)
    want = _words(jax.vmap(jax.random.fold_in, (None, 0))(k, jnp.arange(64)))
    got = tf.fold_in(tf.key(3), torch.arange(64))
    assert got.shape == (64, 2) and got.dtype == torch.int64
    np.testing.assert_array_equal(convert.key_to_numpy(got), want)


@pytest.mark.parametrize("shape", [(1,), (6, 3), (64, 128, 3), (5, 0)])
def test_random_bits_match_jax(shape):
    k = jax.random.key(11)
    want = np.asarray(jax.random.bits(k, shape))
    got = tf.random_bits(tf.key(11), shape, device="cpu")
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_random_bits_of_a_key_batch_match_vmapped_jax():
    keys = jax.random.split(jax.random.key(5), 9)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (4, 3)))(keys))
    got = tf.random_bits(convert.key_from_numpy(_words(keys), "cpu"), (4, 3))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0),
                                    (-3.7, 11.1), (0.3, 0.7), (-100.0, -1.0)])
def test_uniform_bitwise(bounds):
    """Bitwise at the default bounds, the gumbel's and three others, where
    JAX's fused scale-and-shift rounds once."""
    lo, hi = bounds
    k = jax.random.key(2)
    want = np.asarray(jax.random.uniform(k, (64, 128, 3), minval=lo, maxval=hi))
    got = tf.uniform(tf.key(2), (64, 128, 3), lo, hi, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_gumbel_within_ulps_of_log():
    """torch's ``log`` and XLA's differ by a few ulps: over these 2^20
    draws 239,131 gumbels differ, by 9.54e-7 at most (measured on the CPU
    against jax 0.9.0). The uniforms under them are bitwise equal."""
    k = jax.random.key(42)
    want = np.asarray(jax.random.gumbel(k, (1 << 20,)))
    got = tf.gumbel(tf.key(42), (1 << 20,), device="cpu").numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_key_custody_is_host_work():
    """One key stays two Python ints through key, split and fold_in: a
    session's split per query touches no device."""
    k = tf.key(9)
    a, b = tf.split(k)
    c = tf.fold_in(b, 3)
    for w in (*a, *b, *c):
        assert type(w) is int and 0 <= w < 2**32


def test_key_batch_shape_is_checked():
    with pytest.raises(ValueError, match=r"\(\.\.\., 2\)"):
        tf.random_bits(torch.zeros(3, dtype=torch.int64), (2,))


@pytest.mark.parametrize("bounds,apart", [((-3.7, 11.1), 11470), ((0.3, 0.7), 5205),
                                          ((-100.0, -1.0), 7599)])
def test_uniform_rounds_scale_and_shift_once(bounds, apart):
    """Why ``uniform`` rounds its scale and shift once: XLA fuses them into
    one multiply-add, and two float32 ops (each rounded) land elsewhere in
    ``apart`` of these 24,576 draws, while the port's draws equal JAX's."""
    lo, hi = (np.float32(b) for b in bounds)
    k = jax.random.key(2)
    want = np.asarray(jax.random.uniform(k, (64, 128, 3), minval=lo, maxval=hi))
    bits = tf.random_bits(tf.key(2), (64, 128, 3), device="cpu")
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    two_ops = (f * float(hi - lo) + float(lo)).clamp_min(float(lo)).numpy()
    assert int((two_ops.view(np.int32) != want.view(np.int32)).sum()) == apart
    got = tf.uniform(tf.key(2), (64, 128, 3), *bounds, device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
