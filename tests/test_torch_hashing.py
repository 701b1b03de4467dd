"""Port of H_i / H_t hashing (``repro_torch.core.hashing`` and the ``hash64``
kernel wrapper) held bitwise against the JAX package and the pure-Python
xxHash64 oracle. On the CPU the wrapper runs the plain limb version; the
kernel itself is tested on the card in ``test_torch_kernels_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro_torch.core import hashing as th
from repro_torch.kernels.hash64 import ops as hops
from repro_torch.kernels.hash64 import ref as tref


def _i32(rng, n):
    return rng.integers(-2**31, 2**31, n).astype(np.int32)


@pytest.mark.parametrize("n_edges", [1, 8, 80, 65535])
def test_hash_shard_id_matches_jax_and_oracle(n_edges):
    rng = np.random.default_rng(n_edges)
    hi, lo = _i32(rng, 512), _i32(rng, 512)
    hi[:4] = [-1, -2**31, 0, 2**31 - 1]       # negative sids are bit-cast
    got = th.hash_shard_id(torch.from_numpy(hi), torch.from_numpy(lo),
                           n_edges).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.asarray(jh.hash_shard_id(jnp.asarray(hi), jnp.asarray(lo),
                                         n_edges)))
    np.testing.assert_array_equal(got, tref.xxh64_mod_py(hi, lo, n_edges))


@pytest.mark.parametrize("n_edges", [1, 8, 80, 65535])
def test_hash_time_bucket_negative_buckets(n_edges):
    rng = np.random.default_rng(100 + n_edges)
    b = rng.integers(-5000, 5000, 512).astype(np.int32)
    got = th.hash_time_bucket(torch.from_numpy(b), n_edges).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jh.hash_time_bucket(jnp.asarray(b), n_edges)))
    np.testing.assert_array_equal(
        got, tref.xxh64_mod_py(np.zeros_like(b), b, n_edges))


def test_xxh64_limbs_match_oracle():
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 1 << 32, 256, dtype=np.uint32)
    lo = rng.integers(0, 1 << 32, 256, dtype=np.uint32)
    h = th.xxh64_u64((torch.from_numpy(hi.astype(np.int64)),
                      torch.from_numpy(lo.astype(np.int64))))
    exp_hi, exp_lo = tref.xxh64_batch_py(hi, lo)
    np.testing.assert_array_equal(h[0].numpy(), exp_hi.astype(np.int64))
    np.testing.assert_array_equal(h[1].numpy(), exp_lo.astype(np.int64))


def test_mod_u64_random():
    rng = np.random.default_rng(1)
    hi = rng.integers(0, 1 << 32, 64, dtype=np.int64)
    lo = rng.integers(0, 1 << 32, 64, dtype=np.int64)
    for n in (1, 3, 80, 65521, 65535):
        got = th.mod_u64((torch.from_numpy(hi), torch.from_numpy(lo)), n)
        exp = [((int(h) << 32) | int(l)) % n for h, l in zip(hi, lo)]
        np.testing.assert_array_equal(got.numpy(), exp)


def test_time_bucket_and_hash_time_match_jax():
    t = np.asarray([0.0, 299.9, 300.0, 599.9, 600.0, -0.5, -300.0, 86399.0,
                    1e7 + 0.25], np.float32)
    got = th.time_bucket(torch.from_numpy(t), 300.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jh.time_bucket(jnp.asarray(t), 300.0)))
    np.testing.assert_array_equal(got[:5], [0, 0, 1, 1, 2])
    rng = np.random.default_rng(2)
    t = rng.uniform(0, 86400, 1000).astype(np.float32)
    np.testing.assert_array_equal(
        th.hash_time(torch.from_numpy(t), 300.0, 80).numpy(),
        np.asarray(jh.hash_time(jnp.asarray(t), 300.0, 80)))


def test_wrapper_runs_plain_on_cpu_without_launching():
    before = hops.launches
    out = hops.xxh64_mod(torch.tensor([1, -1], dtype=torch.int32),
                         torch.tensor([2, 3], dtype=torch.int32), 80)
    assert hops.launches == before
    np.testing.assert_array_equal(
        out.numpy(), tref.xxh64_mod_py(np.array([1, -1]), np.array([2, 3]), 80))


def test_modulus_out_of_range_raises():
    x = torch.zeros(3, dtype=torch.int32)
    for n in (0, 65536):
        with pytest.raises(ValueError, match="65536"):
            hops.xxh64_mod(x, x, n)
