"""Port of H_i / H_t hashing (``repro_torch.core.hashing`` and the ``hash64``
kernel wrapper) held bitwise against the JAX package and the pure-Python
xxHash64 oracle. On the CPU the wrapper runs the plain limb version; the
kernel itself is tested on the card in ``test_torch_kernels_cuda.py``."""

import jax
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


def test_time_bucket_matches_jitted_jax_at_bucket_boundaries():
    """t on and beside every multiple of 300 s up to 1.2e8 s: the port's
    bucket equals the reference's under ``jax.jit`` (its insert and query),
    which multiplies by the float32 reciprocal of tau, not its eager
    quotient (they differ on thousands of these floats)."""
    t = (np.arange(1, 400000) * np.float32(300)).astype(np.float32)
    t = np.concatenate([t, np.nextafter(t, np.float32(0)),
                        np.nextafter(t, np.float32(1e12))])
    want = np.asarray(jax.jit(jh.time_bucket, static_argnums=1)(jnp.asarray(t), 300.0))
    np.testing.assert_array_equal(th.time_bucket(torch.from_numpy(t), 300.0).numpy(),
                                  want)
    assert (want != np.floor(t / np.float32(300)).astype(np.int32)).sum() > 1000


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


# -- the CUDA kernel's modulo (csrc/hash64.cu, mod_n), replayed on the CPU ----

M32, M64 = (1 << 32) - 1, (1 << 64) - 1
EVERY_N = np.arange(1, 1 << 16, dtype=np.uint64)


def _umul64hi_small(y, n):
    """High 64 bits of y * n for uint64 ``y`` and ``n`` < 2^32, as the kernel
    writes it: the low word's high product, then the high word's product
    plus it, whose high word is the result."""
    t = ((y & np.uint64(M32)) * n) >> np.uint64(32)
    return ((y >> np.uint64(32)) * n + t) >> np.uint64(32)


def _kernel_mod(h, n, m, r):
    """``mod_n`` of csrc/hash64.cu in wrapping uint64 arithmetic, elementwise
    over ``h`` (hashes) and ``n``, ``m``, ``r`` (one modulus each)."""
    x = (h >> np.uint64(32)) * r + (h & np.uint64(M32))
    assert (x <= np.uint64(M32) * n).all()      # the bound the proof needs
    return _umul64hi_small(m * x, n)


def _constants(ns):
    """m = ceil(2^64 / n) mod 2^64 and r = 2^32 mod n, in Python ints."""
    m = np.array([-(-(1 << 64) // int(n)) & M64 for n in ns], np.uint64)
    r = np.array([(1 << 32) % int(n) for n in ns], np.uint64)
    return m, r


def _hashes(kind, ns):
    """(len(ns), K) uint64 hashes: a row for each modulus."""
    rng = np.random.default_rng(7)
    k = len(ns)
    if kind == "seeded":            # random words and real xxh64 outputs
        keys = rng.integers(0, 1 << 64, 3, dtype=np.uint64).tolist()
        real = np.array([tref.xxh64_u64_py(int(v)) for v in keys], np.uint64)
        h = rng.integers(0, 1 << 64, (k, 3), dtype=np.uint64)
        return np.concatenate([h, np.tile(real, (k, 1))], 1)
    if kind == "edges":
        return np.tile(np.array([0, 1, M32, 1 << 32, (1 << 63) - 1, 1 << 63,
                                 M64 - 1, M64], np.uint64), (k, 1))
    top = np.uint64(M64) // ns * ns            # the largest multiple of n
    mult = rng.integers(0, 1 << 48, k, dtype=np.uint64) * ns
    cols = [top, top - ns, mult, ns, ns - np.uint64(1), top - np.uint64(1),
            top + (ns - np.uint64(1)), mult + ns - np.uint64(1)]
    return np.stack(cols, 1)                    # multiples of n, n k - 1


@pytest.mark.parametrize("kind", ["seeded", "edges", "multiples"])
def test_kernel_modulo_replay_every_n(kind):
    m, r = _constants(EVERY_N.tolist())
    with np.errstate(over="ignore"):
        h = _hashes(kind, EVERY_N)
        n, m, r = (a[:, None] for a in (EVERY_N, m, r))
        got = _kernel_mod(h, n, m, r)
    np.testing.assert_array_equal(got, h % n)
    some = [0, 1, 79, 65520, 65534]                 # spot rows in Python ints
    for i in some:
        assert [int(v) for v in got[i]] == [int(v) % (i + 1) for v in h[i]]


def test_wrapper_constants_every_n():
    ns = EVERY_N.tolist()
    m, r = _constants(ns)
    got = [hops.mod_constants(int(n)) for n in ns]
    hops.mod_constants.cache_clear()
    assert [g[0] for g in got] == [int(v) for v in m]
    assert [g[1] for g in got] == [int(v) for v in r]
    assert got[0] == (0, 0) and got[79] == (230584300921369396, 16)
    with np.errstate(over="ignore"):               # the replay, with them
        h = np.array([M64, 0xDEADBEEFCAFEF00D, 12345], np.uint64)
        n = EVERY_N[:, None]
        mm = np.array([g[0] for g in got], np.uint64)[:, None]
        rr = np.array([g[1] for g in got], np.uint64)[:, None]
        np.testing.assert_array_equal(_kernel_mod(h[None, :], n, mm, rr),
                                      h[None, :] % n)
    for n in (0, 65536):
        with pytest.raises(ValueError, match="65536"):
            hops.mod_constants(n)


@pytest.mark.parametrize("first", ["repro_torch.kernels.hash64.ops",
                                   "repro_torch.core.hashing"])
def test_hashing_and_wrapper_import_in_either_order(first):
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(root, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    code = (f"import {first}; from repro_torch.core import hashing; "
            "from repro_torch.kernels.hash64 import ops; import torch; "
            "b = torch.arange(3, dtype=torch.int32); "
            "print(int(hashing.hash_time_bucket(b, 80)[2]), "
            "int(ops.xxh64_mod(None, torch.tensor([2]), 80)[0]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=env).stdout.split()
    want = tref.xxh64_mod_py(np.zeros(1), np.array([2]), 80)[0]
    assert out == [str(want), str(want)]
