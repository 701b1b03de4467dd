"""Content-based hashing H_i and H_t (paper §3.4.1): xxHash64, then modulo.

Port of ``repro.core.hashing``. The plain version keeps the JAX package's
limb formulation: a 64-bit value is a pair of 32-bit limbs ``(hi, lo)``,
here held in int64 tensors masked to 32 bits, and 32x32 -> 64 products go
through 16-bit digit splits so no intermediate overflows int64 (torch has no
general uint32 arithmetic, and signed 64-bit overflow is undefined in C++).
It runs on any device and is what the ``hash64`` kernel is held against.

``hash_shard_id`` / ``hash_time_bucket`` go through the ``hash64`` kernel
wrapper, which runs this plain version for CPU tensors and launches the
CUDA kernel (native 64-bit multiply, modulo fused) for CUDA tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import reciprocal_like
from repro_torch.kernels.hash64 import ops as hash64_ops

M32 = 0xFFFFFFFF
M16 = 0xFFFF

# xxHash64 primes, as (hi, lo) 32-bit limb pairs.
PRIME64_1 = (0x9E3779B1, 0x85EBCA87)
PRIME64_2 = (0xC2B2AE3D, 0x27D4EB4F)
PRIME64_3 = (0x165667B1, 0x9E3779F9)
PRIME64_4 = (0x85EBCA77, 0xC2B2AE63)
PRIME64_5 = (0x27D4EB2F, 0x165667C5)

U64 = Tuple[torch.Tensor, torch.Tensor]   # (hi, lo) limbs in int64 tensors


def u32(x: torch.Tensor) -> torch.Tensor:
    """Bit pattern of an int32 tensor as a uint32 value in int64 (negative
    ints are bit-cast, not value-cast)."""
    return x.to(torch.int64) & M32


def xor64(a: U64, b: U64) -> U64:
    return a[0] ^ b[0], a[1] ^ b[1]


def add64(a: U64, b: U64) -> U64:
    lo = a[1] + b[1]
    return (a[0] + b[0] + (lo >> 32)) & M32, lo & M32


def shr64(a: U64, n: int) -> U64:
    """Logical right shift by a static amount 0 <= n < 64."""
    if n == 0:
        return a
    if n >= 32:
        return torch.zeros_like(a[0]), a[0] >> (n - 32)
    return a[0] >> n, ((a[1] >> n) | (a[0] << (32 - n))) & M32


def shl64(a: U64, n: int) -> U64:
    if n == 0:
        return a
    if n >= 32:
        return (a[1] << (n - 32)) & M32, torch.zeros_like(a[1])
    return ((a[0] << n) | (a[1] >> (32 - n))) & M32, (a[1] << n) & M32


def rotl64(a: U64, n: int) -> U64:
    n = n % 64
    if n == 0:
        return a
    hi_l, lo_l = shl64(a, n)
    hi_r, lo_r = shr64(a, 64 - n)
    return hi_l | hi_r, lo_l | lo_r


def _mul32x32(a, b) -> U64:
    """Exact 32x32 -> 64 product via 16-bit digit split."""
    a_lo, a_hi = a & M16, a >> 16
    b_lo, b_hi = b & M16, b >> 16
    ll = a_lo * b_lo                     # each partial product < 2^32
    mid = a_lo * b_hi + a_hi * b_lo + (ll >> 16)   # < 3 * 2^32: fits int64
    lo = ((mid & M16) << 16) | (ll & M16)
    hi = (a_hi * b_hi + (mid >> 16)) & M32
    return hi, lo


def _mul32_lo(a, b):
    """(a * b) mod 2^32 for 32-bit values."""
    a_lo, a_hi = a & M16, a >> 16
    b_lo, b_hi = b & M16, b >> 16
    return (a_lo * b_lo + (((a_lo * b_hi + a_hi * b_lo) & M16) << 16)) & M32


def mul64(a: U64, b: Tuple[int, int]) -> U64:
    """(a * b) mod 2^64 for a limb pair ``a`` and a constant limb pair."""
    hi, lo = _mul32x32(a[1], b[1])
    hi = (hi + _mul32_lo(a[1], b[0]) + _mul32_lo(a[0], b[1])) & M32
    return hi, lo


def _const(pair, like: torch.Tensor) -> U64:
    return (torch.full_like(like, pair[0]), torch.full_like(like, pair[1]))


def xxh64_avalanche(h: U64) -> U64:
    h = xor64(h, shr64(h, 33))
    h = mul64(h, PRIME64_2)
    h = xor64(h, shr64(h, 29))
    h = mul64(h, PRIME64_3)
    h = xor64(h, shr64(h, 32))
    return h


def xxh64_u64(key: U64) -> U64:
    """xxHash64 (seed 0) of one 64-bit word given as int64 limb tensors with
    values in [0, 2^32)."""
    h = add64(_const(PRIME64_5, key[0]), _const((0, 8), key[0]))
    k1 = mul64(key, PRIME64_2)
    k1 = rotl64(k1, 31)
    k1 = mul64(k1, PRIME64_1)
    h = xor64(h, k1)
    h = add64(mul64(rotl64(h, 27), PRIME64_1), _const(PRIME64_4, h[0]))
    return xxh64_avalanche(h)


def check_n_edges(n: int) -> None:
    if not (0 < n < (1 << 16)):
        raise ValueError(f"mod_u64 requires 0 < n < 65536, got {n}")


def mod_u64(h: U64, n: int) -> torch.Tensor:
    """(h mod n) for a small static n (< 2^16), as int32 — the JAX package's
    limb reduction, which equals the native ``h % n`` on the 64-bit value."""
    check_n_edges(n)
    two32_mod = (1 << 32) % n
    return ((((h[0] % n) * two32_mod) % n + h[1] % n) % n).to(torch.int32)


def xxh64_mod_plain(hi: torch.Tensor, lo: torch.Tensor,
                    n_edges: int) -> torch.Tensor:
    """Plain version of the ``hash64`` kernel: xxh64((hi, lo)) mod n_edges
    for int32 limb tensors (bit patterns of uint32); ``hi=None`` means 0."""
    lo64 = u32(lo)
    hi64 = torch.zeros_like(lo64) if hi is None else u32(hi)
    return mod_u64(xxh64_u64((hi64, lo64)), n_edges)


# ---------------------------------------------------------------------------
# Paper hash functions H_i and H_t (H_s lives in voronoi.py).
# ---------------------------------------------------------------------------

def hash_shard_id(sid_hi: torch.Tensor, sid_lo: torch.Tensor,
                  n_edges: int) -> torch.Tensor:
    """H_i: mod(xxh64(shardID), edgeCount) (paper §3.4.1)."""
    return hash64_ops.xxh64_mod(sid_hi, sid_lo, n_edges)


def time_bucket(t: torch.Tensor, tau: float) -> torch.Tensor:
    """Bucket id of a timepoint for tau-width temporal slicing (int32), as
    the reference's jitted insert and query compute it (``t`` times the
    float32 reciprocal of ``tau``, see ``device.reciprocal_like``)."""
    return torch.floor(t * reciprocal_like(tau, t)).to(torch.int32)


def hash_time_bucket(bucket: torch.Tensor, n_edges: int) -> torch.Tensor:
    """H_t applied to a precomputed bucket id: mod(xxh64(bucket), edgeCount),
    the bucket's int32 bits as the low word of a zero-high key."""
    return hash64_ops.xxh64_mod(None, bucket, n_edges)


def hash_time(t: torch.Tensor, tau: float, n_edges: int) -> torch.Tensor:
    """H_t: timepoint -> tau bucket -> edge index."""
    return hash_time_bucket(time_bucket(t, tau), n_edges)
