"""Oracle for the xxHash64 kernel: pure-python-int xxHash64 (8-byte input
path), bit-exact per the reference implementation. A copy of the JAX
package's ``kernels/hash64/ref.py`` (the port imports nothing from it)."""

from __future__ import annotations

import numpy as np

M64 = (1 << 64) - 1
P1 = 0x9E3779B185EBCA87
P2 = 0xC2B2AE3D27D4EB4F
P3 = 0x165667B19E3779F9
P4 = 0x85EBCA77C2B2AE63
P5 = 0x27D4EB2F165667C5


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & M64


def xxh64_u64_py(key: int, seed: int = 0) -> int:
    """xxHash64 of a single little-endian 64-bit word."""
    h = (seed + P5 + 8) & M64
    k1 = (key * P2) & M64
    k1 = _rotl(k1, 31)
    k1 = (k1 * P1) & M64
    h ^= k1
    h = (_rotl(h, 27) * P1 + P4) & M64
    h ^= h >> 33
    h = (h * P2) & M64
    h ^= h >> 29
    h = (h * P3) & M64
    h ^= h >> 32
    return h


def xxh64_batch_py(hi: np.ndarray, lo: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vector oracle over (hi, lo) uint32 limb arrays."""
    out_hi = np.empty_like(hi, dtype=np.uint32)
    out_lo = np.empty_like(lo, dtype=np.uint32)
    for i, (h32, l32) in enumerate(zip(hi.reshape(-1).tolist(), lo.reshape(-1).tolist())):
        h = xxh64_u64_py(((h32 & 0xFFFFFFFF) << 32) | (l32 & 0xFFFFFFFF))
        out_hi.reshape(-1)[i] = h >> 32
        out_lo.reshape(-1)[i] = h & 0xFFFFFFFF
    return out_hi, out_lo


def xxh64_mod_py(hi: np.ndarray, lo: np.ndarray, n: int) -> np.ndarray:
    """xxh64((hi, lo)) mod n over int32 or uint32 limb arrays, as int32."""
    keys = zip(np.asarray(hi).astype(np.uint32).reshape(-1).tolist(),
               np.asarray(lo).astype(np.uint32).reshape(-1).tolist())
    out = [xxh64_u64_py((h << 32) | l) % n for h, l in keys]
    return np.asarray(out, np.int32).reshape(np.shape(lo))
