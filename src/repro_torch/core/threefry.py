"""Threefry-2x32 keys and draws, bit for bit as ``jax.random`` makes them.

The JAX package's random planner draws its noise through ``jax.random``
under its defaults: the ``threefry2x32`` generator with partitionable
counters (``jax_threefry_partitionable``, on by default). This module is
that recipe in plain PyTorch ops, so the port draws the same bits from the
same key.

A key is two uint32 words. One key is a pair of Python ints ``(k0, k1)``
on the host, so ``key``, ``split`` and a scalar ``fold_in`` cost no device
launch and no sync. A batch of keys is an int64 tensor of shape
``(..., 2)`` on the device that draws with it. Every word is held in an
int64 masked to 32 bits after each add and rotate: torch has little uint32
arithmetic, and ``>>`` on a signed int is arithmetic.

- ``key(seed)``: ``(0, seed mod 2^32)``, as ``jax.random.key`` with 32-bit
  integers (JAX's default).
- ``split(key, n)``: key ``i`` is ``threefry2x32(key, (0, i))``.
- ``fold_in(key, data)``: ``threefry2x32(key, (0, data mod 2^32))``.
- ``random_bits(key, shape, width=32)``: ``y0 ^ y1`` of
  ``threefry2x32(key, (hi, lo))`` over the 64-bit flat index ``(hi, lo)``
  of ``shape``; at width 8 or 16 its low bits, as ``jax.random.bits`` with
  ``uint8`` / ``uint16`` gives them (partitionable counters draw one word
  an element whatever the width).
- ``uniform``, ``gumbel``: ``jax.random.uniform`` and ``jax.random.gumbel``
  (mode ``"low"``) in float32 or bfloat16 from those bits. The uniforms
  are bitwise JAX's in both. The float32 gumbels differ by the ulps in
  which torch's ``log`` and XLA's differ (up to 9.54e-7 over 2^20 draws,
  ``tests/test_torch_threefry.py``); the bfloat16 ones are bitwise JAX's
  (``gumbel``'s docstring says why on any device).
- ``categorical(key, logits)``: ``jax.random.categorical`` with
  replacement, mode ``"low"``: the first index of the largest
  ``gumbel + logits`` in the logits' dtype.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["Key", "Keys", "F32_TINY", "threefry2x32", "key", "split",
           "fold_in", "random_bits", "uniform", "gumbel", "categorical"]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
F32_TINY = 1.1754943508222875e-38       # numpy.finfo(numpy.float32).tiny
                                        # (bfloat16's tiny is the same 2^-126)
_DTYPES = (torch.float32, torch.bfloat16)

Key = Tuple[int, int]
Word = Union[int, torch.Tensor]
Keys = Union[Key, torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0: Word, k1: Word, x0: Word,
                 x1: Word) -> Tuple[Word, Word]:
    """The 20-round Threefry-2x32 block function of key ``(k0, k1)`` over
    counters ``(x0, x1)``. Each word is a Python int or an int64 tensor
    (they broadcast), with its value in ``[0, 2^32)``; returns the two
    output words in the same form."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _words(k: Keys) -> Tuple[Word, Word]:
    if isinstance(k, torch.Tensor):
        if k.dim() < 2 or k.shape[-1] != 2:
            raise ValueError(f"a batch of keys is (..., 2), got {tuple(k.shape)}; "
                             "one key is a pair of ints")
        return k[..., 0], k[..., 1]
    k0, k1 = k
    return int(k0) & M32, int(k1) & M32


def key(seed: int) -> Key:
    """The key ``jax.random.key(seed)`` holds: a zero high word and the
    seed's low 32 bits."""
    return 0, int(seed) & M32


def split(k: Key, n: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(k, n)`` of one key, on the host: ``n`` keys, key
    ``i`` the block function of ``k`` over the counter ``(0, i)``."""
    k0, k1 = _words(k)
    return tuple(threefry2x32(k0, k1, 0, i) for i in range(n))


def fold_in(k: Keys, data) -> Keys:
    """``jax.random.fold_in(k, data)``: the block function of ``k`` over
    ``(0, data mod 2^32)``. One key and an int give one key on the host; a
    tensor of data (``torch.arange(Q)`` for per-query keys) or a batch of
    keys gives a ``(..., 2)`` batch of the broadcast shape."""
    k0, k1 = _words(k)
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & M32
    else:
        data = int(data) & M32
    y0, y1 = threefry2x32(k0, k1, 0, data)
    if isinstance(y0, torch.Tensor):     # then both words are tensors
        return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)
    return y0, y1


def random_bits(k: Keys, shape: Sequence[int], device="cuda",
                width: int = 32) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32; uint16 or uint8 at ``width``
    16 or 8) as int64 values in ``[0, 2^width)``. A batch of keys
    ``(..., 2)`` draws ``shape`` for each key, giving ``(...) + shape`` on
    the keys' device; one key draws on ``device``."""
    if width not in (8, 16, 32):
        raise ValueError(f"width {width}: 8, 16 or 32 bits")
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    k0, k1 = _words(k)
    if isinstance(k0, torch.Tensor):
        dev, lead = k0.device, tuple(k0.shape)
        k0, k1 = k0[..., None], k1[..., None]
    else:
        dev, lead = resolve_device(device), ()
    lo = torch.arange(n, dtype=torch.int64, device=dev)
    hi = 0                               # the flat index's high word
    if n > 1 << 32:
        hi, lo = lo >> 32, lo & M32
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    bits = y0 ^ y1
    if width < 32:
        bits = bits & ((1 << width) - 1)
    return bits.reshape(lead + shape)


def uniform(k: Keys, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device="cuda",
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform`` in float32 or bfloat16.

    float32: 23 random mantissa bits under the exponent of 1.0, minus one,
    times the span, plus ``minval``, then at least ``minval``; the bounds
    and the span are rounded to float32 first. XLA contracts the scale and
    the shift into one fused multiply-add, so they are computed here in
    float64 (where the product of two float32 values is exact) and rounded
    to float32 once. Two float32 ops would round twice and differ from JAX
    in a fifth to a half of the draws (``tests/test_torch_threefry.py``),
    unless the product is exact, as it is for a span of 1.0 (the gumbel's).

    bfloat16: JAX draws 8 bits (a 7-bit mantissa is under its 8-bit
    floor), keeps the top 7 under bfloat16's 1.0 and subtracts one; the
    bounds, the span, the product and the sum are each rounded to
    bfloat16, as torch's bfloat16 ops round them (XLA fuses nothing
    there: fused, 6 % to 25 % of the draws land elsewhere)."""
    if dtype == torch.bfloat16:
        bits = random_bits(k, shape, device, width=8)
        f = ((bits >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16) - 1.0
        # bfloat16 bounds and span as Python floats: exact in the float32
        # that torch computes bfloat16 ops in, and no copy to the device
        lo, hi = (torch.tensor(v, dtype=dtype) for v in (minval, maxval))
        span, lo = float(hi - lo), float(lo)
        return (f * span + lo).clamp_min(lo)
    if dtype != torch.float32:
        raise ValueError(f"dtype {dtype}: one of {_DTYPES}")
    bits = random_bits(k, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    span, lo = float(hi - lo), float(lo)
    return (f.double() * span + lo).float().clamp_min(lo)


def gumbel(k: Keys, shape: Sequence[int], device="cuda",
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (mode ``"low"``) in float32 or bfloat16:
    ``-log(-log(u))`` of a uniform draw in ``[tiny, 1)``.

    In bfloat16 the reference's jitted ``_gumbel`` rounds each ``log`` to
    bfloat16 (XLA computes it in float32 and converts back): rounded once
    at the end instead, 45 % of 2^20 draws differ from JAX's, while this
    sequence gives JAX's bits for all of them. A bfloat16 uniform takes 128
    values, and each ``log`` on the way lies at least 2.1e-6 (relative)
    from a bfloat16 rounding midpoint, so any float32 ``log`` within a few
    ulps, the card's included, gives the same bits."""
    u = uniform(k, shape, minval=F32_TINY, maxval=1.0, device=device,
                dtype=dtype)
    if dtype == torch.bfloat16:
        inner = torch.log(u.float()).to(dtype)
        return -torch.log(-inner.float()).to(dtype)
    return -torch.log(-torch.log(u))


def categorical(k: Keys, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(k, logits, axis)`` (with replacement, mode
    ``"low"``): gumbels of the logits' shape and dtype drawn on the logits'
    device, added to them in that dtype, and the first index of the
    maximum along ``axis`` (``torch.argmax``'s tie rule, as
    ``jnp.argmax``'s), as int32."""
    g = gumbel(k, logits.shape, device=logits.device, dtype=logits.dtype)
    return torch.argmax(g + logits, dim=axis).to(torch.int32)
