"""Threefry-2x32 random numbers, bit for bit those of the JAX package's
sampler.

The reference scheduler draws every sampled token from
``jax.random.fold_in(jax.random.PRNGKey(seed), count)`` and
``jax.random.categorical`` (Gumbel noise, mode ``"low"``), under JAX's
default ``threefry2x32`` with ``jax_threefry_partitionable`` on.  This module
repeats that arithmetic so a sampled stream can be held to the reference's
token for token:

* ``key(seed)`` is ``PRNGKey`` for an int32 seed: the pair ``(0, seed mod
  2**32)``;
* ``fold_in(key, data)`` hashes the counter pair ``(0, data)`` under ``key``;
* ``random_bits(key, n)`` hashes the counter pairs ``(i >> 32, i mod 2**32)``
  of a flat index ``i`` and xors the two output words;
* ``uniform`` and ``gumbel`` turn 32 bits into a float32 in [1, 2) by
  setting the exponent bits, exactly as ``jax.random._uniform`` does.

A key is a pair ``(k1, k2)`` of 32-bit words.  The words are Python ints
(one key, on the host) or int64 tensors (a batch of keys, on any device);
the rounds use only ``+ ^ << >> &``, masked to 32 bits, so the same code
serves both — torch's ``uint32`` has few kernels.  The uniforms equal JAX's
bit for bit; ``gumbel``'s two logarithms may differ from XLA's in the last
place.
"""
from __future__ import annotations

import struct

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: float32's smallest normal number, the floor of ``gumbel``'s uniforms
F32_TINY = 1.1754943508222875e-38


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) of counter words
    ``(x1, x2)`` under key ``(k1, k2)`` → two 32-bit words.  Arguments
    broadcast like tensors (or are all Python ints)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1, x2 = (x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def key(seed):
    """``jax.random.PRNGKey(seed)`` for an int32 seed (an int, or an
    integer tensor of seeds) → ``(k1, k2)``."""
    if torch.is_tensor(seed):
        k2 = seed.to(torch.int64) & MASK
        return torch.zeros_like(k2), k2
    return 0, int(seed) & MASK


def fold_in(k, data):
    """``jax.random.fold_in(k, data)``: ``data`` (an int or an integer
    tensor broadcasting against the key words) → a new key."""
    if torch.is_tensor(data):
        data = data.to(torch.int64) & MASK
    else:
        data = int(data) & MASK
    return threefry2x32(k[0], k[1], 0, data)


def random_bits(k, n: int):
    """``jax.random.bits(k, (n,))`` for tensor key words of shape ``[...]``
    → int64 tensor ``[..., n]`` of 32-bit values; ``n == 0`` means the
    scalar draw (shape ``()``), which counts from index 0 too."""
    k1, k2 = k
    if not torch.is_tensor(k2):
        if n:
            raise TypeError("a host key draws one value (n=0)")
        b1, b2 = threefry2x32(k1, k2, 0, 0)
        return b1 ^ b2
    idx = torch.arange(max(n, 1), dtype=torch.int64, device=k2.device)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None], idx >> 32, idx & MASK)
    bits = b1 ^ b2
    return bits if n else bits[..., 0]


def _to_unit(bits):
    """32 random bits → float32 in [0, 1): the top 23 bits become the
    mantissa of a float in [1, 2), minus 1 (exact in float32)."""
    if torch.is_tensor(bits):
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        return f - 1.0
    return struct.unpack("<f", struct.pack("<I", (bits >> 9) | 0x3F800000))[0] - 1.0


def uniform(k, n: int = 0, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(k, shape, float32, minval, maxval)`` for shape
    ``()`` (``n == 0``) or ``(n,)``.  A host key draws on [0, 1) only and
    gives a Python float (``u * 1 + 0`` is ``u`` in float32)."""
    u = _to_unit(random_bits(k, n))
    if not torch.is_tensor(u):
        if (minval, maxval) != (0.0, 1.0):
            raise ValueError("a host key draws on [0, 1) only")
        return u
    lo = torch.tensor(minval, dtype=torch.float32, device=u.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=u.device) - lo
    return torch.maximum(lo, u * span + lo)


def gumbel(k, n: int):
    """``jax.random.gumbel(k, (n,), float32, mode="low")`` for tensor key
    words ``[...]`` → ``[..., n]``: ``-log(-log(u))`` with ``u`` uniform on
    [tiny, 1)."""
    return -torch.log(-torch.log(uniform(k, n, minval=F32_TINY)))
