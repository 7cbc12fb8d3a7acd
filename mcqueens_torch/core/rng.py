"""JAX's threefry PRNG in PyTorch, port of :mod:`mcqueens.core.rng`.

The scan samplers (:mod:`mcqueens_torch.chain.board`, :mod:`~.full3d`) draw
every random number through ``jax.random`` with the default threefry2x32
implementation in its partitionable mode.  Each primitive is pure uint32
arithmetic, reproduced here bit for bit:

  * ``key(seed) = (0, seed)``;
  * ``threefry2x32(k, (x0, x1))``: 20 add/rotate/xor rounds with a key
    injection after every 4;
  * ``fold_in(k, d) = threefry2x32(k, (0, d))``;
  * ``split(k, n)[m] = threefry2x32(k, (0, m))`` (the counter is the 64-bit
    index, split into hi and lo words);
  * ``random_bits(k, shape)[c] = x0 ^ x1`` of ``threefry2x32(k, (0, c))``;
  * ``randint`` combines two such words modulo the span, ``uniform`` puts 23
    bits in a float32 mantissa, ``permutation`` sorts by fresh bits in
    rounds (a stable sort).

Keys are ``(..., 2)`` int64 tensors holding uint32 words, and every sum is
reduced mod 2^32, so any leading batch shape works: one key per chain is a
``(C, 2)`` tensor.  The CUDA kernels (``kernels/csrc/board_scan.cu``,
``full3d_scan.cu``) compute the same words in ``uint32_t``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_UINT32_MAX = 0xFFFFFFFF


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter pair ``(x0, x1)`` under key ``(k0, k1)``.

    All four are int64 tensors (or ints) of uint32 values that broadcast
    together; returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _M32
    return x0, x1


def _as_words(x, device=None) -> torch.Tensor:
    """Integers (tensor, array or int) as int64 uint32 words."""
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                        device=device)
    return t.to(torch.int64) & _M32


def key(seeds, device=None) -> torch.Tensor:
    """``jax.random.key`` of uint32 seeds: ``(..., 2)`` keys ``(0, seed)``."""
    s = _as_words(seeds, device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def _hash_counters(keys: torch.Tensor, n: int):
    """``threefry2x32(key, (0, c))`` for counters ``c = 0 .. n-1``: two
    ``(..., n)`` word tensors."""
    c = torch.arange(n, dtype=torch.int64, device=keys.device)
    return threefry2x32(keys[..., 0, None], keys[..., 1, None], 0, c)


def split(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` keys -> ``(..., n, 2)``."""
    return torch.stack(_hash_counters(keys, n), dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of uint32 ``data`` (an int, or a tensor that
    broadcasts against the keys' batch shape)."""
    d = data & _M32 if isinstance(data, int) else _as_words(data, keys.device)
    return torch.stack(threefry2x32(keys[..., 0], keys[..., 1], 0, d),
                       dim=-1)


def random_bits(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """32-bit ``jax.random.bits``: ``(..., *shape)`` int64 words."""
    shape = tuple(shape)
    x0, x1 = _hash_counters(keys, math.prod(shape))
    return (x0 ^ x1).reshape(keys.shape[:-1] + shape)


def randint(keys: torch.Tensor, shape, minval: int, maxval
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``: two words
    per value, combined modulo the span; int32 result.  ``maxval`` is an
    int or an int64 tensor that broadcasts against the result (one call
    then draws values of several ranges)."""
    k = split(keys, 2)
    hi = random_bits(k[..., 0, :], shape)
    lo = random_bits(k[..., 1, :], shape)
    if isinstance(maxval, int):
        span = (maxval - minval) & _M32 if maxval > minval else 1
    else:
        span = torch.where(maxval > minval, (maxval - minval) & _M32, 1)
    # Both products stay below 2^32: a span over 2^16 makes mult 0.
    mult = (65536 % span) ** 2 & _M32
    mult = mult % span
    off = (((hi % span) * mult & _M32) + lo % span) & _M32
    return (minval + off % span).to(torch.int32)


def uniform(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.uniform`` on [0, 1) as float32: 23 random bits under
    the exponent of 1.0, minus 1."""
    bits = (random_bits(keys, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` sorted (stably) by
    fresh 32-bit keys, in as many rounds as JAX takes for ``n``; int64."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_UINT32_MAX)))
    x = torch.arange(n, dtype=torch.int64, device=keys.device).expand(
        keys.shape[:-1] + (n,))
    for _ in range(rounds):
        k = split(keys, 2)
        keys, sub = k[..., 0, :], k[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True)[1]
        x = x.gather(-1, order)
    return x


def chain_keys_from_seeds(seeds, device=None) -> torch.Tensor:
    """One key per chain from integer seeds (each chain's stream is keyed
    by its own seed, the reference's per-run ``seed(base_seed + r)``)."""
    return key(np.asarray(seeds).astype(np.uint32), device)


def step_key(chain_key: torch.Tensor, step) -> torch.Tensor:
    """The key governing all draws of one chain step (counter-based)."""
    return fold_in(chain_key, step)


def as_int32(words: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) as the int32 values with the same bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def from_int32(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`as_int32`."""
    return words.to(torch.int64) & _M32
