"""Hash-based batched board initializers, port of :mod:`mcqueens.core.fastinit`.

The JAX package hashes in uint32.  Here a uint32 value is held as the int32
tensor with the same bit pattern: multiplies wrap identically and logical
shifts keep a mask, so every board equals the JAX board bit for bit.  Seeds
are int32 tensors holding the uint32 seed bits (see
:func:`mcqueens_torch.kernels.board_shared.seed_tensor`).
"""

from __future__ import annotations

import math

import torch

from mcqueens_torch.core.init import _klarner_core_m
from mcqueens_torch.kernels.prng import _i32, _shr


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 bit patterns held in int32."""
    x = x ^ _shr(x, 16)
    x = x * _i32(0x85EBCA6B)
    x = x ^ _shr(x, 13)
    x = x * _i32(0xC2B2AE35)
    return x ^ _shr(x, 16)


def _hash2(seeds: torch.Tensor, idx: torch.Tensor, salt: int) -> torch.Tensor:
    """(C, n) hash of every (seed, index) pair: coordinates mixed apart,
    then combined (as in the JAX package)."""
    hs = _mix(seeds ^ _i32(salt * 0x632BE59B + 1))
    hi = _mix(idx + _i32(0xDEADBEEF))
    return _mix(hs[:, None] ^ (hi[None, :] * _i32(0x9E3779B9)))


def uniform_ints(seeds: torch.Tensor, shape_per_seed, bound: int,
                 salt: int = 0) -> torch.Tensor:
    """(C, *shape) int32 values uniform in [0, bound) from per-chain seeds."""
    n = math.prod(shape_per_seed)
    idx = torch.arange(n, dtype=torch.int32, device=seeds.device)
    r = _hash2(seeds.to(torch.int32), idx, salt)
    # unsigned modulo: reinterpret the bits as uint32 in int64 first
    vals = ((r.to(torch.int64) & 0xFFFFFFFF) % bound).to(torch.int32)
    return vals.reshape((seeds.shape[0],) + tuple(shape_per_seed))


def board_init_batch(seeds: torch.Tensor, N: int,
                     init_mode: str) -> torch.Tensor:
    """(C, N, N) int32 initial heights on ``seeds.device``."""
    C = seeds.shape[0]
    ii = torch.arange(N, dtype=torch.int32, device=seeds.device)
    i_g, j_g = torch.meshgrid(ii, ii, indexing="ij")
    if init_mode == "random":
        return uniform_ints(seeds, (N, N), N)
    if init_mode == "latin":
        return ((i_g + j_g) % N).expand(C, N, N).contiguous()
    if init_mode == "klarner":
        if math.gcd(N, 210) == 1:
            return ((3 * i_g + 5 * j_g) % N).expand(C, N, N).contiguous()
        M = _klarner_core_m(N)
        core = (3 * i_g + 5 * j_g) % M
        rand = uniform_ints(seeds, (N, N), N, salt=1)
        in_core = (i_g < M) & (j_g < M)
        return torch.where(in_core[None], core[None], rand)
    raise ValueError(f"Unknown init_mode: {init_mode}")
