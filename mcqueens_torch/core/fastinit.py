"""Hash-based batched initializers, port of :mod:`mcqueens.core.fastinit`.

The JAX package hashes in uint32.  Here a uint32 value is held as the int32
tensor with the same bit pattern: multiplies wrap identically and logical
shifts keep a mask, so every board and placement equals the JAX one bit for
bit.  Seeds are int32 tensors holding the uint32 seed bits.

Full-3D placements rank all N^3 cells per chain by hash score.  The JAX
``argsort`` is stable and scores tie (blocked klarner cells all score
0xFFFFFFFF, and at 65536 chains some chain's N^3 hashes collide), so
the port sorts the scores widened to int64 with a stable sort, in slices of
chains that bound the sort's scratch (:data:`_RANK_ELEMS`).
"""

from __future__ import annotations

import math

import torch

from mcqueens_torch.core.init import _cells_to_queens, _klarner_core_m
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


# Score elements ranked per slice: ~28 bytes each in flight (int32 hash,
# int64 key, sorted keys and indices), so about 470 MB at 2^24.
_RANK_ELEMS = 1 << 24


def _rank_cells(seeds: torch.Tensor, N3: int, blocked_mask=None,
                salt: int = 2) -> torch.Tensor:
    """(C, N3) int64 cell ids per chain in ascending hash-score order
    (stable, as ``jnp.argsort``); ``blocked_mask`` (N3,) bool pushes cells
    to the end."""
    idx = torch.arange(N3, dtype=torch.int32, device=seeds.device)
    scores = _hash2(seeds.to(torch.int32), idx, salt).to(torch.int64)
    scores &= 0xFFFFFFFF
    if blocked_mask is not None:
        scores = torch.where(blocked_mask[None, :], 0xFFFFFFFF, scores)
    return torch.sort(scores, dim=1, stable=True).indices


def _first_ranked(seeds: torch.Tensor, N3: int, n: int,
                  blocked_mask=None) -> torch.Tensor:
    """The first ``n`` cells of :func:`_rank_cells`, ranked in slices of
    chains so at most :data:`_RANK_ELEMS` scores are sorted at once."""
    step = max(1, _RANK_ELEMS // N3)
    return torch.cat([
        _rank_cells(seeds[s:s + step], N3, blocked_mask)[:, :n]
        for s in range(0, seeds.shape[0], step)])


def full3d_init_batch(seeds: torch.Tensor, N: int, init_mode: str,
                      Q: int | None = None) -> torch.Tensor:
    """(C, Q, 3) int32 initial queens on ``seeds.device``."""
    if Q is None:
        Q = N * N
    C = seeds.shape[0]
    N3 = N * N * N
    if init_mode in ("latin", "klarner") and Q != N * N:
        raise ValueError(
            f"{init_mode} initialization assumes Q = N^2, got Q={Q}, "
            f"N^2={N * N}.")
    if init_mode == "random":
        if Q > N3:
            raise ValueError(f"Q={Q} cannot exceed N^3={N3}.")
        return _cells_to_queens(_first_ranked(seeds, N3, Q), N)

    ii = torch.arange(N, dtype=torch.int32, device=seeds.device)
    i_g, j_g = (g.reshape(-1) for g in torch.meshgrid(ii, ii, indexing="ij"))
    if init_mode == "latin":
        q = torch.stack([i_g, j_g, (i_g + j_g) % N], dim=-1)
        return q.expand(C, N * N, 3).contiguous()
    if init_mode == "klarner":
        if math.gcd(N, 210) == 1:
            q = torch.stack([i_g, j_g, (3 * i_g + 5 * j_g) % N], dim=-1)
            return q.expand(C, N * N, 3).contiguous()
        M = _klarner_core_m(N)
        ci = torch.arange(M, dtype=torch.int32, device=seeds.device)
        c_i, c_j = (g.reshape(-1) for g in
                    torch.meshgrid(ci, ci, indexing="ij"))
        core = torch.stack([c_i, c_j, (3 * c_i + 5 * c_j) % M], dim=-1)
        core_cells = ((core[:, 0] * N + core[:, 1]) * N + core[:, 2]).long()
        blocked = torch.zeros(N3, dtype=torch.bool, device=seeds.device)
        blocked[core_cells] = True
        extra = _cells_to_queens(
            _first_ranked(seeds, N3, Q - M * M, blocked), N)
        return torch.cat([core.expand(C, M * M, 3), extra], dim=1)
    raise ValueError(f"Unknown init_mode: {init_mode}")


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
