"""State initializers, port of :mod:`mcqueens.core.init`.

Reference semantics (``mcmc_board.py:26-57``, ``mcmc.py:20-101``):

    latin    k = (i + j) mod N
    klarner  k = (3i + 5j) mod N when gcd(N, 210) == 1; otherwise an MxM
             Klarner core with the largest M < N such that gcd(M, 210) == 1,
             the rest random
    random   board: uniform height per (i, j);
             full_3d: Q distinct cells uniform over the N^3 cube.

The functions take a batch of threefry keys (``(C, 2)``, see
:mod:`mcqueens_torch.core.rng`) and draw exactly what the JAX functions draw
per key, so the scan samplers start from the same states.  The two sorts
(``permutation`` of the N^3 cells, and the argsort of uniforms that places
the Klarner fallback's extra queens) are stable, as XLA's are.  The Pallas
samplers use the hash-based :mod:`mcqueens_torch.core.fastinit` instead.
"""

from __future__ import annotations

import math

import torch

from mcqueens_torch.core import rng

INIT_MODES = ("random", "latin", "klarner")


def _klarner_core_m(N: int) -> int:
    """Largest M < N with gcd(M, 210) == 1."""
    for m in range(N - 1, 0, -1):
        if math.gcd(m, 210) == 1:
            return m
    raise ValueError(f"Could not find M < {N} with gcd(M,210)==1 (N={N}).")


def _grids(N: int, device):
    ii = torch.arange(N, dtype=torch.int32, device=device)
    return torch.meshgrid(ii, ii, indexing="ij")


def board_init(keys: torch.Tensor, N: int, init_mode: str) -> torch.Tensor:
    """Initial heights ``(C, N, N)`` int32, one board per key of ``keys``
    ``(C, 2)``."""
    C = keys.shape[0]
    i_g, j_g = _grids(N, keys.device)
    if init_mode == "random":
        return rng.randint(keys, (N, N), 0, N)
    if init_mode == "latin":
        return ((i_g + j_g) % N).expand(C, N, N).contiguous()
    if init_mode == "klarner":
        if math.gcd(N, 210) == 1:
            return ((3 * i_g + 5 * j_g) % N).expand(C, N, N).contiguous()
        M = _klarner_core_m(N)
        core = (3 * i_g + 5 * j_g) % M
        rand = rng.randint(keys, (N, N), 0, N)
        in_core = (i_g < M) & (j_g < M)
        return torch.where(in_core, core, rand)
    raise ValueError(f"Unknown init_mode: {init_mode}")


def _cells_to_queens(cells: torch.Tensor, N: int) -> torch.Tensor:
    """Flat cell ids ``(..., Q)`` -> ``(..., Q, 3)`` int32 coordinates."""
    return torch.stack([cells // (N * N), (cells // N) % N, cells % N],
                       dim=-1).to(torch.int32)


def queens_to_cells(queens: torch.Tensor, N: int) -> torch.Tensor:
    """Inverse of :func:`_cells_to_queens`: int64 flat cell ids."""
    q = queens.long()
    return q[..., 0] * N * N + q[..., 1] * N + q[..., 2]


def _ijk_queens(N: int, k_g: torch.Tensor, device) -> torch.Tensor:
    i_g, j_g = _grids(N, device)
    return torch.stack([i_g.reshape(-1), j_g.reshape(-1), k_g.reshape(-1)],
                       dim=1).to(torch.int32)


def full3d_init(keys: torch.Tensor, N: int, init_mode: str,
                Q: int | None = None):
    """Initial ``(queens (C, Q, 3) int32, occupancy (C, N^3) bool)``, one
    state per key.  latin/klarner require Q == N^2 (reference
    ``mcmc.py:22-26``)."""
    if Q is None:
        Q = N * N
    N3 = N * N * N
    C, dev = keys.shape[0], keys.device
    if init_mode in ("latin", "klarner") and Q != N * N:
        raise ValueError(
            f"{init_mode} initialization assumes Q = N^2, got Q={Q}, "
            f"N^2={N * N}.")
    if init_mode == "random":
        if Q > N3:
            raise ValueError(f"Q={Q} cannot exceed N^3={N3}.")
        # Uniform distinct cells: random ranking of all cells, the first Q.
        queens = _cells_to_queens(rng.permutation(keys, N3)[:, :Q], N)
    elif init_mode == "latin":
        i_g, j_g = _grids(N, dev)
        queens = _ijk_queens(N, (i_g + j_g) % N, dev).expand(C, Q, 3)
    elif init_mode == "klarner":
        i_g, j_g = _grids(N, dev)
        if math.gcd(N, 210) == 1:
            queens = _ijk_queens(N, (3 * i_g + 5 * j_g) % N, dev).expand(
                C, Q, 3)
        else:
            # M x M Klarner core; the other Q - M^2 queens on uniformly
            # random distinct non-core cells (core cells ranked last).
            M = _klarner_core_m(N)
            ci, cj = _grids(M, dev)
            core = _ijk_queens(M, (3 * ci + 5 * cj) % M, dev)
            core_mask = torch.zeros(N3, dtype=torch.float32, device=dev)
            core_mask[queens_to_cells(core, N)] = 1.0
            scores = rng.uniform(keys, (N3,)) + core_mask * 2.0
            order = torch.sort(scores, dim=-1, stable=True)[1]
            extra = _cells_to_queens(order[:, :Q - M * M], N)
            queens = torch.cat([core.expand(C, M * M, 3), extra], dim=1)
    else:
        raise ValueError(f"Unknown init_mode: {init_mode}")
    queens = queens.contiguous()
    occ = torch.zeros((C, N3), dtype=torch.bool, device=dev)
    occ.scatter_(1, queens_to_cells(queens, N), True)
    return queens, occ
