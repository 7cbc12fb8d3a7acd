"""Initial states from seeds and energies of states, in plain torch.

A board holds N^2 queens, one at height ``h[i, j]`` above each cell (i, j);
a full-3D placement holds Q queens on distinct cells of the N^3 cube.  Two
queens attack when the step between them is a multiple of one of the 13
directions of the cube (every nonzero coordinate distance equal), whatever
lies between them.  The energy is the number of attacking pairs.  Each
direction's lines are told apart by two coordinates that are constant along
them, so a state's energy is the sum over every line of C(count, 2).
"""

from __future__ import annotations

import itertools

import torch

from benchmark.reference import hashing as H

# The 13 directions of the cube, one of each opposite pair.
DIRECTIONS = tuple(d for d in itertools.product((-1, 0, 1), repeat=3)
                   if d > (0, 0, 0))


def line_keys(i, j, k, N: int, d):
    """An id, unique within direction ``d``, of the line along ``d``
    through each cell (i, j, k)."""
    # Two independent combinations that are constant along d.
    basis = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    inv = []
    for b in basis:
        # b x d, a vector perpendicular to d; its dot product with a cell is
        # constant along d.
        c = (b[1] * d[2] - b[2] * d[1], b[2] * d[0] - b[0] * d[2],
             b[0] * d[1] - b[1] * d[0])
        if any(c) and all(c != x and tuple(-y for y in c) != x for x in inv):
            inv.append(c)
    a, b = inv[:2]
    span = 4 * N
    ka = a[0] * i + a[1] * j + a[2] * k + 2 * N
    kb = b[0] * i + b[1] * j + b[2] * k + 2 * N
    return ka * span + kb


def energies(cells: torch.Tensor, N: int, chunk: int = 4096) -> torch.Tensor:
    """(C,) int64 energies of ``cells`` (C, Q, 3) (i, j, k) queens, all
    distinct within a state, in slices of ``chunk`` states."""
    out = []
    span = 4 * N
    for s in range(0, cells.shape[0], chunk):
        q = cells[s:s + chunk].to(torch.int64)
        C = q.shape[0]
        i, j, k = q[..., 0], q[..., 1], q[..., 2]
        row = torch.arange(C, device=q.device)[:, None] * (span * span)
        e = torch.zeros(C, dtype=torch.int64, device=q.device)
        for d in DIRECTIONS:
            key = (row + line_keys(i, j, k, N, d)).reshape(-1)
            n = torch.bincount(key, minlength=C * span * span)
            e += (n * (n - 1) // 2).reshape(C, -1).sum(1)
        out.append(e)
    return torch.cat(out)


def board_cells(heights: torch.Tensor) -> torch.Tensor:
    """(C, N^2, 3) queens of (C, N, N) boards."""
    C, N = heights.shape[0], heights.shape[-1]
    ii = torch.arange(N, device=heights.device)
    i, j = torch.meshgrid(ii, ii, indexing="ij")
    return torch.stack([i.expand(C, N, N), j.expand(C, N, N),
                        heights.to(torch.int64)], -1).reshape(C, N * N, 3)


def _hash2(seeds: torch.Tensor, n: int, salt: int) -> torch.Tensor:
    """(C, n) uint32 hashes of every (seed, index) pair."""
    idx = torch.arange(n, dtype=torch.int64, device=seeds.device)
    hs = H.mix(seeds ^ ((salt * H.SALT_MUL + 1) & H.MASK))
    hi = H.mix((idx + H.IDX_SALT) & H.MASK)
    return H.mix(hs[:, None] ^ H.mul32(hi, H.STEP_K)[None, :])


def board_init(seeds: torch.Tensor, N: int) -> torch.Tensor:
    """(C, N, N) random initial heights of chains with uint32 ``seeds``
    (an int64 tensor)."""
    return (_hash2(seeds, N * N, 0) % N).reshape(-1, N, N)


def full3d_init(seeds: torch.Tensor, N: int, Q: int,
                chunk: int = 2048) -> torch.Tensor:
    """(C, Q, 3) random initial placements: each chain's Q cells of lowest
    hash score, ties to the lower cell id."""
    N3 = N ** 3
    cells = torch.cat([
        torch.sort(_hash2(seeds[s:s + chunk], N3, 2), dim=1,
                   stable=True).indices[:, :Q]
        for s in range(0, seeds.shape[0], chunk)])
    return torch.stack([cells // (N * N), (cells // N) % N, cells % N], -1)
