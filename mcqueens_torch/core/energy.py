"""Attack predicate and oracle board energy, port of :mod:`mcqueens.core.energy`.

Two queens attack iff one of the 7 relations of the reference holds (board
mode drops ``same_ij``).  These O(N^4) forms are the oracle the sampler's
incremental energies are checked against; they never run in the hot loop.
"""

from __future__ import annotations

import torch


def attacks(p1, p2, board_mode: bool = False) -> torch.Tensor:
    """Elementwise attack predicate between broadcastable (i, j, k) triples.

    A queen "attacks" itself under this predicate; callers mask the
    diagonal.
    """
    i1, j1, k1 = p1
    i2, j2, k2 = p2
    di = (i1 - i2).abs()
    dj = (j1 - j2).abs()
    dk = (k1 - k2).abs()
    same_i = i1 == i2
    same_j = j1 == j2
    same_k = k1 == k2
    out = (
        (same_i & same_k)            # same_ik
        | (same_j & same_k)          # same_jk
        | (same_k & (di == dj))      # plane_k_diag
        | (same_j & (di == dk))      # plane_j_diag
        | (same_i & (dj == dk))      # plane_i_diag
        | ((di == dj) & (dj == dk))  # space_diag
    )
    if not board_mode:
        out = out | (same_i & same_j)  # same_ij
    return out


def board_energy(heights: torch.Tensor) -> torch.Tensor:
    """Pairwise energy of board states ``(..., N, N)`` -> ``(...)`` int32."""
    N = heights.shape[-1]
    ii = torch.arange(N, dtype=torch.int32, device=heights.device)
    i_flat, j_flat = (g.reshape(-1) for g in
                      torch.meshgrid(ii, ii, indexing="ij"))
    k = heights.reshape(heights.shape[:-2] + (N * N,)).to(torch.int32)
    att = attacks(
        (i_flat[:, None], j_flat[:, None], k[..., :, None]),
        (i_flat[None, :], j_flat[None, :], k[..., None, :]),
        board_mode=True,
    )
    return torch.triu(att, diagonal=1).sum(dim=(-2, -1), dtype=torch.int32)
