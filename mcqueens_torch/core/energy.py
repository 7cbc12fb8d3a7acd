"""Attack predicate and oracle energies, port of :mod:`mcqueens.core.energy`.

Two queens attack iff one of the 7 relations of the reference holds (board
mode drops ``same_ij``).  These O(N^4) / O(Q^2) forms are the oracle the
samplers' incremental energies are checked against; they never run in the
hot loop.
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


def _batched(x, device) -> torch.Tensor:
    """An int or a batch-shaped tensor, with a trailing axis to broadcast
    against the cells or queens of each state."""
    return torch.as_tensor(x, device=device)[..., None]


def board_conflicts(heights: torch.Tensor, i, j, k) -> torch.Tensor:
    """Queens of boards ``(..., N, N)`` attacking the hypothetical position
    ``(i, j, k)``, the queen of column ``(i, j)`` itself excluded; ``i, j,
    k`` are ints or tensors of the batch shape."""
    N = heights.shape[-1]
    ii = torch.arange(N, dtype=torch.int32, device=heights.device)
    i_flat, j_flat = (g.reshape(-1) for g in
                      torch.meshgrid(ii, ii, indexing="ij"))
    h = heights.reshape(heights.shape[:-2] + (N * N,)).to(torch.int32)
    i, j, k = (_batched(x, heights.device) for x in (i, j, k))
    att = attacks((i, j, k), (i_flat, j_flat, h), board_mode=True)
    self_mask = (i_flat == i) & (j_flat == j)
    return (att & ~self_mask).sum(-1, dtype=torch.int32)


def full3d_energy(queens: torch.Tensor) -> torch.Tensor:
    """Pairwise energy of full-3D states ``(..., Q, 3)`` -> ``(...)`` int32."""
    q = queens.to(torch.int32)
    i, j, k = q[..., 0], q[..., 1], q[..., 2]
    att = attacks(
        (i[..., :, None], j[..., :, None], k[..., :, None]),
        (i[..., None, :], j[..., None, :], k[..., None, :]),
    )
    return torch.triu(att, diagonal=1).sum(dim=(-2, -1), dtype=torch.int32)


def full3d_conflicts(queens: torch.Tensor, q_idx, pos) -> torch.Tensor:
    """Conflicts of queen ``q_idx`` of states ``(..., Q, 3)`` if placed at
    ``pos`` (an ``(i, j, k)`` triple), every other queen counted; ``q_idx``
    and the coordinates are ints or tensors of the batch shape."""
    q = queens.to(torch.int32)
    pos = tuple(_batched(x, q.device) for x in pos)
    att = attacks(pos, (q[..., 0], q[..., 1], q[..., 2]))
    mask = (torch.arange(q.shape[-2], device=q.device)
            != _batched(q_idx, q.device))
    return (att & mask).sum(-1, dtype=torch.int32)
