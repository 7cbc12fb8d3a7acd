"""Line-family count tables, port of :mod:`mcqueens.core.tables`.

For distinct cells the 7 attack relations are mutually exclusive and each is
a family of parallel lines, so ``E = sum over lines of C(count, 2)``.  The
port uses the tables to score initial boards and full-3D placements (plain
torch ``scatter_add_``:
the JAX package leaves this to XLA too, so there is no kernel here), and the
``tables`` scan samplers' plain-torch twins score moves with
:func:`board_delta_e` / :func:`full3d_delta_e` and apply them with
:func:`apply_move`, batched over chains (the CUDA kernels
``csrc/board_scan.cu`` and ``full3d_scan.cu`` do the same per chain).
"""

from __future__ import annotations

import torch

N_BOARD_FAMILIES = 12
N_FULL_FAMILIES = 13


def family_sizes(N: int, full3d: bool = False):
    """Flat size of each family's count table."""
    D = 2 * N - 1
    sizes = [N * N, N * N] + [N * D] * 6 + [D * D] * 4
    if full3d:
        sizes.append(N * N)
    return sizes


def family_offsets(N: int, full3d: bool = False):
    """Start offset of each family within the flat table."""
    offs = [0]
    for s in family_sizes(N, full3d)[:-1]:
        offs.append(offs[-1] + s)
    return offs


def table_size(N: int, full3d: bool = False) -> int:
    return sum(family_sizes(N, full3d))


def line_indices(i, j, k, N: int, full3d: bool = False) -> torch.Tensor:
    """Flat table indices of the 12 (13) lines through cell (i, j, k).

    ``i, j, k`` are equally-shaped (or broadcastable) int tensors; the
    family axis is appended last.
    """
    D = 2 * N - 1
    offs = family_offsets(N, full3d)
    idx = [
        offs[0] + i * N + k,                       # ik
        offs[1] + j * N + k,                       # jk
        offs[2] + k * D + (i - j + N - 1),         # k_dm
        offs[3] + k * D + (i + j),                 # k_dp
        offs[4] + j * D + (i - k + N - 1),         # j_dm
        offs[5] + j * D + (i + k),                 # j_dp
        offs[6] + i * D + (j - k + N - 1),         # i_dm
        offs[7] + i * D + (j + k),                 # i_dp
        offs[8] + (j - i + N - 1) * D + (k - i + N - 1),   # s_mm
        offs[9] + (j - i + N - 1) * D + (k + i),           # s_mp
        offs[10] + (j + i) * D + (k - i + N - 1),          # s_pm
        offs[11] + (j + i) * D + (k + i),                  # s_pp
    ]
    if full3d:
        idx.append(offs[12] + i * N + j)           # ij
    idx = torch.broadcast_tensors(*idx)
    return torch.stack(idx, dim=-1)


def build_board_table(heights: torch.Tensor) -> torch.Tensor:
    """Count tables ``(..., table_size)`` int32 of board states ``(..., N, N)``."""
    N = heights.shape[-1]
    batch = heights.shape[:-2]
    ii = torch.arange(N, dtype=torch.int64, device=heights.device)
    i_g, j_g = (g.reshape(-1) for g in torch.meshgrid(ii, ii, indexing="ij"))
    k = heights.reshape(batch + (N * N,)).to(torch.int64)
    idx = line_indices(i_g, j_g, k, N).reshape(batch + (-1,))
    table = torch.zeros(batch + (table_size(N),), dtype=torch.int32,
                        device=heights.device)
    return table.scatter_add_(-1, idx, torch.ones_like(idx, dtype=torch.int32))


def build_full3d_table(queens: torch.Tensor, N: int) -> torch.Tensor:
    """Count tables ``(..., table_size)`` int32 of full-3D states
    ``(..., Q, 3)`` (distinct cells)."""
    batch = queens.shape[:-2]
    q = queens.to(torch.int64)
    idx = line_indices(q[..., 0], q[..., 1], q[..., 2], N,
                       full3d=True).reshape(batch + (-1,))
    table = torch.zeros(batch + (table_size(N, full3d=True),),
                        dtype=torch.int32, device=queens.device)
    return table.scatter_add_(-1, idx, torch.ones_like(idx, dtype=torch.int32))


def table_energy(table: torch.Tensor) -> torch.Tensor:
    """E = sum over lines of C(count, 2), over the last axis, as int32."""
    t = table.to(torch.int32)
    return (t * (t - 1) // 2).sum(dim=-1, dtype=torch.int32)


def batch_energies(states: torch.Tensor, energy_fn,
                   chunk: int = 8192) -> torch.Tensor:
    """``energy_fn`` over axis 0 in slices of at most ``chunk`` states.

    ``energy_fn`` maps a batch of states to their energies.  The slices
    bound the (chunk, table_size) scratch: a whole 32768-board batch at
    N=16 would hold ~1 GB of int32 tables at once, a 65536-chain full-3D
    batch at N=15 ~1.7 GB.
    """
    return torch.cat([energy_fn(states[s:s + chunk])
                      for s in range(0, states.shape[0], chunk)])


def _line_sums(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table.gather(-1, idx.long()).sum(-1, dtype=torch.int32)


def board_delta_e(table, i, j, old_k, new_k, N: int):
    """Energy deltas of moving each chain's (i, j) queen from ``old_k`` to
    ``new_k != old_k``; ``table`` is ``(C, T)``, the rest ``(C,)``.

    old conflicts = the 12 line counts through the old cell - 12 (the queen
    sits on all of them); new conflicts = the counts through the new cell
    (it shares none of the old cell's lines).  Returns ``(dE, idx_old,
    idx_new)``.
    """
    idx_old = line_indices(i, j, old_k, N)
    idx_new = line_indices(i, j, new_k, N)
    d_e = _line_sums(table, idx_new) - (_line_sums(table, idx_old)
                                        - N_BOARD_FAMILIES)
    return d_e, idx_old, idx_new


def apply_move(table, idx_old, idx_new, accept):
    """Move each accepting chain's queen off its ``idx_old`` lines onto its
    ``idx_new`` lines, in place; returns ``table``.  Old and new lines may
    overlap (full_3d, when the old cell attacks the new one): the adds
    accumulate, so the net update is still right."""
    d = accept.to(torch.int32)[:, None].expand(idx_old.shape)
    table.scatter_add_(-1, idx_old.long(), -d)
    table.scatter_add_(-1, idx_new.long(), d)
    return table


def full3d_delta_e(table, old_pos, new_pos, N: int):
    """Energy deltas of moving each chain's queen from ``old_pos`` to a
    distinct ``new_pos`` (``(i, j, k)`` triples of ``(C,)`` tensors).

    The new cell's line counts include the moving queen itself exactly when
    the old cell attacks the new one (one shared line, by mutual
    exclusivity), so that term is taken off.
    """
    from mcqueens_torch.core.energy import attacks

    idx_old = line_indices(*old_pos, N, full3d=True)
    idx_new = line_indices(*new_pos, N, full3d=True)
    old_attacks_new = attacks(old_pos, new_pos).to(torch.int32)
    old_conf = _line_sums(table, idx_old) - N_FULL_FAMILIES
    new_conf = _line_sums(table, idx_new) - old_attacks_new
    return new_conf - old_conf, idx_old, idx_new
