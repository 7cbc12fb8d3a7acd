"""Dense board delta-E identity, port of :mod:`mcqueens.kernels.delta_e`.

For distinct (i, j) columns the six board attack relations are mutually
exclusive, so with z=(dk==0), t1=(dj==dk), t2=(di==dk), a=(di==0),
b=(dj==0), e=(di==dj) the move delta of column (i, j) from old_k to new_k is

    dE = sum over all N^2 cells of
         s*(z_n - z_o) + b*(t2_n - t2_o) + (a+e)*(t1_n - t1_o)  + 6

with s = a+b+e; the +6 cancels the moving column's own cell.  This is the
plain-torch reference the per-chain board sampler's twin
(:func:`mcqueens_torch.kernels.metropolis_pallas.segment_reference`) and the
tests evaluate; the CUDA kernel sums the same integrand over the four lines
through (i, j) only, the cells where it can be nonzero.
"""

from __future__ import annotations

import torch


def board_delta_e_dense(heights_flat, i_grid, j_grid, i, j, old_k, new_k):
    """delta-E of moving column (i, j) from old_k to new_k (!= old_k).

    Args:
        heights_flat: (..., N*N) integer heights.
        i_grid, j_grid: (N*N,) cell coordinates.
        i, j, old_k, new_k: (..., 1) per-chain integers.

    Returns:
        (..., 1) int32 delta-E (chains leading, cells last, as in JAX).
    """
    di = (i_grid - i).abs()
    dj = (j_grid - j).abs()
    a = (di == 0).int()
    b = (dj == 0).int()
    e = (di == dj).int()
    s = a + b + e
    ae = a + e
    dko = (heights_flat - old_k).abs()
    dkn = (heights_flat - new_k).abs()
    dz = (dkn == 0).int() - (dko == 0).int()
    dt1 = (dj == dkn).int() - (dj == dko).int()
    dt2 = (di == dkn).int() - (di == dko).int()
    integrand = s * dz + b * dt2 + ae * dt1
    return integrand.sum(-1, keepdim=True, dtype=torch.int32) + 6
