"""Full-3D carry and init, port of :mod:`mcqueens.kernels.full3d_pallas`.

The JAX module holds the per-chain full-3D kernel (``_kernel``: exact
rejection sampling over an occupancy bitfield, one O(Q) pass per step) and
the carry/init that the shared-site sampler
(:mod:`mcqueens_torch.kernels.full3d_shared`) also starts from.  Only the
carry and init are ported here; the per-chain kernel is still to port
(ROADMAP.md queue 2 item 4), so nothing in this module launches a kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import fastinit
from mcqueens_torch.core import tables as tables_mod
from mcqueens_torch.kernels import sizing
from mcqueens_torch.kernels.carry import Full3DCarry

DEFAULT_BLOCK = 2048


def _qs(Q: int) -> int:
    return -(-Q // 8) * 8


def _occ_words(N: int) -> int:
    return -(-(N ** 3) // 32)


def block_size(n_chains: int, spec=None) -> int:
    """Chains per block of the per-chain kernel: the JAX package's partition
    (6 (QS, block) coordinate layouts plus the (N^3/32, block) occupancy
    bitmap in its VMEM estimate)."""
    cap = DEFAULT_BLOCK
    if spec is not None:
        cap = sizing.block_cap(6 * _qs(spec.q_eff) + _occ_words(spec.N),
                               DEFAULT_BLOCK)
    return sizing.block_size(n_chains, cap)


def padded_chains(n_chains: int, spec=None) -> int:
    blk = block_size(n_chains, spec)
    return -(-n_chains // blk) * blk


def occupancy(queens: torch.Tensor, N: int) -> torch.Tensor:
    """(C, ceil(N^3/32)) int32 bitfield: bit ``cell % 32`` of word
    ``cell // 32`` is set for every occupied cell (bit 31 gives the word's
    sign, as the JAX package's int32 shifts do)."""
    q = queens.to(torch.int64)
    cells = (q[..., 0] * N + q[..., 1]) * N + q[..., 2]
    words = torch.zeros((q.shape[0], _occ_words(N)), dtype=torch.int64,
                        device=queens.device)
    words.scatter_add_(1, cells // 32, torch.ones_like(cells) << (cells % 32))
    # Distinct cells set distinct bits, so the sum is the bitwise or.
    return (((words + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


def init_carry_batch(seeds, spec: ChainSpec, block: int | None = None,
                     initial_states=None, *, device) -> Full3DCarry:
    """Carry on ``device`` from per-chain integer seeds, padded to whole
    blocks.

    Padding chains get seeds ``seeds[-1] + 1 + arange`` (uint32) and, with
    ``initial_states`` ((C0, Q, 3) queens), repeat the last warm start.
    Block ``b`` gets the seed ``int32(seeds[0]) + 104729 * b``.
    """
    seeds = np.asarray(seeds).astype(np.uint32)
    C0 = seeds.shape[0]
    if block is None:
        block = block_size(C0, spec)
    C = -(-C0 // block) * block
    if C > C0:
        seeds = np.concatenate(
            [seeds, seeds[-1] + np.arange(1, C - C0 + 1, dtype=np.uint32)])
    n_blocks = C // block
    seeds_t = torch.from_numpy(seeds.view(np.int32).copy()).to(device)
    N, Q = spec.N, spec.q_eff
    if initial_states is not None:
        queens = torch.as_tensor(np.asarray(initial_states, np.int32),
                                 device=device)
        if C > queens.shape[0]:
            queens = torch.cat([queens, queens[-1:].expand(
                C - queens.shape[0], Q, 3)])
    else:
        queens = fastinit.full3d_init_batch(seeds_t, N, spec.init_mode, Q)
    qi, qj, qk = (queens[..., a].contiguous() for a in range(3))
    e0 = tables_mod.batch_energies(
        queens, lambda q: tables_mod.table_energy(
            tables_mod.build_full3d_table(q, N)))[:, None].to(torch.int32)
    block_seeds = (int(seeds_t[0]) + 104729 * torch.arange(
        n_blocks, dtype=torch.int32, device=device))[:, None]
    zeros = torch.zeros((C, 1), dtype=torch.int32, device=device)
    return Full3DCarry(
        block_seeds=block_seeds,
        chain_seeds=seeds_t[:, None].clone(),
        qi=qi, qj=qj, qk=qk,
        occ=occupancy(queens, N),
        best_qi=qi.clone(), best_qj=qj.clone(), best_qk=qk.clone(),
        energy=e0,
        best_energy=e0.clone(),
        best_step=zeros,
        no_improve=zeros.clone(),
        stop_step=zeros + spec.n_steps,
        accept_bins=torch.zeros((C, spec.n_bins), dtype=torch.int32,
                                device=device),
        total_bins=torch.zeros((C, spec.n_bins), dtype=torch.int32,
                               device=device),
    )
