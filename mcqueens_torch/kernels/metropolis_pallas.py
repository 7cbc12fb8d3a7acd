"""Per-chain board Metropolis, port of :mod:`mcqueens.kernels.metropolis_pallas`.

Every chain draws its own proposal from its seed's counter stream
(:mod:`mcqueens_torch.kernels.prng`): with ``w0, w1 = step_words(g, step)``
the site is ``i = w0 % N``, ``j = (w0 // N) % N``, the new height
``(old + 1 + (w0 // N^2) % (N - 1)) % N``, and the accept word ``w1``.
dE is the dense identity of :mod:`mcqueens_torch.kernels.delta_e`; a chain
accepts when ``u < exp(-beta(step) * dE)``.  Patience early-stop, exact best
boards (``best_step = step + 1``) and per-bin accept/total counts follow the
JAX kernel step for step.  No stream is shared between chains, so
trajectories do not depend on the block partition; the carry is still padded
to whole blocks of :func:`block_size`, exactly as JAX pads it, so the two
carries compare field for field.

One chunk of ``n_inner`` steps has two implementations over the same
chains-major state (:class:`SegmentState`), both updating it in place:

  * :func:`segment_cuda` launches the hand-written CUDA kernel
    (``csrc/metropolis.cu``: a team of lanes a chain, proposals drawn a
    batch ahead, boards as bytes in shared memory) through
    :func:`launch_segment`, laid out by :func:`layout`, and counts the
    launch in :data:`KERNEL_LAUNCHES`;
  * :func:`segment_reference` is its plain-torch twin (vectorised over
    chains, a Python loop over steps, the dense O(N^2) dE).

:mod:`mcqueens_torch.kernels.segment` chooses one by the state's device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import sys
import math

import torch

from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.kernels import (_build, board_shared, delta_e, prng,
                                    segment, sizing)
from mcqueens_torch.kernels.carry import BoardCarry
from mcqueens_torch.utils import profiling

DEFAULT_BLOCK = 2048

# Launches of the CUDA kernel in this process (segment.launch counts them;
# read and reset by callers that check the main path ran on the card).
KERNEL_LAUNCHES = 0
_SAMPLER = sys.modules[__name__]


def _nns(N: int) -> int:
    """N^2 padded up to a multiple of 8 (the JAX kernel's sublane rows)."""
    return -(-(N * N) // 8) * 8


def block_size(n_chains: int, spec=None) -> int:
    """Chains per block: the JAX package's partition (2 (NNS, block)
    layouts in its VMEM estimate).  It fixes only the padding and the
    ``block_seeds`` shape: every stream is keyed by its chain's own seed."""
    cap = DEFAULT_BLOCK
    if spec is not None:
        cap = sizing.block_cap(2 * _nns(spec.N), DEFAULT_BLOCK)
    return sizing.block_size(n_chains, cap)


def padded_chains(n_chains: int, spec=None) -> int:
    blk = block_size(n_chains, spec)
    return -(-n_chains // blk) * blk


def init_carry_batch(seeds, spec: ChainSpec, block: int | None = None,
                     initial_states=None, *, device) -> BoardCarry:
    """Carry on ``device`` from per-chain integer seeds, padded to whole
    blocks of :func:`block_size` (padding and block seeds as in
    :func:`board_shared.init_carry_batch`)."""
    if block is None:
        block = block_size(len(seeds), spec)
    return board_shared.init_carry_batch(
        seeds, spec, block=block, initial_states=initial_states,
        device=device)


@dataclasses.dataclass
class SegmentState:
    """One segment's working state, chains major (contiguous int32), as the
    carry holds it: a CTA of the CUDA kernel loads its chains' boards as one
    contiguous run.  The chunk implementations update it in place."""

    heights: torch.Tensor       # (C, N*N)
    best_heights: torch.Tensor  # (C, N*N)
    energy: torch.Tensor        # (C,)
    best_energy: torch.Tensor   # (C,)
    best_step: torch.Tensor     # (C,)
    no_improve: torch.Tensor    # (C,)
    stop_step: torch.Tensor     # (C,)
    accept_bins: torch.Tensor   # (C, n_bins)
    total_bins: torch.Tensor    # (C, n_bins)
    chain_seeds: torch.Tensor   # (C,)


_ROWS = ("energy", "best_energy", "best_step", "no_improve", "stop_step",
         "chain_seeds")
_PLANES = ("heights", "best_heights", "accept_bins", "total_bins")


def segment_state(carry: BoardCarry) -> SegmentState:
    """A fresh :class:`SegmentState` holding copies of the carry's fields;
    raises ``ValueError`` unless every height lies in [0, N)
    (:func:`board_shared.check_heights`: the CUDA kernel keeps a board as
    bytes)."""
    with profiling.span("mcq.transpose"):
        board_shared.check_heights(carry.heights,
                                   math.isqrt(carry.heights.shape[1]))
        kw = {name: getattr(carry, name).clone().contiguous()
              for name in _PLANES}
        kw.update({name: getattr(carry, name).reshape(-1).clone()
                   for name in _ROWS})
        return SegmentState(**kw)


def carry_of(st: SegmentState, block_seeds: torch.Tensor) -> BoardCarry:
    """Inverse of :func:`segment_state`; ``block_seeds`` passes through."""
    with profiling.span("mcq.transpose"):
        kw = {name: getattr(st, name) for name in _PLANES}
        kw.update({name: getattr(st, name)[:, None] for name in _ROWS})
        return BoardCarry(block_seeds=block_seeds, **kw)


def segment_reference(st: SegmentState, step0: int, n_inner: int,
                      spec: ChainSpec, beta: torch.Tensor) -> None:
    """Plain-torch twin of the CUDA kernel: advance every chain by
    ``n_inner`` steps from global step ``step0``, in place."""
    N, NN = spec.N, spec.N * spec.N
    nb, n_steps = spec.n_bins, spec.n_steps
    patience = spec.early_stop_patience
    dev = st.energy.device
    cell = torch.arange(NN, dtype=torch.int32, device=dev)
    i_grid, j_grid = cell // N, cell % N
    g = prng.chain_streams(st.chain_seeds)
    h, bh = st.heights, st.best_heights
    e, be, bs = st.energy.clone(), st.best_energy.clone(), st.best_step.clone()
    ni, stp = st.no_improve.clone(), st.stop_step.clone()
    # Steps at or past n_steps are inactive for every chain: nothing changes.
    for t in range(max(0, min(n_inner, n_steps - step0))):
        gstep = step0 + t
        active = stp >= n_steps
        w0, w1 = prng.step_words(g, gstep)
        i, j = w0 % N, (w0 // N) % N
        kr = (w0 // NN) % (N - 1)
        u = prng.uniform01(w1)
        site = (i * N + j)[:, None].long()
        old = h.gather(1, site)
        new = (old + 1 + kr[:, None]) % N
        de = delta_e.board_delta_e_dense(h, i_grid, j_grid, i[:, None],
                                         j[:, None], old, new)[:, 0]
        accept = u < torch.exp(-beta[t] * de.to(torch.float32))
        upd = accept & active
        h.scatter_(1, site, torch.where(upd[:, None], new, old))
        e = e + torch.where(upd, de, 0)
        improved = upd & (e < be)
        bh.copy_(torch.where(improved[:, None], h, bh))
        be = torch.where(improved, e, be)
        bs = torch.where(improved, gstep + 1, bs)
        ni = torch.where(active, torch.where(improved, 0, ni + 1), ni)
        if patience is not None:
            stp = torch.where(active & (ni >= patience), gstep, stp)
        b = min(gstep * nb // n_steps, nb - 1)
        st.accept_bins[:, b] += upd.int()
        st.total_bins[:, b] += active.int()
    for name, val in (("energy", e), ("best_energy", be), ("best_step", bs),
                      ("no_improve", ni), ("stop_step", stp)):
        getattr(st, name).copy_(val)


# Lanes a chain, registers a thread (csrc/metropolis.cu:
# __launch_bounds__(1024, 1) holds every instance to 64 registers), threads a
# CTA, and the largest N the kernel takes (the repo's configurations need
# N <= 32).
LANES = (1, 2, 4, 8, 16, 32)
REGISTERS = 64
MAX_THREADS_PER_CTA = 1024
MAX_N = 170
Layout = segment.Layout
# The rule's cost model (segment.TeamModel, a unit a row offset of the four
# lines), fitted to every team size timed on the card at the main paths'
# launches (pair_scan_slice.py --only metropolis; each team size's times
# are in docs/PERF_HISTORY.md).
MODEL = segment.TeamModel(
    per_unit=95, per_step=95, per_draw=60, unit_lat=150, step_lat=450,
    sum_lat=18, redux_lat=25, overlap=0.2, registers=REGISTERS,
    max_threads=MAX_THREADS_PER_CTA)


def row_pitch(N: int) -> int:
    """Bytes of a board row in shared memory: N rounded up to an odd number
    of words, so that a team's column reads fall in different banks."""
    return 4 * (-(-N // 4) | 1)


def board_bytes(N: int) -> int:
    """Bytes of a board in shared memory: N rows, whole 16-byte words."""
    return -(-(N * row_pitch(N)) // 16) * 16


def slot_bytes(N: int) -> int:
    """Shared-memory bytes of one chain: its board and its best board, an
    odd number of 16-byte words."""
    return 16 * (2 * board_bytes(N) // 16 | 1)


def cta_smem_bytes(N: int, chains_per_cta: int) -> int:
    """Shared memory of a CTA: a slot and a flag word per chain."""
    return chains_per_cta * (slot_bytes(N) + 4)


def check_n(N: int) -> None:
    if not 2 <= N <= MAX_N:
        raise ValueError(f"the metropolis CUDA kernel takes 2 <= N <= "
                         f"{MAX_N}, got N={N}")


@functools.cache
def layout(N: int, C: int, n_sm: int, lanes: int | None = None) -> Layout:
    """The CUDA kernel's layout for ``C`` chains of board size ``N`` on a
    card of ``n_sm`` SMs: the team size (or the given ``lanes``) and chains
    a CTA (lanes times chains a CTA a power of two from 32 to 1024, the
    CTA's slots within a block's shared memory) of least cost
    (:data:`MODEL`).  Few chains take large teams (a step's latency), many
    chains small ones (each warp instruction serves 32 / L chains), and a
    layout whose last wave is nearly empty pays for a whole wave.  Ties go
    to fewer chains a CTA (more SMs), then fewer lanes."""
    check_n(N)
    return MODEL.layout(N, C, n_sm, LANES if lanes is None else (lanes,),
                        lambda L, cpb: cta_smem_bytes(N, cpb))


def launch_segment(lib, st: SegmentState, step0: int, n_inner: int,
                   spec: ChainSpec, beta: torch.Tensor, *, n_sm: int,
                   stream: int = 0, forced: Layout | None = None) -> Layout:
    """Check a chunk's arguments, lay it out for ``n_sm`` SMs
    (:func:`layout`, or ``forced``) and call ``lib.mcq_metropolis_segment``
    on ``stream``; raises if it returns an error.  ``lib`` is the CUDA
    library (:func:`segment_cuda`) or its host emulation
    (:mod:`mcqueens_torch.kernels.host_emulation`, CPU tensors).  Returns
    the layout."""
    NN, C, nb = spec.N * spec.N, st.energy.shape[0], spec.n_bins
    i32 = torch.int32
    _build.check_args(st.heights.device, {
        "heights": (st.heights, (C, NN), i32),
        "best_heights": (st.best_heights, (C, NN), i32),
        "accept_bins": (st.accept_bins, (C, nb), i32),
        "total_bins": (st.total_bins, (C, nb), i32),
        **{name: (getattr(st, name), (C,), i32) for name in _ROWS},
        "beta": (beta, (n_inner,), torch.float32),
    })
    check_n(spec.N)
    if C == 0:
        raise ValueError("no chains")
    if not 0 <= step0 <= 2 ** 31 - 1 - n_inner:
        raise ValueError(f"step0={step0} + n_inner={n_inner} overflows int32")
    lay = forced or layout(spec.N, C, n_sm)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (
        st.heights, st.best_heights, st.energy, st.best_energy,
        st.best_step, st.no_improve, st.stop_step, st.accept_bins,
        st.total_bins, st.chain_seeds, beta)]
    patience = spec.early_stop_patience
    err = lib.mcq_metropolis_segment(
        *ptrs, step0, n_inner, spec.N, C, spec.n_steps, spec.n_bins,
        -1 if patience is None else patience, lay.lanes,
        lay.chains_per_cta, lay.smem_bytes, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"metropolis CUDA kernel launch failed "
                           f"(cudaError {err}, {lay})")
    return lay


# One launch of the CUDA kernel, counted (segment.launch).
segment_cuda = functools.partial(segment.launch, _SAMPLER)


def run_segment(carry: BoardCarry, start_outer: int, spec: ChainSpec,
                n_outer: int):
    """``n_outer`` chunks of ``history_stride`` steps from chunk
    ``start_outer``; returns ``(carry, ys)`` with ``ys`` the ``(n_outer, C)``
    int32 energies after each chunk (one kernel launch per chunk)."""
    st, ys = segment.run(_SAMPLER, carry, start_outer, spec, n_outer)
    return carry_of(st, carry.block_seeds), ys
