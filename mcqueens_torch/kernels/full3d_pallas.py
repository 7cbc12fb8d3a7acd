"""Per-chain full-3D Metropolis, port of :mod:`mcqueens.kernels.full3d_pallas`.

Q queens sit on distinct cells of the N^3 cube.  Every chain draws its own
proposal from its seed's counter stream (:mod:`mcqueens_torch.kernels.prng`):
with ``base = step_base(g, step)`` and ``w_q, w_u = words_from_base(base)``
the mover is queen ``w_q % Q``, and the target is the first free cell among
the attempts ``a = 0, 1, ...`` of ``word_from_base(base, _A_SALT + a) % N^3``
(exact rejection sampling, no cap on attempts), checked against the chain's
``ceil(N^3/32)``-word occupancy bitfield.  Then

    dE = sum over the other Q-1 queens of
         attack(queen, new cell) - attack(queen, old cell)

and the chain accepts when ``u < exp(-beta(step) * dE)``.  Patience
early-stop, exact best placements (``best_step = step + 1``) and the per-bin
accept/total counts follow the JAX kernel step for step.  No stream is shared
between chains, so trajectories do not depend on the block partition; the
carry is still padded to whole blocks of :func:`block_size` as JAX pads it.
The carry and init here also start the shared-site sampler
(:mod:`mcqueens_torch.kernels.full3d_shared`).

One chunk of ``n_inner`` steps has two implementations over the same
chains-major state (:class:`SegmentState`), both updating it in place:

  * :func:`segment_cuda` launches the hand-written CUDA kernel
    (``csrc/full3d_pallas.cu``: a team of lanes a chain, proposals and
    first attempts drawn a batch ahead, queens and bitfield in shared
    memory) through :func:`launch_segment`, laid out by :func:`layout`, and
    counts the launch in :data:`KERNEL_LAUNCHES`;
  * :func:`segment_reference` is its plain-torch twin (vectorised over
    chains, a Python loop over steps, JAX's one-vs-all dE with the mover's
    own row cancelled arithmetically).

:mod:`mcqueens_torch.kernels.segment` chooses one by the state's device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import sys

import numpy as np
import torch

from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import fastinit
from mcqueens_torch.core import tables as tables_mod
from mcqueens_torch.kernels import _build, prng, segment, sizing
from mcqueens_torch.kernels.carry import Full3DCarry
from mcqueens_torch.utils import profiling

DEFAULT_BLOCK = 2048
_A_SALT = prng._i32(0x3C6EF372)  # attempt-word stream offset
_ATTEMPTS = 32  # rejection attempts the twin tests at once

# Launches of the CUDA kernel in this process (segment.launch counts them;
# read and reset by callers that check the main path ran on the card).
KERNEL_LAUNCHES = 0
_SAMPLER = sys.modules[__name__]


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


@dataclasses.dataclass
class SegmentState:
    """One segment's working state, chains major (contiguous int32), as the
    carry holds it: a warp of CUDA threads (one chain) loads its queens and
    its bitfield as contiguous rows.  The chunk implementations update it in
    place."""

    qi: torch.Tensor            # (C, Q)
    qj: torch.Tensor
    qk: torch.Tensor
    occ: torch.Tensor           # (C, ceil(N^3/32))
    best_qi: torch.Tensor       # (C, Q)
    best_qj: torch.Tensor
    best_qk: torch.Tensor
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
_PLANES = ("qi", "qj", "qk", "occ", "best_qi", "best_qj", "best_qk",
           "accept_bins", "total_bins")


def segment_state(carry: Full3DCarry) -> SegmentState:
    """A fresh :class:`SegmentState` holding copies of the carry's fields."""
    with profiling.span("mcq.transpose"):
        kw = {name: getattr(carry, name).clone().contiguous()
              for name in _PLANES}
        kw.update({name: getattr(carry, name).reshape(-1).clone()
                   for name in _ROWS})
        return SegmentState(**kw)


def carry_of(st: SegmentState, block_seeds: torch.Tensor) -> Full3DCarry:
    """Inverse of :func:`segment_state`; ``block_seeds`` passes through."""
    with profiling.span("mcq.transpose"):
        kw = {name: getattr(st, name) for name in _PLANES}
        kw.update({name: getattr(st, name)[:, None] for name in _ROWS})
        return Full3DCarry(block_seeds=block_seeds, **kw)


def _attack_ind(p, q, r):
    """JAX's 0/1 attack indicator of two distinct cells at distance
    (p, q, r): every nonzero squared distance equals the largest.  At
    distance 0 it is 8, which callers cancel."""
    p2, q2, r2 = p * p, q * q, r * r
    m = torch.maximum(p2, torch.maximum(q2, r2))
    bp = (p2 == 0).int() + (p2 == m).int()
    bq = (q2 == 0).int() + (q2 == m).int()
    br = (r2 == 0).int() + (r2 == m).int()
    return bp * bq * br


def _bit(occ, cell):
    """Bit ``cell`` of each chain's bitfield, for (C, K) cells."""
    return (occ.gather(1, (cell // 32).long()) >> (cell % 32)) & 1


def _free_cell(occ, base, N3):
    """(C,) first free cell of the attempts a = 0, 1, ...: cell
    ``word_from_base(base, _A_SALT + a) % N3`` (the JAX kernel's exact
    rejection sampling; attempts are tested ``_ATTEMPTS`` at a time)."""
    cell = torch.zeros_like(base)
    found = torch.zeros_like(base, dtype=torch.bool)
    a = 0
    while True:
        salt = _A_SALT + torch.arange(a, a + _ATTEMPTS, dtype=torch.int32,
                                      device=base.device)
        cand = prng.word_from_base(base[:, None], salt[None]) % N3
        free = _bit(occ, cand) == 0
        first = free.int().argmax(1, keepdim=True)
        take = free.any(1) & ~found
        cell = torch.where(take, cand.gather(1, first)[:, 0], cell)
        found |= take
        if bool(found.all()):
            return cell
        a += _ATTEMPTS


def _update_bits(occ, old, new, upd):
    """Clear bit ``old`` and set bit ``new`` where ``upd`` ((C,) each)."""
    bits = torch.tensor([prng._i32(1 << b) for b in range(32)],
                        dtype=torch.int32, device=occ.device)
    for cell, setting in ((old, False), (new, True)):
        w = (cell // 32).long()[:, None]
        word = occ.gather(1, w)[:, 0]
        bit = bits[(cell % 32).long()]
        flipped = word | bit if setting else word & ~bit
        occ.scatter_(1, w, torch.where(upd, flipped, word)[:, None])


def segment_reference(st: SegmentState, step0: int, n_inner: int,
                      spec: ChainSpec, beta: torch.Tensor) -> None:
    """Plain-torch twin of the CUDA kernel: advance every chain by
    ``n_inner`` steps from global step ``step0``, in place."""
    N, Q = spec.N, spec.q_eff
    NN, N3 = N * N, N ** 3
    nb, n_steps = spec.n_bins, spec.n_steps
    patience = spec.early_stop_patience
    g = prng.chain_streams(st.chain_seeds)
    planes = (st.qi, st.qj, st.qk)
    best_planes = (st.best_qi, st.best_qj, st.best_qk)
    e, be, bs = st.energy.clone(), st.best_energy.clone(), st.best_step.clone()
    ni, stp = st.no_improve.clone(), st.stop_step.clone()
    # Steps at or past n_steps are inactive for every chain: nothing changes.
    for t in range(max(0, min(n_inner, n_steps - step0))):
        gstep = step0 + t
        active = stp >= n_steps
        base = prng.step_base(g, gstep)
        w_q, w_u = prng.words_from_base(base)
        mover = (w_q % Q).long()[:, None]
        u = prng.uniform01(w_u)
        ox, oy, oz = (p.gather(1, mover)[:, 0] for p in planes)
        new = _free_cell(st.occ, base, N3)
        nx, ny, nz = new // NN, (new // N) % N, new % N
        # One-vs-all over every row; the mover's own row gives
        # attack(old, new) - 8, cancelled below.
        att = (_attack_ind(st.qi - nx[:, None], st.qj - ny[:, None],
                           st.qk - nz[:, None])
               - _attack_ind(st.qi - ox[:, None], st.qj - oy[:, None],
                             st.qk - oz[:, None]))
        de = (att.sum(1, dtype=torch.int32)
              - _attack_ind(ox - nx, oy - ny, oz - nz) + 8)
        accept = u < torch.exp(-beta[t] * de.to(torch.float32))
        upd = accept & active
        for p, old_x, new_x in zip(planes, (ox, oy, oz), (nx, ny, nz)):
            p.scatter_(1, mover, torch.where(upd, new_x, old_x)[:, None])
        _update_bits(st.occ, (ox * N + oy) * N + oz, new, upd)
        e = e + torch.where(upd, de, 0)
        improved = upd & (e < be)
        for bp, p in zip(best_planes, planes):
            bp.copy_(torch.where(improved[:, None], p, bp))
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


def smem_bytes(spec: ChainSpec) -> int:
    """Shared memory a chain needs at least: its packed queens, packed best
    queens and occupancy bitfield (a team of 32 lanes, one chain a CTA,
    holds no more)."""
    return 4 * slot_words(spec.q_eff, spec.N, 32)


# Lanes a chain, registers a thread (the 80 that ptxas allocates for the ~76
# each instance of csrc/full3d_pallas.cu uses under __launch_bounds__(256,
# 2); chip_smoke.py checks the build's count against it) and threads a CTA.
# A chain's bitfield alone caps N at 122 in a block's shared memory, so a
# coordinate fits a byte of the packed queen.
LANES = (1, 2, 4, 8, 16, 32)
REGISTERS = 80
MAX_THREADS_PER_CTA = 256
Layout = segment.Layout
# The rule's cost model (segment.TeamModel, a unit a queen row), fitted to
# every team size timed on the card at the beta pairs' launch and the N=15
# chunk at 65536 and 4096 chains (pair_scan_slice.py --only full3d_pallas;
# PERF.md, section 6).
MODEL = segment.TeamModel(
    per_unit=32, per_step=220, per_draw=180, unit_lat=48, step_lat=135,
    sum_lat=130, redux_lat=130, overlap=0.37, registers=REGISTERS,
    max_threads=MAX_THREADS_PER_CTA)


def slot_words(Q: int, N: int, lanes: int) -> int:
    """Shared-memory words of one chain: its Q queens, Q best queens and
    ``ceil(N^3/32)`` bitfield words, rounded up to ``lanes`` (mod 2 *
    lanes) below 32 lanes, so that a warp's loads of its teams' queens fall
    in 32 banks."""
    s = 2 * Q + _occ_words(N)
    return s + (lanes - s % (2 * lanes)) % (2 * lanes) if lanes < 32 else s


def cta_smem_bytes(Q: int, N: int, lanes: int, chains_per_cta: int) -> int:
    """Shared memory of a CTA: a slot per chain."""
    return 4 * chains_per_cta * slot_words(Q, N, lanes)


def check_shape(N: int, Q: int) -> None:
    """Raise ``ValueError`` unless the kernel takes ``N`` and ``Q``: a free
    cell (Q < N^3) and a chain's queens, best queens and bitfield within a
    block's shared memory."""
    if not 1 <= Q < N ** 3 or N < 2:
        raise ValueError(f"the full3d_pallas kernel needs N >= 2 and "
                         f"1 <= Q < N^3 (a free cell), got N={N}, Q={Q}")
    need = 4 * slot_words(Q, N, 32)
    if need > _build.SMEM_PER_BLOCK:
        raise ValueError(
            f"the full3d_pallas kernel keeps a chain's queens, best queens "
            f"and occupancy bitfield in shared memory: 4*(2Q + ceil(N^3/32)) "
            f"= {need} bytes at N={N}, Q={Q} exceeds the "
            f"{_build.SMEM_PER_BLOCK} bytes a block may hold (N <= 104 at "
            f"Q = N^2, N <= 122 at any Q)")


@functools.cache
def layout(N: int, Q: int, C: int, n_sm: int,
           lanes: int | None = None) -> Layout:
    """The CUDA kernel's layout for ``C`` chains of ``Q`` queens on the
    ``N^3`` cube on a card of ``n_sm`` SMs: the team size (or the given
    ``lanes``) and chains a CTA (lanes times chains a CTA a power of two
    from 32 to 256, the CTA's slots within a block's shared memory) of
    least cost (:data:`MODEL`).  Few chains take large teams (a step's
    latency), many chains small ones (each warp instruction serves 32 / L
    chains), and a layout whose last wave is nearly empty pays for a whole
    wave.  Ties go to fewer chains a CTA (more SMs), then fewer lanes.
    Raises ``ValueError`` for a shape no layout takes (:func:`check_shape`)
    or a team size whose warp of slots does not fit a block."""
    check_shape(N, Q)
    return MODEL.layout(Q, C, n_sm, LANES if lanes is None else (lanes,),
                        lambda L, cpb: cta_smem_bytes(Q, N, L, cpb))


def launch_segment(lib, st: SegmentState, step0: int, n_inner: int,
                   spec: ChainSpec, beta: torch.Tensor, *, n_sm: int,
                   stream: int = 0, forced: Layout | None = None) -> Layout:
    """Check a chunk's arguments, lay it out for ``n_sm`` SMs
    (:func:`layout`, or ``forced``) and call
    ``lib.mcq_full3d_pallas_segment`` on ``stream``; raises if it returns an
    error.  ``lib`` is the CUDA library (:func:`segment_cuda`) or its host
    emulation (:mod:`mcqueens_torch.kernels.host_emulation`, CPU tensors).
    Returns the layout."""
    Q, C, nb = spec.q_eff, st.energy.shape[0], spec.n_bins
    i32 = torch.int32
    _build.check_args(st.qi.device, {
        **{name: (getattr(st, name), (C, Q), i32) for name in (
            "qi", "qj", "qk", "best_qi", "best_qj", "best_qk")},
        "occ": (st.occ, (C, _occ_words(spec.N)), i32),
        "accept_bins": (st.accept_bins, (C, nb), i32),
        "total_bins": (st.total_bins, (C, nb), i32),
        **{name: (getattr(st, name), (C,), i32) for name in _ROWS},
        "beta": (beta, (n_inner,), torch.float32),
    })
    check_shape(spec.N, Q)
    if C == 0:
        raise ValueError("no chains")
    if not 0 <= step0 <= 2 ** 31 - 1 - n_inner:
        raise ValueError(f"step0={step0} + n_inner={n_inner} overflows int32")
    lay = forced or layout(spec.N, spec.q_eff, C, n_sm)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (
        st.qi, st.qj, st.qk, st.best_qi, st.best_qj, st.best_qk, st.occ,
        st.energy, st.best_energy, st.best_step, st.no_improve,
        st.stop_step, st.accept_bins, st.total_bins, st.chain_seeds, beta)]
    patience = spec.early_stop_patience
    err = lib.mcq_full3d_pallas_segment(
        *ptrs, step0, n_inner, spec.N, spec.q_eff, C, spec.n_steps,
        spec.n_bins, -1 if patience is None else patience, lay.lanes,
        lay.chains_per_cta, lay.smem_bytes, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"full3d_pallas CUDA kernel launch failed "
                           f"(cudaError {err}, {lay})")
    return lay


# One launch of the CUDA kernel, counted (segment.launch).
segment_cuda = functools.partial(segment.launch, _SAMPLER)


def run_segment(carry: Full3DCarry, start_outer: int, spec: ChainSpec,
                n_outer: int):
    """``n_outer`` chunks of ``history_stride`` steps from chunk
    ``start_outer``; returns ``(carry, ys)`` with ``ys`` the ``(n_outer, C)``
    int32 energies after each chunk (one kernel launch per chunk)."""
    st, ys = segment.run(_SAMPLER, carry, start_outer, spec, n_outer)
    return carry_of(st, carry.block_seeds), ys
