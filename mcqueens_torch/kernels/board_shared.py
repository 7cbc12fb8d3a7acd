"""Shared-site board Metropolis, port of :mod:`mcqueens.kernels.board_shared`.

Every chain in a block of ``block_size`` chains proposes the same site
``(i, j)`` each step, drawn from a block-keyed hash; each chain draws its own
new height ``(old + 1 + kr) % N`` and its own accept word from its seed's
counter stream (:mod:`mcqueens_torch.kernels.prng`).  A move at ``(i, j)``
changes conflicts only on row i, column j and the two diagonals through
``(i, j)``, so

    dE = sum over those cells (h', at line offset delta != 0) of
         [h' == new] + [(h' - new)^2 == delta^2]
       - [h' == old] - [(h' - old)^2 == delta^2]

(equal to the JAX kernel's four-block sum plus 8).  Accept when
``u < exp(-beta(step) * dE)``.  Patience early-stop, exact best boards
(``best_step = step + 1``) and per-bin accept/total counts follow the JAX
kernel step for step, so the same seeds and block partition give the same
trajectories bit for bit.

One chunk of ``n_inner`` steps has two implementations over the same
chains-minor state (:class:`SegmentState`), both updating it in place:

  * :func:`segment_cuda` launches the hand-written CUDA kernel
    (``csrc/board_shared.cu``: a team of lanes a chain, boards packed in
    shared memory and scored four cells a word) through
    :func:`launch_segment`, laid out by :func:`layout`, and counts the
    launch in :data:`KERNEL_LAUNCHES` (and :data:`PACKED_LAUNCHES` where the
    boards went to shared memory);
  * :func:`segment_reference` is its plain-torch twin (vectorised over
    chains, a Python loop over steps).

:mod:`mcqueens_torch.kernels.segment` chooses one by the state's device
and hands it the chunk's betas, so both share one beta by construction.

All three modes of the JAX kernel are ported: the main path
(``track_best=True``, no freeze row); the tempered mode, where chain ``c``
samples at ``schedule(step) * beta_scale[c]`` (:func:`run_segment_tempered`,
for :mod:`mcqueens_torch.search.tempering`); and the freeze mode, where chain
``c`` stops updating at step ``freeze[c]``.  ``track_best=False`` leaves the
best boards untouched (no N^2 copy per improvement) while ``best_energy``,
``best_step`` and ``no_improve`` stay exact; :func:`recover_best_heights`
then rebuilds each chain's best board by replaying the run from its initial
state, frozen at the chain's own ``best_step``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import sys

import numpy as np
import torch

from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import fastinit
from mcqueens_torch.core import tables as tables_mod
from mcqueens_torch.kernels import _build, prng, segment, sizing
from mcqueens_torch.kernels.carry import BoardCarry
from mcqueens_torch.utils import profiling

DEFAULT_BLOCK = 2048
_SITE_MUL = prng._i32(0x2545F491)
_SITE_SALT = prng._i32(0x9E3779B9)

# Launches of the CUDA kernel in this process (read and reset by callers
# that check the main path really ran on the card; counted by
# segment.launch); FREEZE_LAUNCHES counts the ones made with a freeze row
# (the replay of recover_best_heights), PACKED_LAUNCHES the ones that kept
# the boards packed in shared memory (the SMEM instance, every N <= 127
# whose CTA fits), both counted by launch_segment for state on the card.
KERNEL_LAUNCHES = 0
FREEZE_LAUNCHES = 0
PACKED_LAUNCHES = 0
_SAMPLER = sys.modules[__name__]


def _sn(N: int) -> int:
    return -(-N // 8) * 8


def block_size(n_chains: int, spec=None) -> int:
    """Chains per block: the JAX package's partition, which fixes which
    chains share a site stream (5 (SN*N, block) layouts in its VMEM
    estimate)."""
    cap = DEFAULT_BLOCK
    if spec is not None:
        cap = sizing.block_cap(5 * _sn(spec.N) * spec.N, DEFAULT_BLOCK)
    return sizing.block_size(n_chains, cap)


def padded_chains(n_chains: int, spec=None) -> int:
    blk = block_size(n_chains, spec)
    return -(-n_chains // blk) * blk


def init_carry_batch(seeds, spec: ChainSpec, block: int | None = None,
                     initial_states=None, *, device) -> BoardCarry:
    """Carry on ``device`` from per-chain integer seeds, padded to whole
    blocks.

    Padding chains get seeds ``seeds[-1] + 1 + arange`` (uint32) and, with
    ``initial_states``, repeat the last warm start; a warm-start height
    outside [0, N) raises ``ValueError`` (:func:`check_heights`).  Block ``b`` seeds its
    site stream with ``int32(seeds[0]) + 7919 * b``.
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
    N = spec.N
    if initial_states is not None:
        h2d = torch.as_tensor(np.asarray(initial_states, np.int32),
                              device=device)
        check_heights(h2d, N)
        if C > h2d.shape[0]:
            h2d = torch.cat([h2d, h2d[-1:].expand(C - h2d.shape[0], N, N)])
    else:
        h2d = fastinit.board_init_batch(seeds_t, N, spec.init_mode)
    heights = h2d.reshape(C, N * N).to(torch.int32).contiguous()
    e0 = tables_mod.batch_energies(
        h2d, lambda h: tables_mod.table_energy(
            tables_mod.build_board_table(h)))[:, None].to(torch.int32)
    block_seeds = (int(seeds_t[0]) + 7919 * torch.arange(
        n_blocks, dtype=torch.int32, device=device))[:, None]
    zeros = torch.zeros((C, 1), dtype=torch.int32, device=device)
    return BoardCarry(
        block_seeds=block_seeds,
        chain_seeds=seeds_t[:, None].clone(),
        heights=heights,
        best_heights=heights.clone(),
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
    """One segment's working state, chains minor (contiguous int32).

    A CTA of the CUDA kernel then reads one cell index of its neighbouring
    chains per load when it copies their boards into shared memory.  The
    chunk implementations update these tensors in place.
    """

    heights: torch.Tensor       # (N*N, C)
    best_heights: torch.Tensor  # (N*N, C)
    energy: torch.Tensor        # (C,)
    best_energy: torch.Tensor   # (C,)
    best_step: torch.Tensor     # (C,)
    no_improve: torch.Tensor    # (C,)
    stop_step: torch.Tensor     # (C,)
    accept_bins: torch.Tensor   # (n_bins, C)
    total_bins: torch.Tensor    # (n_bins, C)
    chain_seeds: torch.Tensor   # (C,)
    block_seeds: torch.Tensor   # (n_blocks,)


_ROWS = ("energy", "best_energy", "best_step", "no_improve", "stop_step",
         "chain_seeds")
_PLANES = ("heights", "best_heights", "accept_bins", "total_bins")


def segment_state(carry: BoardCarry) -> SegmentState:
    """Transpose a carry into a fresh chains-minor :class:`SegmentState`;
    ``ValueError`` if a height lies outside [0, N) (:func:`check_heights`)."""
    with profiling.span("mcq.transpose"):
        st = SegmentState(**segment.chains_minor(
            carry, _PLANES, _ROWS + ("block_seeds",)))
        check_heights(st.heights, math.isqrt(st.heights.shape[0]))
    return st


def carry_of(st: SegmentState) -> BoardCarry:
    """Inverse of :func:`segment_state`."""
    with profiling.span("mcq.transpose"):
        return BoardCarry(**segment.chains_major(
            st, _PLANES, _ROWS + ("block_seeds",)))


def segment_reference(st: SegmentState, step0: int, n_inner: int,
                      spec: ChainSpec, beta: torch.Tensor,
                      beta_scale: torch.Tensor | None = None, *,
                      freeze: torch.Tensor | None = None,
                      track_best: bool = True) -> None:
    """Plain-torch twin of the CUDA kernel: advance every chain by
    ``n_inner`` steps from global step ``step0``, in place.  ``freeze``
    (``(C,)`` int32) stops chain ``c`` at step ``freeze[c]``;
    ``track_best=False`` leaves ``best_heights`` as it is."""
    N, NN = spec.N, spec.N * spec.N
    nb, n_steps = spec.n_bins, spec.n_steps
    patience = spec.early_stop_patience
    C = st.energy.shape[0]
    c_blk = C // st.block_seeds.shape[0]
    site_base = (st.block_seeds * _SITE_MUL + _SITE_SALT).repeat_interleave(
        c_blk)
    g = prng.chain_streams(st.chain_seeds)
    x = torch.arange(N, dtype=torch.int32, device=st.energy.device)[:, None]
    h, bh = st.heights, st.best_heights
    e, be, bs = st.energy.clone(), st.best_energy.clone(), st.best_step.clone()
    ni, stp = st.no_improve.clone(), st.stop_step.clone()
    # Steps at or past n_steps are inactive for every chain: nothing changes.
    for t in range(max(0, min(n_inner, n_steps - step0))):
        gstep = step0 + t
        active = stp >= n_steps
        if freeze is not None:
            active = active & (gstep < freeze)
        cell = (prng.lowbias32(site_base ^ gstep) & 0x7FFFFFFF) % NN
        i, j = cell // N, cell % N
        w0, w1 = prng.step_words(g, gstep)
        kr = w0 % (N - 1)
        u = prng.uniform01(w1)
        old = h.gather(0, cell[None].long())[0]
        new = (old + 1 + kr) % N
        # The four lines through (i, j), as (N, C) cell indices: row i at
        # column offset x - j; column j, diagonal and antidiagonal at row
        # offset d = x - i.
        d, dj = x - i, x - j
        jd, ja = j + d, j - d
        idx = torch.cat([i * N + x, x * N + j, x * N + jd.clamp(0, N - 1),
                         x * N + ja.clamp(0, N - 1)])
        valid = torch.cat([dj != 0, d != 0,
                           (d != 0) & (jd >= 0) & (jd < N),
                           (d != 0) & (ja >= 0) & (ja < N)])
        d2 = torch.cat([dj * dj, d * d, d * d, d * d])
        hp = h.gather(0, idx.long())
        dn, do = hp - new, hp - old
        net = ((dn == 0).int() - (do == 0).int()
               + (dn * dn == d2).int() - (do * do == d2).int())
        de = torch.where(valid, net, 0).sum(0, dtype=torch.int32)
        bt = beta[t] if beta_scale is None else beta[t] * beta_scale
        accept = u < torch.exp(-bt * de.to(torch.float32))
        upd = accept & active
        h.scatter_(0, cell[None].long(), torch.where(upd, new, old)[None])
        e = e + torch.where(upd, de, 0)
        improved = upd & (e < be)
        if track_best:
            bh.copy_(torch.where(improved[None], h, bh))
        be = torch.where(improved, e, be)
        bs = torch.where(improved, gstep + 1, bs)
        ni = torch.where(active, torch.where(improved, 0, ni + 1), ni)
        if patience is not None:
            stp = torch.where(active & (ni >= patience), gstep, stp)
        b = min(gstep * nb // n_steps, nb - 1)
        st.accept_bins[b] += upd.int()
        st.total_bins[b] += active.int()
    for name, val in (("energy", e), ("best_energy", be), ("best_step", bs),
                      ("no_improve", ni), ("stop_step", stp)):
        getattr(st, name).copy_(val)


# Lanes a chain, chains a CTA and registers a thread of the CUDA kernel
# (csrc/board_shared.cu: __launch_bounds__(1024, 1) holds every instance to
# 64 registers), and the largest N whose heights a shared-memory byte holds.
LANES = (8, 4, 2, 1)
MAX_CHAINS_PER_CTA = 128
MAX_THREADS_PER_CTA = 1024
REGISTERS = 64
MAX_SHARED_N = 127
Layout = segment.Layout


def row_pitch(N: int) -> int:
    """Bytes of a board row in shared memory: N rounded up to an odd number
    of words, so that a team's column reads fall in different banks."""
    return 4 * (-(-N // 4) | 1)


def slot_bytes(N: int, track_best: bool) -> int:
    """Shared-memory bytes of one chain: its board and, with
    ``track_best``, its best board, an odd number of words."""
    return 4 * ((1 + bool(track_best)) * N * row_pitch(N) // 4 | 1)


def guard_bytes(N: int) -> int:
    """Zeroed shared-memory bytes before a CTA's first slot and after its
    last: the kernel's masked reads of diagonal cells off the board and of
    rows past N in a ragged last word reach that far."""
    return 4 * ((3 * row_pitch(N) + 2 * N + 6) // 4)


def cta_smem_bytes(N: int, chains_per_cta: int, track_best: bool) -> int:
    """Shared memory of a CTA: a flag word and a slot per chain, and a
    guard at each end of the slots."""
    return (chains_per_cta * (4 + slot_bytes(N, track_best))
            + 2 * guard_bytes(N))


def _resident(lanes: int, cpb: int, smem: int) -> int:
    """Chains an SM holds at once (:func:`segment.resident_ctas`)."""
    return cpb * segment.resident_ctas(Layout(lanes, cpb, smem), REGISTERS)


@functools.cache
def layout(N: int, C: int, n_sm: int, track_best: bool) -> Layout:
    """The CUDA kernel's layout for ``C`` chains of board size ``N`` on a
    card of ``n_sm`` SMs.

    Boards go to shared memory, one byte a cell, whenever N <= 127 and a CTA
    of them fits; otherwise the device-memory instance walks them in place.
    The lanes a chain are the most (8, 4, 2, 1) that keep all ``C`` chains
    resident in one wave, ``ceil(C / n_sm)`` an SM (few chains take large
    teams, many chains small ones; if no team size holds them all, the one
    that holds the most, ties to fewer lanes).  Chains a CTA are a power of
    two, at most 128 and at most the wave's chains an SM, so that a launch
    of few chains spreads over the SMs."""
    spread = max(1, -(-C // n_sm))
    shared = N <= MAX_SHARED_N

    def options(lanes):
        cpbs = [1 << k for k in range(MAX_CHAINS_PER_CTA.bit_length())
                if 32 <= lanes << k <= MAX_THREADS_PER_CTA]
        if shared:
            cpbs = [c for c in cpbs if cta_smem_bytes(N, c, track_best)
                    <= _build.SMEM_PER_BLOCK]
        return cpbs

    if shared and not any(options(lanes) for lanes in LANES):
        shared = False

    def smem(cpb):
        return cta_smem_bytes(N, cpb, track_best) if shared else 0

    def most(lanes):  # (resident chains an SM, chains a CTA) at its best
        return max((_resident(lanes, c, smem(c)), c) for c in options(lanes))

    fits = [lanes for lanes in LANES if options(lanes)
            and most(lanes)[0] >= spread]
    lanes = fits[0] if fits else max(
        (lanes for lanes in LANES if options(lanes)),
        key=lambda lanes: (most(lanes)[0], -lanes))
    opts = options(lanes)
    cap = 1 << (spread.bit_length() - 1)  # the largest power of two <= spread
    cpb = min(most(lanes)[1], max(opts[0], cap))
    return Layout(lanes, cpb, smem(cpb))


def check_heights(heights: torch.Tensor, N: int) -> None:
    """Raise ``ValueError`` unless every height lies in [0, N): the CUDA
    kernel keeps a board as bytes and wraps a moved height by one
    subtraction."""
    if not heights.numel():
        return
    with profiling.span("mcq.read"):
        lo, hi = torch.stack(torch.aminmax(heights)).tolist()
    if lo < 0 or hi >= N:
        raise ValueError(f"heights must lie in [0, {N}), got [{lo}, {hi}]")


def launch_segment(lib, st: SegmentState, step0: int, n_inner: int,
                   spec: ChainSpec, beta: torch.Tensor,
                   beta_scale: torch.Tensor | None = None, *,
                   freeze: torch.Tensor | None = None,
                   track_best: bool = True, n_sm: int, stream: int = 0,
                   forced: Layout | None = None) -> Layout:
    """Check a chunk's arguments, lay it out for ``n_sm`` SMs
    (:func:`layout`, or ``forced``) and call
    ``lib.mcq_board_shared_segment`` on ``stream``; raises if it returns an
    error.  ``lib`` is the CUDA library (:func:`segment_cuda`) or its host
    emulation (:mod:`mcqueens_torch.kernels.host_emulation`, CPU tensors).
    Returns the layout."""
    global FREEZE_LAUNCHES, PACKED_LAUNCHES
    N, NN, C = spec.N, spec.N * spec.N, st.energy.shape[0]
    n_blocks = st.block_seeds.shape[0]
    i32, f32 = torch.int32, torch.float32
    want = {
        "heights": (st.heights, (NN, C), i32),
        "best_heights": (st.best_heights, (NN, C), i32),
        "accept_bins": (st.accept_bins, (spec.n_bins, C), i32),
        "total_bins": (st.total_bins, (spec.n_bins, C), i32),
        "block_seeds": (st.block_seeds, (n_blocks,), i32),
        **{name: (getattr(st, name), (C,), i32) for name in _ROWS},
        "beta": (beta, (n_inner,), f32),
    }
    if beta_scale is not None:
        want["beta_scale"] = (beta_scale, (C,), f32)
    if freeze is not None:
        want["freeze"] = (freeze, (C,), i32)
    _build.check_args(st.heights.device, want)
    if C == 0 or n_blocks == 0 or C % n_blocks:
        raise ValueError(f"{C} chains do not split into {n_blocks} blocks")
    if not 0 <= step0 <= 2 ** 31 - 1 - n_inner:
        raise ValueError(f"step0={step0} + n_inner={n_inner} overflows int32")
    lay = forced or layout(N, C, n_sm, track_best)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (
        st.heights, st.best_heights, st.energy, st.best_energy,
        st.best_step, st.no_improve, st.stop_step, st.accept_bins,
        st.total_bins, st.chain_seeds, st.block_seeds, beta)]
    ptrs += [ctypes.c_void_p(None if t is None else t.data_ptr())
             for t in (beta_scale, freeze)]
    patience = spec.early_stop_patience
    err = lib.mcq_board_shared_segment(
        *ptrs, step0, n_inner, N, C, C // n_blocks, spec.n_steps,
        spec.n_bins, -1 if patience is None else patience, int(track_best),
        lay.lanes, lay.chains_per_cta, lay.smem_bytes,
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"board_shared CUDA kernel launch failed "
                           f"(cudaError {err})")
    if st.heights.is_cuda:
        FREEZE_LAUNCHES += freeze is not None
        PACKED_LAUNCHES += lay.in_shared
    return lay


# One launch of the CUDA kernel, counted (segment.launch).
segment_cuda = functools.partial(segment.launch, _SAMPLER)


def run_segment(carry: BoardCarry, start_outer: int, spec: ChainSpec,
                n_outer: int, track_best: bool = True):
    """``n_outer`` chunks of ``history_stride`` steps from chunk
    ``start_outer``; returns ``(carry, ys)`` with ``ys`` the ``(n_outer, C)``
    int32 energies after each chunk (one kernel launch per chunk).

    ``track_best=False`` drops the N^2 best-board copy of every improvement;
    ``best_energy``/``best_step`` stay exact and :func:`recover_best_heights`
    rebuilds the boards afterwards.
    """
    st, ys = segment.run(_SAMPLER, carry, start_outer, spec, n_outer,
                         track_best=track_best)
    return carry_of(st), ys


def run_segment_tempered(carry: BoardCarry, beta_scale, start_outer: int,
                         spec: ChainSpec, n_outer: int):
    """:func:`run_segment` with chain ``c`` sampling at
    ``spec.schedule(step) * beta_scale[c]`` (a ``(C,)`` float32 scale)."""
    st, ys = segment.run(_SAMPLER, carry, start_outer, spec, n_outer,
                         beta_scale=beta_scale)
    return carry_of(st), ys


def _run_segment_frozen(carry: BoardCarry, freeze_row, start_outer: int,
                        spec: ChainSpec, n_outer: int) -> BoardCarry:
    """:func:`run_segment` with per-chain replay horizons, no best
    tracking, as one chunk of ``n_outer * history_stride`` steps: it keeps
    no history, every draw is keyed by its step, and the betas are the
    schedule's step by step, so the chunks' boundaries change nothing."""
    freeze = torch.as_tensor(freeze_row, dtype=torch.int32,
                             device=carry.device).reshape(-1).contiguous()
    st = segment_state(carry)
    stride = spec.history_stride
    segment.call(_SAMPLER, st, int(start_outer) * stride, n_outer * stride,
                 spec, freeze=freeze, track_best=False)
    return carry_of(st)


def recover_best_heights(carry: BoardCarry, spec: ChainSpec,
                         initial_states=None, verify: bool = True):
    """Rebuild the best boards of a ``track_best=False`` run by replay.

    Every draw is a pure function of (chain seed, block seed, step), so the
    run replays exactly from its initial state: a fresh carry from the same
    seeds and block size, advanced with each chain frozen at its own
    ``best_step``, holds each chain's board as of its best step, bitwise
    the board a ``track_best=True`` run would have copied.  The replay runs
    ``min(n_outer, ceil(max(best_step) / stride))`` chunks from step 0, in
    one launch.

    Args:
        carry: the final carry of a :func:`run_segment` run (any
            ``track_best``); its seeds identify the streams and its
            ``best_step``/``best_energy`` drive and check the replay.
        spec: the spec the run used.
        initial_states: the run's warm starts, if it had any.
        verify: raise ``AssertionError`` unless each replayed energy equals
            the recorded ``best_energy``.

    Returns:
        ``(C, N, N)`` int32 best boards on the carry's device (C includes
        any block padding).
    """
    seeds = carry.chain_seeds.reshape(-1).cpu().numpy().view(np.uint32)
    C = int(seeds.shape[0])
    block = C // int(carry.block_seeds.shape[0])
    fresh = init_carry_batch(seeds, spec, block=block,
                             initial_states=initial_states,
                             device=carry.device)
    best_step = carry.best_step.reshape(-1)
    n_outer = min(spec.n_outer, max(
        1, -(-int(best_step.max()) // spec.history_stride)))
    replayed = _run_segment_frozen(fresh, best_step, 0, spec, n_outer)
    if verify:
        want = carry.best_energy.reshape(-1)
        got = replayed.energy.reshape(-1)
        if not torch.equal(want, got):
            bad = int((want != got).sum())
            raise AssertionError(
                f"replay mismatch on {bad}/{C} chains: replayed energies "
                f"do not match recorded best energies (was the run warm-"
                f"started? pass the same initial_states)")
    return replayed.heights.reshape(C, spec.N, spec.N)
