"""Shared-site full-3D Metropolis, port of
:mod:`mcqueens.kernels.full3d_shared`.

Q queens sit on distinct cells of the N^3 cube.  Chains in a block of
``block_size`` chains share each step's candidate cell, uniform over all N^3
cells, and share a mover queen that is redrawn every ``_HOLD`` = 8 steps
(16 or 32 where a caller patches :data:`_HOLD`, as ``tools/probe_hold.py``
does; see :func:`hold`).  A
chain whose candidate is occupied (by another queen, or by the mover itself)
is lazy for that step: the step counts in its bins and is never accepted.
Otherwise

    dE = #(other queens attacking the candidate)
       - #(other queens attacking the mover's current cell)

and the chain accepts when ``u < exp(-beta * dE)`` with its own accept word
``step_words(chain_streams(seed), step)[1]``.  Two distinct cells attack iff
every nonzero coordinate distance equals the largest one.

Mover chunks start at ``step0 + hold * m`` inside every launch, where
``step0`` is the launch's first step, so the last chunk of a launch is
shorter when the history stride is not a multiple of the hold and
trajectories depend on the stride;
the port therefore launches once per history chunk, as the JAX package does.
Patience early-stop, exact best placements (``best_step = step + 1``) and the
per-bin accept/total counts follow the JAX kernel step for step, so the same
seeds and block partition give the same trajectories bit for bit.

One launch of ``n_inner`` steps has two implementations over the same
chains-minor state (:class:`SegmentState`), both updating it in place:

  * :func:`segment_cuda` launches the hand-written CUDA kernel
    (``csrc/full3d_shared.cu``: a team of lanes a chain, queens and best
    queens in shared memory) through :func:`launch_segment`, laid out by
    :func:`layout`, and counts the launch in :data:`KERNEL_LAUNCHES`;
  * :func:`segment_reference` is its plain-torch twin (vectorised over
    chains, a Python loop over steps).

:mod:`mcqueens_torch.kernels.segment` chooses one by the state's device.
``run_segment_tempered`` multiplies each chain's beta by its own scale
(parallel tempering, :mod:`mcqueens_torch.search.tempering`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import re
import sys

import numpy as np
import torch

from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.kernels import (_build, full3d_pallas, prng, segment,
                                    sizing)
from mcqueens_torch.kernels.carry import Full3DCarry
from mcqueens_torch.utils import profiling

DEFAULT_BLOCK = 2048
_HOLD = 8  # steps the shared mover is held; read at each launch
# The holds the CUDA kernel is built for (a template parameter).
HOLDS = (8, 16, 32)
# Fewest steps a launch at a hold above 8 takes.  Below it the JAX kernel
# walks 8-step groups (its _UNROLL_SMALL), runs range(8 // hold) chunks in
# each, none at hold 16 or 32, and so skips every step but the tail's
# (mcqueens/kernels/full3d_shared.py:354,385): there it is no reference.
LONG_LAUNCH = 1024
_SEED_MUL = prng._i32(0x2545F491)
_CAND_SALT = prng._i32(0x7F4A7C15)   # candidate-cell stream
_MOVER_SALT = prng._i32(0x3C6EF372)  # mover-index stream

# Launches of the CUDA kernel in this process (segment.launch counts them;
# read and reset by callers that check the main path ran on the card).
KERNEL_LAUNCHES = 0
_SAMPLER = sys.modules[__name__]


def check_n(N: int) -> None:
    """The JAX kernel's supported range, N <= 93.

    Its pad-row sentinels need ``(3N+24)^4 < 2^33`` for its int32 attack
    products to stay exact.  The port has no pad rows and no such limit, but
    refuses the same N so that a ChainSpec behaves alike in both packages.
    """
    if (3 * N + 24) ** 4 >= 2 ** 33:
        raise ValueError(
            f"full3d_shared supports N <= 93: its pad sentinels need "
            f"(3N+24)^4 < 2^33 for the a2*(a2-m) attack products to stay "
            f"exact in int32 arithmetic (got N={N}); use kernel='pallas' "
            f"for larger boards")


def hold(n_inner: int) -> int:
    """The mover hold of a launch of ``n_inner`` steps: :data:`_HOLD`, read
    at call time, so that patching it selects the kernel's instance and the
    twin's chunks alike.  Raises ``ValueError`` for a hold outside
    :data:`HOLDS`, and for a hold above 8 on a launch of fewer than
    :data:`LONG_LAUNCH` steps."""
    if _HOLD not in HOLDS:
        raise ValueError(f"full3d_shared: the mover hold must be one of "
                         f"{HOLDS}, got {_HOLD}")
    if _HOLD != 8 and n_inner < LONG_LAUNCH:
        raise ValueError(
            f"full3d_shared: a hold of {_HOLD} needs launches of at least "
            f"{LONG_LAUNCH} steps (got {n_inner}); below that the JAX "
            f"kernel skips the held chunks, so it is no reference")
    return _HOLD


def block_size(n_chains: int, spec=None) -> int:
    """Chains per block: the JAX package's partition, which fixes which
    chains share the candidate and mover streams (6 (QS, block) coordinate
    layouts in its VMEM estimate; no occupancy rows, unlike
    :func:`full3d_pallas.block_size`)."""
    cap = DEFAULT_BLOCK
    if spec is not None:
        cap = sizing.block_cap(6 * full3d_pallas._qs(spec.q_eff),
                               DEFAULT_BLOCK)
    return sizing.block_size(n_chains, cap)


def padded_chains(n_chains: int, spec=None) -> int:
    blk = block_size(n_chains, spec)
    return -(-n_chains // blk) * blk


def init_carry_batch(seeds, spec: ChainSpec, block: int | None = None,
                     initial_states=None, *, device) -> Full3DCarry:
    """:func:`full3d_pallas.init_carry_batch` over this module's block
    partition, with block ``b``'s seed re-keyed to
    ``int32(seeds[0]) + 7919 * b``."""
    if block is None:
        block = block_size(np.asarray(seeds).shape[0], spec)
    carry = full3d_pallas.init_carry_batch(
        seeds, spec, block=block, initial_states=initial_states,
        device=device)
    n_blocks = carry.block_seeds.shape[0]
    block_seeds = (int(carry.chain_seeds[0, 0]) + 7919 * torch.arange(
        n_blocks, dtype=torch.int32, device=carry.device))[:, None]
    return dataclasses.replace(carry, block_seeds=block_seeds)


@dataclasses.dataclass
class SegmentState:
    """One segment's working state, chains minor (contiguous int32).

    The CUDA kernel's CTAs then copy a queen row of neighbouring chains per
    load into shared memory.  The implementations update these tensors in
    place.
    """

    qi: torch.Tensor            # (Q, C)
    qj: torch.Tensor
    qk: torch.Tensor
    best_qi: torch.Tensor       # (Q, C)
    best_qj: torch.Tensor
    best_qk: torch.Tensor
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
_PLANES = ("qi", "qj", "qk", "best_qi", "best_qj", "best_qk", "accept_bins",
           "total_bins")


def segment_state(carry: Full3DCarry) -> SegmentState:
    """Transpose a carry into a fresh chains-minor :class:`SegmentState`."""
    with profiling.span("mcq.transpose"):
        return SegmentState(**segment.chains_minor(
            carry, _PLANES, _ROWS + ("block_seeds",)))


def carry_of(st: SegmentState, occ: torch.Tensor) -> Full3DCarry:
    """Inverse of :func:`segment_state`; ``occ`` passes through."""
    with profiling.span("mcq.transpose"):
        return Full3DCarry(occ=occ, **segment.chains_major(
            st, _PLANES, _ROWS + ("block_seeds",)))


def _attack(dx, dy, dz):
    """Two cells at distance (dx, dy, dz) attack iff every nonzero |d|
    equals the largest (also true at distance 0: callers mask the mover's
    row and treat an occupied candidate as lazy)."""
    a, b, c = dx * dx, dy * dy, dz * dz
    m = torch.maximum(a, torch.maximum(b, c))
    return (((a == 0) | (a == m)) & ((b == 0) | (b == m))
            & ((c == 0) | (c == m)))


def segment_reference(st: SegmentState, step0: int, n_inner: int,
                      spec: ChainSpec, beta: torch.Tensor,
                      beta_scale: torch.Tensor | None = None) -> None:
    """Plain-torch twin of the CUDA kernel: advance every chain by
    ``n_inner`` steps from global step ``step0``, in place."""
    N, Q = spec.N, spec.q_eff
    NN, N3 = N * N, N ** 3
    nb, n_steps = spec.n_bins, spec.n_steps
    patience = spec.early_stop_patience
    C = st.energy.shape[0]
    dev = st.energy.device
    seed = st.block_seeds.repeat_interleave(C // st.block_seeds.shape[0])
    cand_base = seed * _SEED_MUL + _CAND_SALT
    mover_base = seed * _SEED_MUL + _MOVER_SALT
    g = prng.chain_streams(st.chain_seeds)
    rows = torch.arange(Q, device=dev)[:, None]
    planes = (st.qi, st.qj, st.qk)
    best_planes = (st.best_qi, st.best_qj, st.best_qk)
    e, be, bs = st.energy.clone(), st.best_energy.clone(), st.best_step.clone()
    ni, stp = st.no_improve.clone(), st.stop_step.clone()
    H = hold(n_inner)
    # Steps at or past n_steps are inactive for every chain: nothing changes.
    t_end = max(0, min(n_inner, n_steps - step0))
    for c0 in range(0, t_end, H):
        g0 = step0 + c0
        mover = ((prng.lowbias32(mover_base ^ g0) & 0x7FFFFFFF) % Q).long()
        other = rows != mover[None]
        pos = [p.gather(0, mover[None])[0] for p in planes]
        old_conf = (_attack(*(p - x for p, x in zip(planes, pos)))
                    & other).sum(0, dtype=torch.int32)
        best_pos = list(pos)
        improved_here = torch.zeros_like(other[0])
        for gstep in range(g0, min(g0 + H, step0 + t_end)):
            cand = (prng.lowbias32(cand_base ^ gstep) & 0x7FFFFFFF) % N3
            target = (cand // NN, (cand // N) % N, cand % N)
            d = [p - x for p, x in zip(planes, target)]
            new_conf = (_attack(*d) & other).sum(0, dtype=torch.int32)
            occupied = (((d[0] == 0) & (d[1] == 0) & (d[2] == 0) & other)
                        .any(0)
                        | ((pos[0] == target[0]) & (pos[1] == target[1])
                           & (pos[2] == target[2])))
            de = new_conf - old_conf
            u = prng.uniform01(prng.step_words(g, gstep)[1])
            bt = beta[gstep - step0]
            if beta_scale is not None:
                bt = bt * beta_scale
            accept = u < torch.exp(-bt * de.to(torch.float32))
            active = stp >= n_steps
            upd = accept & active & ~occupied
            pos = [torch.where(upd, t, p) for p, t in zip(pos, target)]
            old_conf = torch.where(upd, new_conf, old_conf)
            e = e + torch.where(upd, de, 0)
            improved = upd & (e < be)
            best_pos = [torch.where(improved, p, bp)
                        for p, bp in zip(pos, best_pos)]
            improved_here |= improved
            be = torch.where(improved, e, be)
            bs = torch.where(improved, gstep + 1, bs)
            ni = torch.where(active, torch.where(improved, 0, ni + 1), ni)
            if patience is not None:
                stp = torch.where(active & (ni >= patience), gstep, stp)
            b = min(gstep * nb // n_steps, nb - 1)
            st.accept_bins[b] += upd.int()
            st.total_bins[b] += active.int()
        # The mover's live cell goes back into the planes; a chain that
        # improved in this chunk keeps the planes with the mover where it
        # stood at its last improvement (the other queens did not move).
        for p, bp, x, bx in zip(planes, best_planes, pos, best_pos):
            p.scatter_(0, mover[None], x[None])
            bp.copy_(torch.where(improved_here[None],
                                 p.scatter(0, mover[None], bx[None]), bp))
    for name, val in (("energy", e), ("best_energy", be), ("best_step", bs),
                      ("no_improve", ni), ("stop_step", stp)):
        getattr(st, name).copy_(val)


LANES = (1, 2, 4, 8, 16, 32)
MAX_CHAINS_PER_CTA = 128
MAX_THREADS_PER_CTA = 512
# Two 16-bit counts share a word in the team's reduce.
MAX_Q = 65536
# What __launch_bounds__(512, 1) lets ptxas use (chip_smoke.py checks the
# build's count against it).
REGISTERS = 128
Layout = segment.Layout
# The rule's cost model: int32 instructions a lane issues a chunk, ~170 a
# queen of its share (nine attack tests and the occupancy tests, as ptxas
# compiles them) and ~600 for the chunk's hashes, draws, reduce and walk; a
# warp alone issues at most one every _ISSUE_GAP cycles.  The constants are
# set so that the rule picks, at the floors, Q_max and campaign shapes, the
# team size that ran fastest when each was timed on the card (PERF.md,
# section 6).
_PER_QUEEN, _PER_CHUNK, _ISSUE_GAP = 170, 600, 2.2


def slot_words(Q: int, lanes: int) -> int:
    """Shared-memory words of one chain: its live and best planes, 2Q words
    rounded up to ``lanes`` (mod 2 * lanes), or to an odd count at 32 lanes,
    so that a warp's reads of its teams' queens fall in 32 banks."""
    m, want = (2 * lanes, lanes) if lanes < 32 else (2, 1)
    return 2 * Q + (want - 2 * Q % m) % m


def cta_smem_bytes(Q: int, lanes: int, chains_per_cta: int) -> int:
    """Shared memory of a CTA: a flag word and a slot per chain."""
    return 4 * chains_per_cta * (1 + slot_words(Q, lanes))


def waves(lay: Layout, C: int, n_sm: int) -> float:
    """Waves a launch of ``C`` chains takes: the chains over what ``n_sm``
    SMs hold at once."""
    per_sm = lay.chains_per_cta * segment.resident_ctas(lay, REGISTERS)
    return C / (n_sm * per_sm)


def _cost(lay: Layout, Q: int, C: int, n_sm: int) -> float:
    """The rule's estimate of a chunk's cycles on the busiest SM: its CTAs
    run in waves of what it holds; a wave issues its warps' instructions
    four a cycle, or as fast as one warp can."""
    lanes, cpb = lay.lanes, lay.chains_per_cta
    ctas = segment.resident_ctas(lay, REGISTERS)
    per_sm = -(-(C // cpb) // n_sm)
    lane = -(-Q // lanes) * _PER_QUEEN + _PER_CHUNK

    def wave(k):
        per_scheduler = k * cpb * lanes / 32 / 4
        return lane * max(per_scheduler, _ISSUE_GAP)

    full, rest = divmod(per_sm, ctas)
    return full * wave(ctas) + (wave(rest) if rest else 0)


@functools.cache
def layout(N: int, Q: int, C: int, c_blk: int, n_sm: int) -> Layout:
    """The CUDA kernel's layout for ``C`` chains of ``Q`` queens in blocks
    of ``c_blk`` chains on a card of ``n_sm`` SMs.

    Queens go to shared memory whenever a CTA of them fits; otherwise the
    device-memory instance walks them in place.  Among the team sizes and
    chains a CTA (a power of two, at most 128, dividing ``c_blk``, so that a
    CTA holds one semantic block's chains) the rule takes the least
    :func:`_cost`: few chains take large teams (more warps an SM), many
    chains small ones (less of each chunk's walk repeated in every lane),
    and a layout whose last wave is nearly empty pays for a whole wave.
    Ties go to more chains a CTA, then fewer lanes."""
    check_n(N)
    if not 1 <= Q <= MAX_Q:
        raise ValueError(f"full3d_shared's CUDA kernel sums two counts a "
                         f"word: Q must lie in [1, {MAX_Q}], got {Q}")
    options = [(lanes, 1 << k) for lanes in LANES
               for k in range(MAX_CHAINS_PER_CTA.bit_length())
               if 32 <= lanes << k <= MAX_THREADS_PER_CTA
               and c_blk % (1 << k) == 0 and C % (1 << k) == 0]
    shared = [Layout(lanes, cpb, cta_smem_bytes(Q, lanes, cpb))
              for lanes, cpb in options
              if cta_smem_bytes(Q, lanes, cpb) <= _build.SMEM_PER_BLOCK]
    lays = shared or [Layout(lanes, cpb, 0) for lanes, cpb in options]
    return min(lays, key=lambda lay: (_cost(lay, Q, C, n_sm),
                                      -lay.chains_per_cta, lay.lanes))


def launch_segment(lib, st: SegmentState, step0: int, n_inner: int,
                   spec: ChainSpec, beta: torch.Tensor,
                   beta_scale: torch.Tensor | None = None, *, n_sm: int,
                   stream: int = 0, forced: Layout | None = None) -> Layout:
    """Check a launch's arguments, lay it out for ``n_sm`` SMs
    (:func:`layout`, or ``forced``) and call
    ``lib.mcq_full3d_shared_segment`` on ``stream``; raises if it returns an
    error.  ``lib`` is the CUDA library (:func:`segment_cuda`) or its host
    emulation (:mod:`mcqueens_torch.kernels.host_emulation`, CPU tensors).
    Returns the layout."""
    check_n(spec.N)
    H = hold(n_inner)
    Q = spec.q_eff
    if Q > MAX_Q:
        raise ValueError(f"full3d_shared's CUDA kernel sums two counts a "
                         f"word: Q must be at most {MAX_Q}, got {Q}; the "
                         f"twin (CPU) has no such limit")
    C = st.energy.shape[0]
    n_blocks = st.block_seeds.shape[0]
    i32, f32 = torch.int32, torch.float32
    want = {
        **{name: (getattr(st, name), (Q, C), i32) for name in _PLANES[:6]},
        "accept_bins": (st.accept_bins, (spec.n_bins, C), i32),
        "total_bins": (st.total_bins, (spec.n_bins, C), i32),
        "block_seeds": (st.block_seeds, (n_blocks,), i32),
        **{name: (getattr(st, name), (C,), i32) for name in _ROWS},
        "beta": (beta, (n_inner,), f32),
    }
    if beta_scale is not None:
        want["beta_scale"] = (beta_scale, (C,), f32)
    _build.check_args(st.qi.device, want)
    if C == 0 or n_blocks == 0 or C % n_blocks:
        raise ValueError(f"{C} chains do not split into {n_blocks} blocks")
    if not 0 <= step0 <= 2 ** 31 - 1 - n_inner:
        raise ValueError(f"step0={step0} + n_inner={n_inner} overflows int32")
    c_blk = C // n_blocks
    lay = forced or layout(spec.N, Q, C, c_blk, n_sm)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (
        st.qi, st.qj, st.qk, st.best_qi, st.best_qj, st.best_qk, st.energy,
        st.best_energy, st.best_step, st.no_improve, st.stop_step,
        st.accept_bins, st.total_bins, st.chain_seeds, st.block_seeds, beta)]
    ptrs.append(ctypes.c_void_p(
        None if beta_scale is None else beta_scale.data_ptr()))
    patience = spec.early_stop_patience
    err = lib.mcq_full3d_shared_segment(
        *ptrs, step0, n_inner, spec.N, Q, C, c_blk, spec.n_steps,
        spec.n_bins, -1 if patience is None else patience, H, lay.lanes,
        lay.chains_per_cta, lay.smem_bytes, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"full3d_shared CUDA kernel launch failed "
                           f"(cudaError {err}, {lay}, hold {H})")
    return lay


def instances(usage: dict) -> dict:
    """``{(lanes, shared, hold): {"registers": n, "spill_bytes": n}}`` of
    the CUDA kernel's instances in a :func:`_build.ptxas_usage` map
    (``shared``: the instance that keeps the queens in shared memory)."""
    out = {}
    for name, use in usage.items():
        m = re.search(r"full3d_shared_kernelILi(\d+)ELb([01])ELi(\d+)EE",
                      name)
        if m:
            out[int(m[1]), m[2] == "1", int(m[3])] = use
    return out


# One launch of the CUDA kernel, counted (segment.launch).
segment_cuda = functools.partial(segment.launch, _SAMPLER)


def run_segment(carry: Full3DCarry, start_outer: int, spec: ChainSpec,
                n_outer: int):
    """``n_outer`` launches of ``history_stride`` steps from chunk
    ``start_outer``; returns ``(carry, ys)`` with ``ys`` the ``(n_outer, C)``
    int32 energies after each launch."""
    check_n(spec.N)
    st, ys = segment.run(_SAMPLER, carry, start_outer, spec, n_outer)
    return carry_of(st, carry.occ), ys


def run_segment_tempered(carry: Full3DCarry, beta_scale, start_outer: int,
                         spec: ChainSpec, n_outer: int):
    """:func:`run_segment` with chain ``c`` sampling at
    ``spec.schedule(step) * beta_scale[c]`` (a ``(C,)`` float32 scale)."""
    check_n(spec.N)
    st, ys = segment.run(_SAMPLER, carry, start_outer, spec, n_outer,
                         beta_scale=beta_scale)
    return carry_of(st, carry.occ), ys
