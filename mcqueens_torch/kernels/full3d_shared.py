"""Shared-site full-3D Metropolis, port of
:mod:`mcqueens.kernels.full3d_shared`.

Q queens sit on distinct cells of the N^3 cube.  Chains in a block of
``block_size`` chains share each step's candidate cell, uniform over all N^3
cells, and share a mover queen that is redrawn every ``_HOLD`` = 8 steps.  A
chain whose candidate is occupied (by another queen, or by the mover itself)
is lazy for that step: the step counts in its bins and is never accepted.
Otherwise

    dE = #(other queens attacking the candidate)
       - #(other queens attacking the mover's current cell)

and the chain accepts when ``u < exp(-beta * dE)`` with its own accept word
``step_words(chain_streams(seed), step)[1]``.  Two distinct cells attack iff
every nonzero coordinate distance equals the largest one.

Mover chunks start at ``step0 + 8m`` inside every launch, where ``step0`` is
the launch's first step, so the last chunk of a launch is shorter when the
history stride is not a multiple of 8 and trajectories depend on the stride;
the port therefore launches once per history chunk, as the JAX package does.
Patience early-stop, exact best placements (``best_step = step + 1``) and the
per-bin accept/total counts follow the JAX kernel step for step, so the same
seeds and block partition give the same trajectories bit for bit.

One launch of ``n_inner`` steps has two implementations over the same
chains-minor state (:class:`SegmentState`), both updating it in place:

  * :func:`segment_cuda` launches the hand-written CUDA kernel
    (``csrc/full3d_shared.cu``) and counts the launch in
    :data:`KERNEL_LAUNCHES`;
  * :func:`segment_reference` is its plain-torch twin (vectorised over
    chains, a Python loop over steps).

:func:`segment_call` takes the twin only for CPU tensors and the kernel only
for CUDA tensors.  ``run_segment_tempered`` multiplies each chain's beta by
its own scale (parallel tempering, :mod:`mcqueens_torch.search.tempering`).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core.schedules import chunk_betas
from mcqueens_torch.kernels import full3d_pallas, prng, segment, sizing
from mcqueens_torch.kernels.carry import Full3DCarry

DEFAULT_BLOCK = 2048
_HOLD = 8  # steps the shared mover is held
_SEED_MUL = prng._i32(0x2545F491)
_CAND_SALT = prng._i32(0x7F4A7C15)   # candidate-cell stream
_MOVER_SALT = prng._i32(0x3C6EF372)  # mover-index stream

# Launches of the CUDA kernel in this process (read and reset by callers
# that check the main path really ran on the card).
KERNEL_LAUNCHES = 0


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

    A warp of CUDA threads (one chain each) then reads one queen row of 32
    neighbouring chains per load.  The implementations update these tensors
    in place.
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
    return SegmentState(**segment.chains_minor(
        carry, _PLANES, _ROWS + ("block_seeds",)))


def carry_of(st: SegmentState, occ: torch.Tensor) -> Full3DCarry:
    """Inverse of :func:`segment_state`; ``occ`` passes through."""
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
    # Steps at or past n_steps are inactive for every chain: nothing changes.
    t_end = max(0, min(n_inner, n_steps - step0))
    for c0 in range(0, t_end, _HOLD):
        g0 = step0 + c0
        mover = ((prng.lowbias32(mover_base ^ g0) & 0x7FFFFFFF) % Q).long()
        other = rows != mover[None]
        pos = [p.gather(0, mover[None])[0] for p in planes]
        old_conf = (_attack(*(p - x for p, x in zip(planes, pos)))
                    & other).sum(0, dtype=torch.int32)
        best_pos = list(pos)
        improved_here = torch.zeros_like(other[0])
        for gstep in range(g0, min(g0 + _HOLD, step0 + t_end)):
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


def _check_cuda_state(st: SegmentState, spec: ChainSpec, n_inner: int,
                      beta: torch.Tensor, beta_scale) -> None:
    from mcqueens_torch.kernels import _build

    Q, C = spec.q_eff, st.energy.shape[0]
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


def segment_cuda(st: SegmentState, step0: int, n_inner: int,
                 spec: ChainSpec, beta: torch.Tensor,
                 beta_scale: torch.Tensor | None = None) -> None:
    """Advance every chain by ``n_inner`` steps with the CUDA kernel
    (asynchronous on the current stream; counts the launch)."""
    global KERNEL_LAUNCHES
    from mcqueens_torch.kernels import _build

    check_n(spec.N)
    _check_cuda_state(st, spec, n_inner, beta, beta_scale)
    if not 0 <= step0 <= 2 ** 31 - 1 - n_inner:
        raise ValueError(f"step0={step0} + n_inner={n_inner} overflows int32")
    lib = _build.load_library()
    dev = st.qi.device
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (
        st.qi, st.qj, st.qk, st.best_qi, st.best_qj, st.best_qk, st.energy,
        st.best_energy, st.best_step, st.no_improve, st.stop_step,
        st.accept_bins, st.total_bins, st.chain_seeds, st.block_seeds, beta)]
    ptrs.append(ctypes.c_void_p(
        None if beta_scale is None else beta_scale.data_ptr()))
    C = st.energy.shape[0]
    patience = spec.early_stop_patience
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mcq_full3d_shared_segment(
            *ptrs, step0, n_inner, spec.N, spec.q_eff, C,
            C // st.block_seeds.shape[0], spec.n_steps, spec.n_bins,
            -1 if patience is None else patience, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"full3d_shared CUDA kernel launch failed "
                           f"(cudaError {err})")
    KERNEL_LAUNCHES += 1


def segment_call(st: SegmentState, step0: int, n_inner: int,
                 spec: ChainSpec,
                 beta_scale: torch.Tensor | None = None) -> None:
    """One launch of ``n_inner`` steps: the twin for CPU state, the CUDA
    kernel for CUDA state, and an error for anything else."""
    dev = st.qi.device
    beta = chunk_betas(spec.schedule, step0, n_inner, dev)
    segment.on_device("full3d_shared", dev, segment_reference, segment_cuda,
                      st, step0, n_inner, spec, beta, beta_scale)


def _run(carry: Full3DCarry, beta_scale, start_outer: int, spec: ChainSpec,
         n_outer: int):
    check_n(spec.N)
    stride = spec.history_stride
    st = segment_state(carry)
    ys = torch.empty((n_outer, st.energy.shape[0]), dtype=torch.int32,
                     device=st.energy.device)
    for o in range(n_outer):
        segment_call(st, (int(start_outer) + o) * stride, stride, spec,
                     beta_scale)
        ys[o].copy_(st.energy)
    return carry_of(st, carry.occ), ys


def run_segment(carry: Full3DCarry, start_outer: int, spec: ChainSpec,
                n_outer: int):
    """``n_outer`` launches of ``history_stride`` steps from chunk
    ``start_outer``; returns ``(carry, ys)`` with ``ys`` the ``(n_outer, C)``
    int32 energies after each launch."""
    return _run(carry, None, start_outer, spec, n_outer)


def run_segment_tempered(carry: Full3DCarry, beta_scale, start_outer: int,
                         spec: ChainSpec, n_outer: int):
    """:func:`run_segment` with chain ``c`` sampling at
    ``spec.schedule(step) * beta_scale[c]`` (a ``(C,)`` float32 scale)."""
    beta_scale = torch.as_tensor(beta_scale, dtype=torch.float32,
                                 device=carry.device).reshape(-1).contiguous()
    return _run(carry, beta_scale, start_outer, spec, n_outer)
