"""Board Metropolis scan sampler, port of :mod:`mcqueens.chain.board`.

Per step each chain draws, from ``key = fold_in(step_base, step)`` and
``k_i, k_j, k_k, k_u = split(key, 4)`` (threefry, :mod:`~.core.rng`), a site
``i, j = randint(k_i, N), randint(k_j, N)``, a new height ``(old + 1 +
randint(k_k, N - 1)) % N`` and ``u = uniform(k_u)``, and accepts when
``u < exp(-beta(step) * dE)``.  dE comes from the chain's line-count table
(``kernel="tables"``: 24 lookups) or from two O(N^2) conflict scans
(``kernel="naive"``); both give the same integer, so the two kernels give
the same trajectory.  Patience early-stop (``done``/``stop_step``), exact
best boards (``best_step = step + 1``) and per-bin accept/total counts
follow the JAX step exactly, so the same keys give the same chains bit for
bit.

The carry (:class:`BoardCarry`) is chains major, as JAX's vmapped carry.
One segment of ``n_outer`` chunks of ``history_stride`` steps has two
implementations over the same chains-minor state (:class:`SegmentState`),
both updating it in place and writing the ``(n_outer, C)`` energy rows:

  * :func:`segment_cuda` launches the hand-written CUDA kernel
    (``kernels/csrc/board_scan.cu``, a warp per chain, one launch per
    segment, its shared-memory layout from :func:`scan_layout`) and counts
    the launch in :data:`KERNEL_LAUNCHES`;
  * :func:`segment_reference` is its plain-torch twin (vectorised over
    chains, a Python loop over steps).

:mod:`mcqueens_torch.kernels.segment` chooses one by the state's device
and hands it the segment's betas.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import sys
from typing import Optional

import torch

from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import energy as energy_mod
from mcqueens_torch.core import init as init_mod
from mcqueens_torch.core import rng
from mcqueens_torch.core import tables as tables_mod
from mcqueens_torch.kernels import _build, segment
from mcqueens_torch.utils import profiling

# Launches of the CUDA kernel in this process (segment.launch counts them;
# read and reset by callers that check the main path ran on the card).
KERNEL_LAUNCHES = 0
_SAMPLER = sys.modules[__name__]


@dataclasses.dataclass(frozen=True)
class BoardCarry:
    """Per-chain sampler state, chains major, on one device."""

    step_base: torch.Tensor        # (C, 2) int64 uint32 key words
    heights: torch.Tensor          # (C, N*N) int32
    table: Optional[torch.Tensor]  # (C, T) int32 line counts ("tables")
    energy: torch.Tensor           # (C,) int32
    best_heights: torch.Tensor     # (C, N*N) int32
    best_energy: torch.Tensor      # (C,) int32
    best_step: torch.Tensor        # (C,) int32
    no_improve: torch.Tensor       # (C,) int32
    done: torch.Tensor             # (C,) bool: early-stopped (frozen)
    stop_step: torch.Tensor        # (C,) int32 (n_steps if never stopped)
    accept_bins: torch.Tensor      # (C, n_bins) int32
    total_bins: torch.Tensor       # (C, n_bins) int32

    @property
    def device(self) -> torch.device:
        return self.heights.device


def init_carry_batch(keys, spec: ChainSpec, initial_states=None, *,
                     device) -> BoardCarry:
    """One chain per key of ``keys`` (``(C, 2)``, :mod:`~.core.rng`);
    optional ``(C, N, N)`` warm starts.  ``split(key)`` gives the init key
    and the step base, as in JAX."""
    keys = torch.as_tensor(keys, device=device).to(torch.int64)
    C, N = keys.shape[0], spec.N
    k = rng.split(keys, 2)
    init_key, step_base = k[:, 0], k[:, 1].contiguous()
    if initial_states is None:
        h2d = init_mod.board_init(init_key, N, spec.init_mode)
    else:
        h2d = torch.as_tensor(initial_states, device=device).to(torch.int32)
    heights = h2d.reshape(C, N * N).contiguous()
    table = tables_mod.build_board_table(h2d)
    e0 = tables_mod.table_energy(table)
    zeros = torch.zeros(C, dtype=torch.int32, device=device)
    bins = torch.zeros((C, spec.n_bins), dtype=torch.int32, device=device)
    return BoardCarry(
        step_base=step_base,
        heights=heights,
        table=table if spec.kernel == "tables" else None,
        energy=e0,
        best_heights=heights.clone(),
        best_energy=e0.clone(),
        best_step=zeros,
        no_improve=zeros.clone(),
        done=torch.zeros(C, dtype=torch.bool, device=device),
        stop_step=zeros + spec.n_steps,
        accept_bins=bins,
        total_bins=bins.clone(),
    )


def init_carry(chain_key, spec: ChainSpec, heights0=None, *,
               device) -> BoardCarry:
    """One chain's carry (unbatched fields) from its ``(2,)`` key;
    ``heights0`` warm-starts it from an ``(N, N)`` board."""
    batch = init_carry_batch(
        torch.as_tensor(chain_key, device=device)[None], spec,
        None if heights0 is None else torch.as_tensor(heights0)[None],
        device=device)
    return BoardCarry(**{name: None if v is None else v[0]
                         for name, v in vars(batch).items()})


@dataclasses.dataclass
class SegmentState:
    """One segment's working state, chains minor (contiguous int32), so a
    warp of CUDA threads (one chain each) reads one cell or line index of 32
    neighbouring chains per load.  Updated in place."""

    heights: torch.Tensor          # (N*N, C)
    best_heights: torch.Tensor     # (N*N, C)
    table: Optional[torch.Tensor]  # (T, C), None for "naive"
    energy: torch.Tensor           # (C,)
    best_energy: torch.Tensor      # (C,)
    best_step: torch.Tensor        # (C,)
    no_improve: torch.Tensor       # (C,)
    done: torch.Tensor             # (C,) 0 / 1
    stop_step: torch.Tensor        # (C,)
    accept_bins: torch.Tensor      # (n_bins, C)
    total_bins: torch.Tensor       # (n_bins, C)
    step_base: torch.Tensor        # (2, C) key words as int32 bits


_ROWS = ("energy", "best_energy", "best_step", "no_improve", "stop_step")
_PLANES = ("heights", "best_heights", "table", "accept_bins", "total_bins")


def segment_state(carry: BoardCarry) -> SegmentState:
    """Transpose a carry into a fresh chains-minor :class:`SegmentState`."""
    with profiling.span("mcq.transpose"):
        kw = segment.chains_minor(carry, _PLANES, _ROWS)
        kw["done"] = carry.done.to(torch.int32)
        kw["step_base"] = rng.as_int32(carry.step_base).t().contiguous()
        return SegmentState(**kw)


def carry_of(st: SegmentState) -> BoardCarry:
    """Inverse of :func:`segment_state`."""
    with profiling.span("mcq.transpose"):
        kw = segment.chains_major(st, _PLANES, _ROWS, row_shape=(-1,))
        kw["done"] = st.done != 0
        kw["step_base"] = rng.from_int32(st.step_base).t().contiguous()
        return BoardCarry(**kw)


def _draws(keys: torch.Tensor, step: int, N: int):
    """Site, height offset and accept uniform of every chain at ``step``."""
    k = rng.split(rng.fold_in(keys, step), 4)
    spans = torch.tensor([N, N, N - 1], dtype=torch.int64,
                         device=keys.device)
    ijk = rng.randint(k[:, :3], (), 0, spans)
    return ijk[:, 0], ijk[:, 1], ijk[:, 2], rng.uniform(k[:, 3])


def segment_reference(st: SegmentState, ys: torch.Tensor, start_outer: int,
                      n_outer: int, spec: ChainSpec,
                      beta: torch.Tensor) -> None:
    """Plain-torch twin of the CUDA kernel: ``n_outer`` chunks of
    ``history_stride`` steps from chunk ``start_outer``, in place; row ``o``
    of ``ys`` gets the energies after chunk ``o``.  ``beta[t]`` is the beta
    of step ``start_outer * stride + t``."""
    N, stride = spec.N, spec.history_stride
    nb, n_steps = spec.n_bins, spec.n_steps
    patience = spec.early_stop_patience
    keys = rng.from_int32(st.step_base).t()
    h, bh = st.heights.t(), st.best_heights.t()  # (C, N*N) views
    tab = None if st.table is None else st.table.t()
    e, be, bs = st.energy.clone(), st.best_energy.clone(), st.best_step.clone()
    ni, stp, done = st.no_improve.clone(), st.stop_step.clone(), st.done != 0
    step0 = start_outer * stride
    for o in range(n_outer):
        # Steps at or past n_steps are inactive for every chain.
        for t in range(o * stride, min((o + 1) * stride, n_steps - step0)):
            gstep = step0 + t
            i, j, kr, u = _draws(keys, gstep, N)
            cell = (i * N + j)[:, None].long()
            old = h.gather(1, cell)[:, 0]
            new = (old + 1 + kr) % N
            if tab is not None:
                de, idx_old, idx_new = tables_mod.board_delta_e(
                    tab, i, j, old, new, N)
            else:
                h2d = h.unflatten(1, (N, N))
                de = (energy_mod.board_conflicts(h2d, i, j, new)
                      - energy_mod.board_conflicts(h2d, i, j, old))
            accept = u < torch.exp(-beta[t] * de.to(torch.float32))
            active = ~done
            upd = accept & active
            h.scatter_(1, cell, torch.where(upd, new, old)[:, None])
            if tab is not None:
                tables_mod.apply_move(tab, idx_old, idx_new, upd)
            e = e + torch.where(upd, de, 0)
            improved = upd & (e < be)
            bh.copy_(torch.where(improved[:, None], h, bh))
            be = torch.where(improved, e, be)
            bs = torch.where(improved, gstep + 1, bs)
            ni = torch.where(active, torch.where(improved, 0, ni + 1), ni)
            if patience is not None:
                newly = active & (ni >= patience)
                done = done | newly
                stp = torch.where(newly, gstep, stp)
            b = min(gstep * nb // n_steps, nb - 1)
            st.accept_bins[b] += upd.int()
            st.total_bins[b] += active.int()
        ys[o].copy_(e)
    for name, val in (("energy", e), ("best_energy", be), ("best_step", bs),
                      ("no_improve", ni), ("stop_step", stp), ("done", done)):
        getattr(st, name).copy_(val)


# Chains (warps) a block of the CUDA kernel holds at most.
MAX_CHAINS_PER_BLOCK = 8


@dataclasses.dataclass(frozen=True)
class ScanLayout:
    """How the CUDA kernel lays out a launch: ``chains_per_block`` warps a
    block, one a chain, and ``smem_bytes`` of shared memory a block, which
    holds each chain's heights, best heights and (``tables``) table, or 0
    when they do not fit a block and the kernel walks them in device
    memory."""

    chains_per_block: int
    smem_bytes: int

    @property
    def in_shared(self) -> bool:
        return self.smem_bytes > 0


def scan_layout(N: int, kernel: str, C: int, n_sm: int) -> ScanLayout:
    """The CUDA kernel's layout for ``C`` chains of board size ``N`` on a
    card of ``n_sm`` SMs.  A chain's slot is ``2 N^2`` words, plus the
    table's ``T(N)`` for ``tables``; it goes to shared memory whenever it
    fits a block (``tables`` up to N = 42): :func:`slot_layout`."""
    words = 2 * N * N + (tables_mod.table_size(N) if kernel == "tables"
                         else 0)
    return slot_layout(4 * words, C, n_sm)


def slot_layout(slot: int, C: int, n_sm: int) -> ScanLayout:
    """The layout of a warp-per-chain scan kernel whose chains need
    ``slot`` bytes each: in shared memory whenever a slot fits a block.
    Chains per block then maximise the chains resident on an SM (ties to
    the larger block), and are cut to ``ceil(C / n_sm)`` so that a launch
    of few chains spreads them over the SMs, one warp an SM when C <=
    n_sm."""
    spread = max(1, -(-C // n_sm))
    if slot > _build.SMEM_PER_BLOCK:
        return ScanLayout(min(MAX_CHAINS_PER_BLOCK, spread), 0)

    def resident(cpb):  # chains an SM holds: its shared memory, 64 warps
        blocks = min(_build.SMEM_PER_SM // (
            cpb * slot + _build.SMEM_RESERVED_PER_BLOCK), 64 // cpb)
        return cpb * blocks

    fits = range(1, min(MAX_CHAINS_PER_BLOCK,
                        _build.SMEM_PER_BLOCK // slot) + 1)
    best = max(fits, key=lambda cpb: (resident(cpb), cpb))
    cpb = min(best, spread)
    return ScanLayout(cpb, cpb * slot)


def check_steps(start_outer: int, n_outer: int, stride: int) -> None:
    if start_outer < 0 or (start_outer + n_outer) * stride > 2 ** 31 - 1:
        raise ValueError(f"chunks {start_outer}..{start_outer + n_outer} of "
                         f"{stride} steps overflow int32")


# One launch of the CUDA kernel, counted (segment.launch).
segment_cuda = functools.partial(segment.launch, _SAMPLER)


def launch_segment(lib, st: SegmentState, ys: torch.Tensor,
                   start_outer: int, n_outer: int, spec: ChainSpec,
                   beta: torch.Tensor, n_sm: int, stream: int = 0) -> None:
    """Check a segment's arguments, lay it out for ``n_sm`` SMs
    (:func:`scan_layout`) and call ``lib.mcq_board_scan_segment`` on
    ``stream``; raises if it returns an error.  ``lib`` is the CUDA library
    (:func:`segment_cuda`) or its host emulation
    (:mod:`mcqueens_torch.kernels.host_emulation`, CPU tensors)."""
    N, C, nb = spec.N, st.energy.shape[0], spec.n_bins
    NN, stride = N * N, spec.history_stride
    i32 = torch.int32
    want = {
        "heights": (st.heights, (NN, C), i32),
        "best_heights": (st.best_heights, (NN, C), i32),
        "accept_bins": (st.accept_bins, (nb, C), i32),
        "total_bins": (st.total_bins, (nb, C), i32),
        "step_base": (st.step_base, (2, C), i32),
        "done": (st.done, (C,), i32),
        **{name: (getattr(st, name), (C,), i32) for name in _ROWS},
        "beta": (beta, (n_outer * stride,), torch.float32),
        "ys": (ys, (n_outer, C), i32),
    }
    if (st.table is None) != (spec.kernel == "naive"):
        raise ValueError(f"kernel {spec.kernel!r} with table "
                         f"{'absent' if st.table is None else 'present'}")
    if st.table is not None:
        want["table"] = (st.table, (tables_mod.table_size(N), C), i32)
    _build.check_args(st.heights.device, want)
    if C == 0:
        raise ValueError("no chains")
    check_steps(start_outer, n_outer, stride)
    layout = scan_layout(N, spec.kernel, C, n_sm)
    ptrs = [ctypes.c_void_p(None if t is None else t.data_ptr()) for t in (
        st.heights, st.best_heights, st.table, st.energy, st.best_energy,
        st.best_step, st.no_improve, st.done, st.stop_step, st.accept_bins,
        st.total_bins, st.step_base, beta, ys)]
    patience = spec.early_stop_patience
    err = lib.mcq_board_scan_segment(
        *ptrs, start_outer, n_outer, stride, N, C, spec.n_steps, nb,
        -1 if patience is None else patience, layout.chains_per_block,
        layout.smem_bytes, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"board_scan CUDA kernel launch failed "
                           f"(cudaError {err})")


def run_segment(carry: BoardCarry, start_outer: int, spec: ChainSpec,
                n_outer: int):
    """Advance every chain by ``n_outer`` history chunks of
    ``history_stride`` steps from chunk ``start_outer``; returns ``(carry,
    ys)`` with ``ys`` the ``(n_outer, C)`` int32 energies after each chunk
    (one kernel launch on CUDA)."""
    st = segment_state(carry)
    ys = segment.call_scan(_SAMPLER, st, int(start_outer), n_outer, spec)
    return carry_of(st), ys
