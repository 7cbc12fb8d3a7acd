"""Full-3D Metropolis scan sampler, port of :mod:`mcqueens.chain.full3d`.

Q queens on distinct cells of the N^3 cube.  Per step each chain draws, from
``key = fold_in(step_base, step)`` and ``k_q, k_cell, k_u = split(key, 3)``
(threefry, :mod:`~.core.rng`), a mover ``randint(k_q, Q)``, a uniform
unoccupied cell by exact rejection sampling (:func:`_draw_unoccupied`: split
the key, draw ``randint(sub, N^3)``, repeat while the cell is occupied) and
``u = uniform(k_u)``, and accepts when ``u < exp(-beta(step) * dE)``.  dE
comes from the chain's 13-family line-count table (``kernel="tables"``) or
from two O(Q) conflict scans (``kernel="naive"``); both give the same
integer.  The occupancy cube ``occ`` makes the "occupied?" test one load.
Patience, best placements and bins follow the JAX step exactly.

As in :mod:`mcqueens_torch.chain.board`: the carry (:class:`Full3DCarry`)
is chains major; a segment runs through the hand-written CUDA kernel
(``kernels/csrc/full3d_scan.cu``, a warp per chain, one launch per segment,
its shared-memory layout from :func:`scan_layout`, :func:`segment_cuda`,
counted in :data:`KERNEL_LAUNCHES`) or its plain-torch twin
(:func:`segment_reference`), both over one chains-minor
:class:`SegmentState`, chosen by the state's device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import sys
from typing import Optional

import torch

from mcqueens_torch.chain.board import ScanLayout, check_steps, slot_layout
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
class Full3DCarry:
    """Per-chain sampler state, chains major, on one device."""

    step_base: torch.Tensor        # (C, 2) int64 uint32 key words
    queens: torch.Tensor           # (C, Q, 3) int32
    occ: torch.Tensor              # (C, N^3) bool occupancy
    table: Optional[torch.Tensor]  # (C, T13) int32 ("tables" only)
    energy: torch.Tensor           # (C,) int32
    best_queens: torch.Tensor      # (C, Q, 3) int32
    best_energy: torch.Tensor      # (C,) int32
    best_step: torch.Tensor        # (C,) int32
    no_improve: torch.Tensor       # (C,) int32
    done: torch.Tensor             # (C,) bool
    stop_step: torch.Tensor        # (C,) int32
    accept_bins: torch.Tensor      # (C, n_bins) int32
    total_bins: torch.Tensor       # (C, n_bins) int32

    @property
    def device(self) -> torch.device:
        return self.queens.device


def init_carry_batch(keys, spec: ChainSpec, initial_states=None, *,
                     device) -> Full3DCarry:
    """One chain per key of ``keys`` (``(C, 2)``); optional ``(C, Q, 3)``
    warm starts (distinct cells, validated by the runner)."""
    keys = torch.as_tensor(keys, device=device).to(torch.int64)
    C, N, Q = keys.shape[0], spec.N, spec.q_eff
    k = rng.split(keys, 2)
    init_key, step_base = k[:, 0], k[:, 1].contiguous()
    if initial_states is None:
        queens, occ = init_mod.full3d_init(init_key, N, spec.init_mode, Q=Q)
    else:
        queens = torch.as_tensor(initial_states, device=device).to(
            torch.int32).contiguous()
        occ = torch.zeros((C, N ** 3), dtype=torch.bool, device=device)
        occ.scatter_(1, init_mod.queens_to_cells(queens, N), True)
    table = tables_mod.build_full3d_table(queens, N)
    e0 = tables_mod.table_energy(table)
    zeros = torch.zeros(C, dtype=torch.int32, device=device)
    bins = torch.zeros((C, spec.n_bins), dtype=torch.int32, device=device)
    return Full3DCarry(
        step_base=step_base,
        queens=queens,
        occ=occ,
        table=table if spec.kernel == "tables" else None,
        energy=e0,
        best_queens=queens.clone(),
        best_energy=e0.clone(),
        best_step=zeros,
        no_improve=zeros.clone(),
        done=torch.zeros(C, dtype=torch.bool, device=device),
        stop_step=zeros + spec.n_steps,
        accept_bins=bins,
        total_bins=bins.clone(),
    )


def init_carry(chain_key, spec: ChainSpec, queens0=None, *,
               device) -> Full3DCarry:
    """One chain's carry (unbatched fields) from its ``(2,)`` key;
    ``queens0`` warm-starts it from ``(Q, 3)`` distinct cells."""
    batch = init_carry_batch(
        torch.as_tensor(chain_key, device=device)[None], spec,
        None if queens0 is None else torch.as_tensor(queens0)[None],
        device=device)
    return Full3DCarry(**{name: None if v is None else v[0]
                          for name, v in vars(batch).items()})


@dataclasses.dataclass
class SegmentState:
    """One segment's working state, chains minor.  Updated in place."""

    queens: torch.Tensor           # (3Q, C) int32: row 3q + axis
    best_queens: torch.Tensor      # (3Q, C) int32
    occ: torch.Tensor              # (N^3, C) uint8
    table: Optional[torch.Tensor]  # (T13, C) int32, None for "naive"
    energy: torch.Tensor           # (C,) int32
    best_energy: torch.Tensor      # (C,)
    best_step: torch.Tensor        # (C,)
    no_improve: torch.Tensor       # (C,)
    done: torch.Tensor             # (C,) 0 / 1
    stop_step: torch.Tensor        # (C,)
    accept_bins: torch.Tensor      # (n_bins, C)
    total_bins: torch.Tensor       # (n_bins, C)
    step_base: torch.Tensor        # (2, C) key words as int32 bits


_ROWS = ("energy", "best_energy", "best_step", "no_improve", "stop_step")
_PLANES = ("queens", "best_queens", "table", "accept_bins", "total_bins")


def segment_state(carry: Full3DCarry) -> SegmentState:
    """Transpose a carry into a fresh chains-minor :class:`SegmentState`."""
    with profiling.span("mcq.transpose"):
        kw = segment.chains_minor(carry, _PLANES, _ROWS)
        kw["occ"] = carry.occ.to(torch.uint8).t().contiguous()
        kw["done"] = carry.done.to(torch.int32)
        kw["step_base"] = rng.as_int32(carry.step_base).t().contiguous()
        return SegmentState(**kw)


def carry_of(st: SegmentState) -> Full3DCarry:
    """Inverse of :func:`segment_state`."""
    with profiling.span("mcq.transpose"):
        kw = segment.chains_major(st, _PLANES, _ROWS, row_shape=(-1,))
        C = st.energy.shape[0]
        for name in ("queens", "best_queens"):
            kw[name] = kw[name].reshape(C, -1, 3)
        kw["occ"] = st.occ.t() != 0
        kw["done"] = st.done != 0
        kw["step_base"] = rng.from_int32(st.step_base).t().contiguous()
        return Full3DCarry(**kw)


def _draw_unoccupied(keys: torch.Tensor, occ: torch.Tensor,
                    N3: int) -> torch.Tensor:
    """Per chain, a uniform cell of the complement of ``occ`` (``(C, N^3)``
    bool) by exact rejection sampling: ``k, sub = split(k)``, ``cell =
    randint(sub, N^3)`` until the cell is free (the reference's ``while pos
    in occ_set`` loop).  Chains that are done keep drawing too, as JAX's
    batched loop does; their cells are discarded."""

    def fresh(k):
        s = rng.split(k, 2)
        return s[:, 0], rng.randint(s[:, 1], (), 0, N3)

    k, cell = fresh(keys)
    pending = occ.gather(1, cell[:, None].long())[:, 0]
    while bool(pending.any()):
        k2, c2 = fresh(k)
        k = torch.where(pending[:, None], k2, k)
        cell = torch.where(pending, c2, cell)
        pending = pending & occ.gather(1, cell[:, None].long())[:, 0]
    return cell


def segment_reference(st: SegmentState, ys: torch.Tensor, start_outer: int,
                      n_outer: int, spec: ChainSpec,
                      beta: torch.Tensor) -> None:
    """Plain-torch twin of the CUDA kernel (same contract as
    :func:`mcqueens_torch.chain.board.segment_reference`)."""
    N, Q, stride = spec.N, spec.q_eff, spec.history_stride
    N3, nb, n_steps = N ** 3, spec.n_bins, spec.n_steps
    patience = spec.early_stop_patience
    C = st.energy.shape[0]
    keys = rng.from_int32(st.step_base).t()
    qs = st.queens.t().unflatten(1, (Q, 3))        # (C, Q, 3) views
    bq = st.best_queens.t().unflatten(1, (Q, 3))
    occ = st.occ.t()                               # (C, N^3) view
    tab = None if st.table is None else st.table.t()
    rows = torch.arange(C, device=st.energy.device)
    e, be, bs = st.energy.clone(), st.best_energy.clone(), st.best_step.clone()
    ni, stp, done = st.no_improve.clone(), st.stop_step.clone(), st.done != 0
    step0 = start_outer * stride
    for o in range(n_outer):
        for t in range(o * stride, min((o + 1) * stride, n_steps - step0)):
            gstep = step0 + t
            k = rng.split(rng.fold_in(keys, gstep), 3)
            q_idx = rng.randint(k[:, 0], (), 0, Q).long()
            new_cell = _draw_unoccupied(k[:, 1], occ != 0, N3).long()
            u = rng.uniform(k[:, 2])
            old = qs[rows, q_idx]                  # (C, 3)
            old_cell = init_mod.queens_to_cells(old, N)
            new = torch.stack([new_cell // (N * N), (new_cell // N) % N,
                               new_cell % N], dim=1).to(torch.int32)
            old_pos, new_pos = old.unbind(1), new.unbind(1)
            if tab is not None:
                de, idx_old, idx_new = tables_mod.full3d_delta_e(
                    tab, old_pos, new_pos, N)
            else:
                de = (energy_mod.full3d_conflicts(qs, q_idx, new_pos)
                      - energy_mod.full3d_conflicts(qs, q_idx, old_pos))
            accept = u < torch.exp(-beta[t] * de.to(torch.float32))
            active = ~done
            upd = accept & active
            qs[rows, q_idx] = torch.where(upd[:, None], new, old)
            occ[rows, old_cell] = torch.where(upd, 0, occ[rows, old_cell])
            occ[rows, new_cell] = torch.where(upd, 1, occ[rows, new_cell])
            if tab is not None:
                tables_mod.apply_move(tab, idx_old, idx_new, upd)
            e = e + torch.where(upd, de, 0)
            improved = upd & (e < be)
            bq.copy_(torch.where(improved[:, None, None], qs, bq))
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


def scan_layout(N: int, Q: int, kernel: str, C: int,
                n_sm: int) -> ScanLayout:
    """The CUDA kernel's layout for ``C`` chains of ``Q`` queens in the N^3
    cube on a card of ``n_sm`` SMs.  A chain's slot is its queens and best
    queens (``3Q`` words each), its occupancy bytes rounded up to words and,
    for ``tables``, the 13-family table; it goes to shared memory whenever
    it fits a block (``tables`` at Q = N^2 up to N = 35):
    :func:`~mcqueens_torch.chain.board.slot_layout`."""
    words = 6 * Q + -(-N ** 3 // 4) + (
        tables_mod.table_size(N, full3d=True) if kernel == "tables" else 0)
    return slot_layout(4 * words, C, n_sm)


# One launch of the CUDA kernel, counted (segment.launch).
segment_cuda = functools.partial(segment.launch, _SAMPLER)


def launch_segment(lib, st: SegmentState, ys: torch.Tensor,
                   start_outer: int, n_outer: int, spec: ChainSpec,
                   beta: torch.Tensor, n_sm: int, stream: int = 0) -> None:
    """Check a segment's arguments, lay it out for ``n_sm`` SMs
    (:func:`scan_layout`) and call ``lib.mcq_full3d_scan_segment`` on
    ``stream``; raises if it returns an error.  ``lib`` is the CUDA library
    (:func:`segment_cuda`) or its host emulation
    (:mod:`mcqueens_torch.kernels.host_emulation`, CPU tensors)."""
    N, Q, C, nb = spec.N, spec.q_eff, st.energy.shape[0], spec.n_bins
    stride = spec.history_stride
    i32 = torch.int32
    want = {
        "queens": (st.queens, (3 * Q, C), i32),
        "best_queens": (st.best_queens, (3 * Q, C), i32),
        "occ": (st.occ, (N ** 3, C), torch.uint8),
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
        want["table"] = (st.table,
                         (tables_mod.table_size(N, full3d=True), C), i32)
    _build.check_args(st.queens.device, want)
    if C == 0:
        raise ValueError("no chains")
    if not 1 <= Q < N ** 3:
        raise ValueError(f"Q={Q} must be in [1, N^3)")
    check_steps(start_outer, n_outer, stride)
    layout = scan_layout(N, Q, spec.kernel, C, n_sm)
    ptrs = [ctypes.c_void_p(None if t is None else t.data_ptr()) for t in (
        st.queens, st.best_queens, st.occ, st.table, st.energy,
        st.best_energy, st.best_step, st.no_improve, st.done, st.stop_step,
        st.accept_bins, st.total_bins, st.step_base, beta, ys)]
    patience = spec.early_stop_patience
    err = lib.mcq_full3d_scan_segment(
        *ptrs, start_outer, n_outer, stride, N, Q, C, spec.n_steps, nb,
        -1 if patience is None else patience, layout.chains_per_block,
        layout.smem_bytes, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"full3d_scan CUDA kernel launch failed "
                           f"(cudaError {err})")


def run_segment(carry: Full3DCarry, start_outer: int, spec: ChainSpec,
                n_outer: int):
    """Advance by ``n_outer`` history chunks; returns ``(carry, ys)``."""
    st = segment_state(carry)
    ys = segment.call_scan(_SAMPLER, st, int(start_outer), n_outer, spec)
    return carry_of(st), ys
