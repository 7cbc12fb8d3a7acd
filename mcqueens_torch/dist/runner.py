"""Multi-run orchestration on one device, port of :mod:`mcqueens.dist.runner`.

All runs are one batch of chains on ``device``.  Long runs execute as
equal-length segments (:func:`plan_segments`, unchanged from the JAX package
so segment boundaries and histories match) while the host reads each
segment's energy history.  Every kernel of the JAX package is ported, for
boards and full-3D placements: the ``pallas_shared`` samplers
(:mod:`mcqueens_torch.kernels.board_shared`, :mod:`~.full3d_shared`), the
independent-chains ``pallas`` samplers
(:mod:`mcqueens_torch.kernels.metropolis_pallas`, :mod:`~.full3d_pallas`)
and the ``tables``/``naive`` scan samplers (:mod:`mcqueens_torch.chain.board`,
:mod:`~.chain.full3d`, keyed by threefry keys built from the seeds).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from mcqueens_torch.chain import board as board_chain
from mcqueens_torch.chain import full3d as full3d_chain
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import rng as rng_mod
from mcqueens_torch.kernels import (board_shared, full3d_pallas,
                                   full3d_shared, metropolis_pallas)
from mcqueens_torch.utils import checkpoint

_MAX_SEGMENT_ELEMS = 64 * 1024 * 1024
_MAX_SEGMENT_PROPOSALS = 2 ** 31


def plan_segments(n_outer: int, n_padded: int, history_stride: int,
                  min_segments: int = 1) -> tuple[int, int]:
    """Split ``n_outer`` history chunks into host-visible segments;
    returns ``(n_segs, seg_outer)`` with ``n_segs * seg_outer >= n_outer``.

    The caps (64M history points, 2^31 proposals per segment) are the JAX
    package's; keeping them keeps the segment boundaries identical.
    """
    elems_cap = max(1, _MAX_SEGMENT_ELEMS // max(1, n_padded))
    work_cap = max(
        1, _MAX_SEGMENT_PROPOSALS // max(1, n_padded * history_stride))
    max_outer_per_seg = min(elems_cap, work_cap)
    n_segs = max(min_segments, -(-n_outer // max_outer_per_seg), 1)
    n_segs = min(n_segs, n_outer) or 1
    seg_outer = -(-n_outer // n_segs)
    return n_segs, seg_outer


@dataclasses.dataclass
class ChainResult:
    """Batched results for R chains (axis 0 = run/chain index), as host
    numpy arrays; ``device`` names where the chains ran."""

    spec: ChainSpec
    energy_history: np.ndarray   # (R, P) int32
    history_steps: np.ndarray    # (P,) int64 step index of each history point
    history_len: np.ndarray      # (R,) reference-equivalent history length
    final_energy: np.ndarray     # (R,)
    final_state: np.ndarray      # (R, N, N) heights or (R, Q, 3) queens
    best_energy: np.ndarray      # (R,)
    best_state: np.ndarray       # (R, N, N) or (R, Q, 3)
    steps_to_best: np.ndarray    # (R,) best_step of each chain
    stop_step: np.ndarray        # (R,) early-stop step (n_steps if none)
    accept_bins: np.ndarray      # (R, n_bins)
    total_bins: np.ndarray       # (R, n_bins)
    wall_time: float             # whole-batch wall clock (seconds)
    run_times: np.ndarray        # (R,) wall_time for every run of the batch
    device: str

    @property
    def n_runs(self) -> int:
        return self.energy_history.shape[0]

    @property
    def proposals(self) -> int:
        """Total proposed moves across the batch (for throughput reporting)."""
        return int(self.total_bins.sum())

    @property
    def moves_per_sec(self) -> float:
        return self.proposals / max(self.wall_time, 1e-9)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _modules(spec: ChainSpec):
    board = spec.mcmc_type == "board"
    if spec.kernel == "pallas_shared":
        return board_shared if board else full3d_shared
    if spec.kernel == "pallas":
        return metropolis_pallas if board else full3d_pallas
    return board_chain if board else full3d_chain


def validate_initial_states(initial_states, spec: ChainSpec, n_runs: int):
    """Explicit warm starts: (n_runs, N, N) board heights in [0, N), or
    (n_runs, Q, 3) full-3D queens on distinct cells of [0, N)^3."""
    arr = np.asarray(initial_states)
    board = spec.mcmc_type == "board"
    want = (n_runs, spec.N, spec.N) if board else (n_runs, spec.q_eff, 3)
    if arr.shape != want:
        raise ValueError(f"initial_states must have shape {want}, got {arr.shape}")
    if ((arr < 0) | (arr >= spec.N)).any():
        what = "heights" if board else "coordinates"
        raise ValueError(f"All {what} must be in [0, {spec.N - 1}]")
    if not board:
        N = spec.N
        cells = np.sort((arr[..., 0].astype(np.int64) * N + arr[..., 1]) * N
                        + arr[..., 2], axis=1)
        if (np.diff(cells, axis=1) == 0).any():
            raise ValueError("Two queens occupy the same (i,j,k) cell.")
    return arr.astype(np.int32)


def _scan(spec: ChainSpec) -> bool:
    return spec.kernel in ("tables", "naive")


def state_fields(spec: ChainSpec) -> tuple[str, ...]:
    """Carry fields read back at the end of a run."""
    if spec.mcmc_type == "board":
        state = ("heights", "best_heights")
    elif _scan(spec):
        state = ("queens", "best_queens")
    else:
        state = ("qi", "qj", "qk", "best_qi", "best_qj", "best_qk")
    return ("energy", "best_energy", "best_step", "stop_step", "accept_bins",
            "total_bins") + state


def states_of(host: dict, spec: ChainSpec):
    """``(best_state, final_state)`` from host carry arrays: (C, N, N)
    int64 boards, or (C, Q, 3) int32 queens (stacked from the planes of
    the Pallas samplers' carries)."""
    if spec.mcmc_type == "board":
        return tuple(host[name].astype(np.int64).reshape(-1, spec.N, spec.N)
                     for name in ("best_heights", "heights"))
    if _scan(spec):
        return host["best_queens"], host["queens"]
    return (np.stack([host[f"best_q{a}"] for a in "ijk"], axis=-1),
            np.stack([host[f"q{a}"] for a in "ijk"], axis=-1))


def run_chains(
    seeds,
    spec: ChainSpec,
    *,
    device,
    mesh=None,
    verbose: bool = False,
    min_segments: int = 1,
    checkpointer=None,
    profile_dir: Optional[str] = None,
    initial_states=None,
) -> ChainResult:
    """Run one chain per seed as one batch on ``device`` ("cpu" or "cuda").

    ``checkpointer`` (a :class:`mcqueens_torch.utils.checkpoint.Checkpointer`)
    saves the carry after every segment and resumes from a saved segment
    when one matches this run.  ``mesh`` and ``profile_dir`` are not ported
    yet (ROADMAP.md queue 1 item 7) and raise if set.
    """
    dev = _device(device)
    if mesh is not None:
        raise NotImplementedError("multi-device chain sharding is not "
                                  "ported yet (ROADMAP.md queue 1 item 7)")
    if profile_dir is not None:
        raise NotImplementedError("profiler traces are not ported yet "
                                  "(ROADMAP.md queue 1 item 7)")
    mod = _modules(spec)
    seeds = np.asarray(seeds, dtype=np.uint32)
    n_runs = seeds.shape[0]
    if initial_states is not None:
        initial_states = validate_initial_states(initial_states, spec, n_runs)

    n_outer = spec.n_outer
    if verbose:
        min_segments = max(min_segments, 10)
    if checkpointer is not None:
        min_segments = max(min_segments, checkpointer.min_segments)
    n_segs, seg_outer = plan_segments(
        n_outer, n_runs, spec.history_stride, min_segments)

    t0 = time.time()
    # The scan samplers take one threefry key per chain, the Pallas samplers
    # the seeds themselves (mcqueens/dist/runner.py:199-205).
    init_arg = (rng_mod.chain_keys_from_seeds(seeds, dev) if _scan(spec)
                else seeds)
    carry = mod.init_carry_batch(init_arg, spec,
                                 initial_states=initial_states, device=dev)
    e0 = carry.energy.reshape(-1).cpu().numpy()
    history_chunks = []
    start_seg = 0
    if checkpointer is not None:
        ckpt_fp = checkpoint.spec_fingerprint(spec, seeds)
        resumed = checkpointer.restore(carry, seg_outer=seg_outer,
                                       fingerprint=ckpt_fp)
        if resumed is not None:
            carry, start_seg, history_chunks = resumed
    for seg in range(start_seg, n_segs):
        carry, ys = mod.run_segment(carry, seg * seg_outer, spec, seg_outer)
        history_chunks.append(ys.cpu().numpy())  # (seg_outer, C)
        if verbose:
            done_steps = min((seg + 1) * seg_outer * spec.history_stride,
                             spec.n_steps)
            e = carry.energy[:n_runs].cpu().numpy()
            print(f"[mcqueens] step {done_steps}/{spec.n_steps}: "
                  f"mean E={e.mean():.2f} min E={e.min()}")
        if checkpointer is not None:
            checkpointer.save(carry, seg + 1, history_chunks,
                              seg_outer=seg_outer, fingerprint=ckpt_fp)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    host = {name: getattr(carry, name).cpu().numpy()
            for name in state_fields(spec)}
    if verbose:
        total_props = int(host["total_bins"].sum())
        print(f"[mcqueens] {total_props:.3e} proposals in {wall:.2f}s "
              f"= {total_props / max(wall, 1e-9):.3e} moves/s")

    hist = np.concatenate(history_chunks, axis=0)[:n_outer]  # (n_outer, C)
    energy_history = np.concatenate([e0[None, :], hist], axis=0).T  # (C, P)
    history_steps = np.minimum(
        np.arange(n_outer + 1, dtype=np.int64) * spec.history_stride,
        spec.n_steps)
    stop_step = host["stop_step"].reshape(-1)
    # A run stopping at step s recorded ceil(s / stride) points plus the
    # initial one (the reference breaks before appending).
    stopped = stop_step < spec.n_steps
    pts = -(-stop_step // spec.history_stride)
    history_len = (np.where(stopped, pts, n_outer) + 1).astype(np.int64)

    best_state, final_state = states_of(host, spec)
    s = slice(0, n_runs)
    return ChainResult(
        spec=spec,
        energy_history=energy_history[s],
        history_steps=history_steps,
        history_len=history_len[s],
        final_energy=host["energy"].reshape(-1)[s],
        final_state=final_state[s],
        best_energy=host["best_energy"].reshape(-1)[s],
        best_state=best_state[s],
        steps_to_best=host["best_step"].reshape(-1)[s],
        stop_step=stop_step[s],
        accept_bins=host["accept_bins"][s],
        total_bins=host["total_bins"][s],
        wall_time=wall,
        run_times=np.full((n_runs,), wall),
        device=str(dev),
    )


def run_experiment(
    N: int,
    n_steps: int,
    init_mode: str,
    schedule,
    n_runs: int,
    base_seed: int = 0,
    *,
    device,
    mcmc_type: str = "board",
    early_stop_patience=100000,
    verbose: bool = False,
    mesh=None,
    history_stride: int = 1,
    kernel: str = "tables",
    n_bins: int = 100,
    checkpointer=None,
    Q: Optional[int] = None,
) -> ChainResult:
    """Experiment entry point: ``n_runs`` chains with seeds
    ``base_seed + r``, as :func:`mcqueens.dist.runner.run_experiment`."""
    if early_stop_patience in (None, "None", "null"):
        early_stop_patience = None
    spec = ChainSpec(
        N=N,
        n_steps=n_steps,
        schedule=schedule,
        init_mode=init_mode,
        mcmc_type=mcmc_type,
        early_stop_patience=(None if mcmc_type == "full_3d"
                             else early_stop_patience),
        history_stride=history_stride,
        kernel=kernel,
        n_bins=n_bins,
        Q=Q,
    )
    seeds = base_seed + np.arange(n_runs, dtype=np.int64)
    return run_chains(
        np.asarray(seeds, dtype=np.uint32),
        spec,
        device=device,
        mesh=mesh,
        verbose=verbose,
        checkpointer=checkpointer,
    )
