"""Multi-run orchestration, port of :mod:`mcqueens.dist.runner`.

All runs are one batch of chains on ``device``, or sharded over a chains
mesh (:mod:`mcqueens_torch.dist.mesh`).  Long runs execute as
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
from mcqueens_torch.dist import mesh as mesh_mod
from mcqueens_torch.kernels import (board_shared, full3d_pallas,
                                   full3d_shared, metropolis_pallas)
from mcqueens_torch.utils import checkpoint, profiling

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
    numpy arrays (from a card: views of pinned memory, which returns to
    torch's caching host allocator with the result); ``device`` names where
    the chains ran."""

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
    wall_time: float             # the call's wall clock, entry to return
    device: str
    devices: tuple = ()          # the distinct devices the chains ran on

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


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``: ``cpu``, or ``cuda`` where torch
    sees a card (``RuntimeError`` otherwise); ``ValueError`` for any other
    type."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def sampler_module(spec: ChainSpec):
    """The sampler module of ``spec``'s kernel and move type."""
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


# Takes of result fields by :func:`drain`: one a field and shard.
DRAIN_COPIES = 0

# The fields of a ChainResult that :func:`drain` reads off the final carry.
CHAIN_FIELDS = ("energy", "best_energy", "best_step", "stop_step",
                "accept_bins", "total_bins", "final_state", "best_state")


def host_empty(shape, dtype: torch.dtype, device: torch.device):
    """An empty host tensor for results read from ``device``: pinned, from
    torch's caching host allocator, for a card (each copy lands in it
    directly, the cards' copies overlap, and a dropped result's blocks serve
    the next search), plain memory for the CPU."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def _laid_out(carry, name: str, spec: ChainSpec) -> torch.Tensor:
    """Result field ``name`` of one carry, in its final shape and dtype on
    the carry's device: a (C,) row, (C, n_bins) bins, ``final_state`` /
    ``best_state`` as (C, N, N) int64 boards or (C, Q, 3) int32 queens (the
    Pallas samplers' planes stacked), ``proposals`` the carry's total
    proposals as a (1,) int64."""
    if name in ("final_state", "best_state"):
        best = "best_" if name == "best_state" else ""
        if spec.mcmc_type == "board":
            return getattr(carry, best + "heights").reshape(
                -1, spec.N, spec.N).to(torch.int64)
        if _scan(spec):
            return getattr(carry, best + "queens")
        return torch.stack([getattr(carry, f"{best}q{a}") for a in "ijk"],
                           dim=-1)
    if name == "proposals":
        return carry.total_bins.sum(dtype=torch.int64).reshape(1)
    t = getattr(carry, name)
    return t if name.endswith("_bins") else t.reshape(-1)


def drain(state, names, spec: ChainSpec) -> dict:
    """The result fields ``names`` of a run's final carry (one carry, or a
    mesh's shard carries in shard order) as host arrays in their final
    shapes, each copied from the card once.

    Each shard's field is laid out on its own device (:func:`_laid_out`) and
    its copy enqueued into its rows of one array of :func:`host_empty`;
    every card is synchronised once, after all the copies (span
    ``mcq.sync``).  One carry on the CPU gives zero-copy views.  Adds one to
    ``DRAIN_COPIES`` a field and shard.
    """
    global DRAIN_COPIES
    shards = state if isinstance(state, tuple) else (state,)
    out, devices = {}, []
    with profiling.span("mcq.read"):
        for name in names:
            parts = [_laid_out(c, name, spec) for c in shards]
            DRAIN_COPIES += len(parts)
            first = parts[0]
            if len(parts) == 1 and first.device.type == "cpu":
                out[name] = first.numpy()
                continue
            host = host_empty((sum(p.shape[0] for p in parts),)
                              + tuple(first.shape[1:]), first.dtype,
                              first.device)
            row = 0
            for p in parts:
                host[row:row + p.shape[0]].copy_(p, non_blocking=True)
                row += p.shape[0]
                devices.append(p.device)
            out[name] = host.numpy()
    mesh_mod.synchronize(mesh_mod.distinct(devices))
    return out


def history_rows(rows: np.ndarray, chunks, start: int) -> list:
    """Restored history ``chunks`` copied into ``rows`` from row ``start``
    on, one after another; returns them as views of their rows."""
    views = []
    for chunk in chunks:
        view = rows[start:start + len(chunk)]
        view[...] = chunk
        views.append(view)
        start += len(chunk)
    return views


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

    ``mesh`` (a tuple of devices of ``device``'s type, see
    :func:`mcqueens_torch.dist.mesh.make_mesh`; ``ValueError`` if the types
    differ) shards the batch as the JAX package does: the chains are padded
    to a multiple of the mesh size with follow-on seeds (warm starts repeat
    the last one), the Pallas samplers' to whole blocks a shard with the
    block sized from one shard's share; the whole carry is built once (block
    seeds are global) and split, and every segment runs each shard on its
    device.  The result equals an unsharded run's bitwise for the per-chain
    and scan samplers, and an unsharded run's at the same block for the
    shared-site ones.  ``checkpointer`` (a
    :class:`mcqueens_torch.utils.checkpoint.Checkpointer`) saves the whole
    carry after every segment (gathered in shard order) and resumes from a
    saved segment when one matches this run.  ``profile_dir`` writes a
    ``torch.profiler`` trace of the run there
    (:func:`mcqueens_torch.utils.profiling.trace`, with the call's spans).
    The result's ``wall_time`` is the call's ``mcq.search`` span: init, the
    segments and the drain.
    """
    dev = resolve_device(device)
    if mesh is not None:
        mesh = mesh_mod.check_mesh(mesh, dev)
    with profiling.trace(profile_dir), profiling.span("mcq.search"):
        t0 = time.time()
        with profiling.span("mcq.init"):
            mod = sampler_module(spec)
            seeds = np.asarray(seeds, dtype=np.uint32)
            n_runs = seeds.shape[0]
            if initial_states is not None:
                initial_states = validate_initial_states(
                    initial_states, spec, n_runs)
            n_padded = mesh_mod.pad_chains(n_runs, mesh)
            if n_padded > n_runs:
                # Follow-on seeds; padded chains are discarded.
                pad = seeds[-1] + 1 + np.arange(n_padded - n_runs,
                                                dtype=np.uint32)
                seeds = np.concatenate([seeds, pad])
                if initial_states is not None:
                    reps = np.repeat(initial_states[-1:],
                                     n_padded - n_runs, axis=0)
                    initial_states = np.concatenate([initial_states, reps])
            block = None
            if mesh is not None and not _scan(spec):
                # Each shard owns whole blocks (init_carry_batch pads any
                # shorter initial_states by repeating the last warm start).
                seeds, block = mesh_mod.pad_seeds_to_blocks(
                    seeds, mesh, lambda c: mod.block_size(c, spec))
            home = dev if mesh is None else mesh[0]

            n_outer = spec.n_outer
            if verbose:
                min_segments = max(min_segments, 10)
            if checkpointer is not None:
                min_segments = max(min_segments, checkpointer.min_segments)
            n_segs, seg_outer = plan_segments(
                n_outer, n_padded, spec.history_stride, min_segments)

            # The scan samplers take one threefry key per chain, the Pallas
            # samplers the seeds themselves (mcqueens/dist/runner.py:199-205).
            if _scan(spec):
                carry = mod.init_carry_batch(
                    rng_mod.chain_keys_from_seeds(seeds, home), spec,
                    initial_states=initial_states, device=home)
            else:
                carry = mod.init_carry_batch(seeds, spec, block=block,
                                             initial_states=initial_states,
                                             device=home)
            # The energy history: the initial energies, then each
            # segment's ys written into its rows as it is read.
            hist = host_empty((1 + n_segs * seg_outer,
                               carry.energy.shape[0]), carry.energy.dtype,
                              home)
            rows = hist.numpy()
            with profiling.span("mcq.read"):
                hist[0].copy_(carry.energy.reshape(-1))
            history_chunks = []
            start_seg = 0
            if checkpointer is not None:
                ckpt_fp = checkpoint.spec_fingerprint(spec, seeds)
                resumed = checkpointer.restore(carry, seg_outer=seg_outer,
                                               fingerprint=ckpt_fp)
                if resumed is not None:
                    carry, start_seg, chunks = resumed
                    history_chunks = history_rows(rows, chunks, 1)
            if mesh is None:
                state = carry
            else:
                state = mesh_mod.shard_chains(carry, mesh)
            del carry
        for seg in range(start_seg, n_segs):
            with profiling.span("mcq.round"):
                # On a mesh each shard advances its own blocks on its device.
                step = lambda c: mod.run_segment(
                    c, seg * seg_outer, spec, seg_outer)
                state, ys = (step(state) if mesh is None
                             else mesh_mod.run_sharded(step, state, mesh))
                a = 1 + seg * seg_outer
                with profiling.span("mcq.read"):
                    hist[a:a + seg_outer].copy_(ys)  # (seg_outer, C)
                history_chunks.append(rows[a:a + seg_outer])
                if verbose:
                    done_steps = min(
                        (seg + 1) * seg_outer * spec.history_stride,
                        spec.n_steps)
                    e = host_field(state, "energy")[:n_runs]
                    print(f"[mcqueens] step {done_steps}/{spec.n_steps}: "
                          f"mean E={e.mean():.2f} min E={e.min()}")
                if checkpointer is not None:
                    with profiling.span("mcq.checkpoint"):
                        whole = (state if mesh is None
                                 else mesh_mod.gather_chains(state, "cpu"))
                        checkpointer.save(whole, seg + 1, history_chunks,
                                          seg_outer=seg_outer,
                                          fingerprint=ckpt_fp)
        with profiling.span("mcq.drain"):
            devices = (dev,) if mesh is None else mesh_mod.distinct(mesh)
            host = drain(state, CHAIN_FIELDS, spec)
            energy_history = rows[:n_outer + 1].T
            history_steps = np.minimum(
                np.arange(n_outer + 1, dtype=np.int64) * spec.history_stride,
                spec.n_steps)
            stop_step = host["stop_step"]
            # A run stopping at step s recorded ceil(s / stride) points plus
            # the initial one (the reference breaks before appending).
            stopped = stop_step < spec.n_steps
            pts = -(-stop_step // spec.history_stride)
            history_len = np.add(np.where(stopped, pts, n_outer), 1,
                                 dtype=np.int64)

            s = slice(0, n_runs)
            wall = time.time() - t0
            if verbose:
                total_props = int(host["total_bins"].sum())
                print(f"[mcqueens] {total_props:.3e} proposals in "
                      f"{wall:.2f}s = {total_props / max(wall, 1e-9):.3e} "
                      f"moves/s")
            return ChainResult(
                spec=spec,
                energy_history=energy_history[s],
                history_steps=history_steps,
                history_len=history_len[s],
                final_energy=host["energy"][s],
                final_state=host["final_state"][s],
                best_energy=host["best_energy"][s],
                best_state=host["best_state"][s],
                steps_to_best=host["best_step"][s],
                stop_step=stop_step[s],
                accept_bins=host["accept_bins"][s],
                total_bins=host["total_bins"][s],
                wall_time=wall,
                device=str(dev),
                devices=tuple(str(d) for d in devices),
            )


def host_field(state, name: str) -> np.ndarray:
    """A carry field as a host array: of one carry, or of a mesh's shard
    carries joined in shard order (span ``mcq.read``)."""
    with profiling.span("mcq.read"):
        if isinstance(state, tuple):
            return np.concatenate([getattr(c, name).cpu().numpy()
                                   for c in state])
        return getattr(state, name).cpu().numpy()


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
