"""Parallel tempering (replica exchange), port of
:mod:`mcqueens.search.tempering`.

Chain ``c`` sits at ladder level ``c % L`` of replica group ``c // L``.
Segments of ``history_stride`` steps run through the shared-site samplers'
tempered mode (each chain at ``schedule(step) * beta[c]``); between them,
adjacent levels of each group try to swap their betas with acceptance
``min(1, exp((beta_lo - beta_hi) * (E_lo - E_hi)))``, odd and even pairs in
turn.  States never move, only temperatures.  The swap draws are a counter
hash of (swap seed, round, group, pair), so they match the JAX package's bit
for bit; :func:`exchange` is plain torch on the chains' device (it is XLA,
not a kernel, in the JAX package too).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.dist import mesh as mesh_mod
from mcqueens_torch.dist import runner as runner_mod
from mcqueens_torch.kernels import prng
from mcqueens_torch.utils import checkpoint, profiling

_GROUP_K = prng._i32(0xB5297A4D)  # group-id stride
_PAIR_K = prng._i32(0x1B873593)   # pair-id stride
_ROUND_K = prng._i32(0x9E3779B9)  # round stride

# The fields that :func:`run_tempered` drains off the final carry
# (:func:`mcqueens_torch.dist.runner.drain`).
RESULT_FIELDS = ("energy", "best_energy", "proposals", "final_state",
                 "best_state")


def geometric_ladder(beta_min: float, beta_max: float, n_levels: int):
    """Geometric beta ladder (constant acceptance ratio heuristic)."""
    if n_levels < 2:
        raise ValueError("need at least 2 ladder levels")
    if not 0 < beta_min < beta_max:
        raise ValueError("need 0 < beta_min < beta_max")
    return np.geomspace(beta_min, beta_max, n_levels).astype(np.float32)


def round_key(swap_seed: int, round_idx: int) -> np.int32:
    """int32 counter for one exchange sweep's accept draws: a pure function
    of (swap_seed, round), mixed in uint64 and cut to 32 bits."""
    mixed = (np.uint64(np.uint32(swap_seed))
             * np.uint64(np.uint32(prng._CHAIN_K & 0xFFFFFFFF))
             + np.uint64(np.uint32(round_idx))
             * np.uint64(np.uint32(_ROUND_K & 0xFFFFFFFF)))
    return np.int32(np.uint32(mixed & np.uint64(0xFFFFFFFF)))


def exchange(betas: torch.Tensor, energies: torch.Tensor, rkey,
             n_levels: int, phase: int) -> torch.Tensor:
    """One replica-exchange sweep: swap betas between adjacent ladder levels.

    ``betas`` (C,) float32 and ``energies`` (C,) int32 lie on one device;
    ``rkey`` is :func:`round_key`'s counter and ``phase`` (0 or 1) picks the
    alternation of pairs.  Tail chains beyond the last full group keep their
    beta.  Returns the new (C,) betas; each group's multiset is invariant.
    """
    C = betas.shape[0]
    G = C // n_levels
    paired = G * n_levels
    dev = betas.device
    b = betas[:paired].reshape(G, n_levels)
    e = energies[:paired].reshape(G, n_levels).to(torch.float32)
    lo = torch.arange(phase, n_levels - 1, 2, device=dev)
    hi = lo + 1
    bl, bh = b[:, lo], b[:, hi]
    log_a = (bl - bh) * (e[:, lo] - e[:, hi])
    gids = torch.arange(G, dtype=torch.int32, device=dev)[:, None]
    pids = lo.to(torch.int32)[None, :]
    w = prng.lowbias32(
        prng.lowbias32(int(rkey) ^ (gids * _GROUP_K) ^ _PAIR_K)
        + pids * _PAIR_K)
    # u == 0 (a 2^-24 event) is clamped away so the log stays finite.
    u = torch.clamp_min(prng.uniform01(w), 1e-12)
    swap = torch.log(u) < log_a
    b = b.clone()
    b[:, lo] = torch.where(swap, bh, bl)
    b[:, hi] = torch.where(swap, bl, bh)
    return torch.cat([b.reshape(-1), betas[paired:]])


def run_tempered(
    seeds,
    spec: ChainSpec,
    ladder,
    *,
    device,
    swap_seed: int = 0,
    initial_states=None,
    verbose: bool = False,
    record_betas: bool = False,
    exchange_interval: int = 1,
    mesh=None,
    checkpointer=None,
    stop_at_energy=None,
):
    """Parallel-tempered chains with periodic replica exchange on ``device``.

    Same arguments and result dict as
    :func:`mcqueens.search.tempering.run_tempered`: ``spec.schedule``
    multiplies the ladder, an exchange sweep runs every
    ``exchange_interval`` segments, ``stop_at_energy`` ends the search after
    the first round whose best energy is at or below it, and
    ``record_betas`` adds the per-round beta assignments.  ``checkpointer``
    saves (carry, betas) after each round at its cadence and resumes a
    killed search bit for bit; no RNG state is stored, since the swap stream
    is a pure function of (swap_seed, round).

    ``mesh`` (devices of ``device``'s type) shards the chains: the seeds are
    padded to whole blocks a shard, the block sized from one shard's share
    (:func:`mcqueens_torch.dist.mesh.pad_seeds_to_blocks`), which must be a
    multiple of the ladder length so that no ladder group straddles two
    shards (``ValueError`` otherwise).  Segments run shard by shard; the
    exchange runs on the first device over every shard's energies, so each
    group's swap draws stay keyed by its global group id.

    The result's ``wall_time`` is the call's ``mcq.search`` span: init, the
    rounds and the drain (:func:`mcqueens_torch.utils.profiling.span`).
    """
    dev = runner_mod.resolve_device(device)
    if mesh is not None:
        mesh = mesh_mod.check_mesh(mesh, dev)
    with profiling.span("mcq.search"):
        t0 = time.time()
        with profiling.span("mcq.init"):
            if spec.kernel != "pallas_shared":
                raise ValueError(
                    "run_tempered requires kernel='pallas_shared'")
            kmod = runner_mod.sampler_module(spec)
            if exchange_interval < 1:
                raise ValueError("exchange_interval must be >= 1")
            ladder = np.asarray(ladder, np.float32)
            n_levels = int(ladder.shape[0])
            seeds = np.asarray(seeds, dtype=np.uint32)
            n_runs = seeds.shape[0]
            if initial_states is not None:
                initial_states = runner_mod.validate_initial_states(
                    initial_states, spec, n_runs)

            block, padded = None, seeds
            if mesh is not None:
                padded, block = mesh_mod.pad_seeds_to_blocks(
                    seeds, mesh, lambda c: kmod.block_size(c, spec))
                if block % n_levels:
                    raise ValueError(
                        f"block size {block} must be a multiple of the "
                        f"ladder length {n_levels} (ladder groups must not "
                        f"straddle devices)")
            home = dev if mesh is None else mesh[0]
            carry = kmod.init_carry_batch(padded, spec, block=block,
                                          initial_states=initial_states,
                                          device=home)
            C = int(carry.energy.shape[0])
            reps = -(-C // n_levels)
            betas = torch.from_numpy(np.tile(ladder, reps)[:C]).to(home)

            # The energy history (the initial energies, then each round's
            # ys) and, with record_betas, the betas of each round, written
            # into their rows as they are read.
            hist = runner_mod.host_empty((1 + spec.n_outer, C),
                                         carry.energy.dtype, home)
            rows = hist.numpy()
            with profiling.span("mcq.read"):
                hist[0].copy_(carry.energy.reshape(-1))
            history, done = [rows[:1]], 1
            n_rounds = -(-spec.n_outer // exchange_interval)
            if record_betas:
                betas_hist = runner_mod.host_empty((n_rounds, C),
                                                   torch.float32, home)
                betas_rows = betas_hist.numpy()
            start_round = 0
            if checkpointer is not None:
                fp = checkpoint.spec_fingerprint(spec, seeds)
                # record_betas changes the checkpoint payload (the beta
                # history rides in the extras), so it is part of the run
                # identity.
                fp = checkpoint.extend_fingerprint(
                    fp, ladder, np.uint32(swap_seed),
                    np.int64(exchange_interval), np.bool_(record_betas))
                resumed = checkpointer.restore(
                    carry, seg_outer=exchange_interval, fingerprint=fp,
                    n_extras=2 if record_betas else 1)
                if resumed is not None:
                    carry, start_round, chunks, extras = resumed
                    betas = torch.from_numpy(
                        np.asarray(extras[0], np.float32)).to(home)
                    if record_betas:
                        betas_rows[:len(extras[1])] = extras[1]
                    history = runner_mod.history_rows(rows, chunks, 0)
                    done = sum(len(chunk) for chunk in chunks)
            state = (carry if mesh is None
                     else mesh_mod.shard_chains(carry, mesh))
            del carry
        for r in range(start_round, n_rounds):
            with profiling.span("mcq.round"):
                seg0 = r * exchange_interval
                n_seg = min(exchange_interval, spec.n_outer - seg0)
                # On a mesh each shard's slice of the betas goes with it.
                step = lambda c, b: kmod.run_segment_tempered(
                    c, b, seg0, spec, n_seg)
                state, ys = (step(state, betas) if mesh is None else
                             mesh_mod.run_sharded(step, state, mesh, betas))
                with profiling.span("mcq.read"):
                    hist[done:done + n_seg].copy_(ys)
                history.append(rows[done:done + n_seg])
                done += n_seg
                if record_betas:
                    # The betas under which this round's samples were
                    # generated.
                    with profiling.span("mcq.read"):
                        betas_hist[r].copy_(betas)
                if r + 1 < n_rounds:
                    with profiling.span("mcq.exchange"):
                        energies = (state.energy if mesh is None else
                                    mesh_mod.gather_chains(
                                        [c.energy for c in state]))
                        betas = exchange(betas, energies.reshape(-1),
                                         round_key(swap_seed, r), n_levels,
                                         r % 2)
                if checkpointer is not None:
                    with profiling.span("mcq.checkpoint"):
                        extras = (betas.cpu().numpy(),)
                        if record_betas:
                            extras += (betas_rows[:r + 1],)
                        whole = (state if mesh is None
                                 else mesh_mod.gather_chains(state, "cpu"))
                        checkpointer.save(whole, r + 1, history,
                                          seg_outer=exchange_interval,
                                          fingerprint=fp, extras=extras)
                if verbose and (r + 1) % max(1, n_rounds // 10) == 0:
                    e = runner_mod.host_field(state, "energy").reshape(-1)
                    be = runner_mod.host_field(state, "best_energy").reshape(-1)
                    print(f"[tempering] round {r + 1}/{n_rounds}: "
                          f"mean E={e[:n_runs].mean():.2f} "
                          f"best={be[:n_runs].min()}")
                if stop_at_energy is not None:
                    be = runner_mod.host_field(
                        state, "best_energy").reshape(-1)[:n_runs]
                    if be.min() <= stop_at_energy:
                        if verbose:
                            print(f"[tempering] early stop at round "
                                  f"{r + 1}/{n_rounds}: best={be.min()}")
                        break
        with profiling.span("mcq.drain"):
            host = runner_mod.drain(state, RESULT_FIELDS, spec)
            s = slice(0, n_runs)
            with profiling.span("mcq.read"):
                final_betas = betas.cpu().numpy()
            out = {
                "best_energy": host["best_energy"][s],
                "best_state": host["best_state"][s],
                "final_energy": host["energy"][s],
                "final_state": host["final_state"][s],
                "energy_history": rows[:done].T[s],
                "betas": final_betas[s],
                "ladder": ladder,
                "proposals": int(host["proposals"].sum()),
            }
            if record_betas:
                out["betas_history"] = betas_rows[:len(history) - 1, :n_runs]
            out["wall_time"] = time.time() - t0
            return out
