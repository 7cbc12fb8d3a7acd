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
from mcqueens_torch.dist import runner as runner_mod
from mcqueens_torch.kernels import prng
from mcqueens_torch.utils import checkpoint

_GROUP_K = prng._i32(0xB5297A4D)  # group-id stride
_PAIR_K = prng._i32(0x1B873593)   # pair-id stride
_ROUND_K = prng._i32(0x9E3779B9)  # round stride


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
    is a pure function of (swap_seed, round).  ``mesh`` is not ported yet
    and raises.
    """
    dev = runner_mod._device(device)
    if mesh is not None:
        raise NotImplementedError("multi-device chain sharding is not "
                                  "ported yet (ROADMAP.md queue 1 item 7)")
    if spec.kernel != "pallas_shared":
        raise ValueError("run_tempered requires kernel='pallas_shared'")
    kmod = runner_mod._modules(spec)
    if exchange_interval < 1:
        raise ValueError("exchange_interval must be >= 1")
    ladder = np.asarray(ladder, np.float32)
    n_levels = int(ladder.shape[0])
    seeds = np.asarray(seeds, dtype=np.uint32)
    n_runs = seeds.shape[0]
    if initial_states is not None:
        initial_states = runner_mod.validate_initial_states(
            initial_states, spec, n_runs)

    carry = kmod.init_carry_batch(seeds, spec, initial_states=initial_states,
                                  device=dev)
    C = int(carry.energy.shape[0])
    reps = -(-C // n_levels)
    betas = torch.from_numpy(np.tile(ladder, reps)[:C]).to(dev)

    history = [carry.energy.reshape(1, -1).cpu().numpy()]
    betas_hist = []
    n_rounds = -(-spec.n_outer // exchange_interval)
    start_round = 0
    if checkpointer is not None:
        fp = checkpoint.spec_fingerprint(spec, seeds)
        # record_betas changes the checkpoint payload (the beta history
        # rides in the extras), so it is part of the run identity.
        fp = checkpoint.extend_fingerprint(
            fp, ladder, np.uint32(swap_seed), np.int64(exchange_interval),
            np.bool_(record_betas))
        resumed = checkpointer.restore(carry, seg_outer=exchange_interval,
                                       fingerprint=fp,
                                       n_extras=2 if record_betas else 1)
        if resumed is not None:
            carry, start_round, chunks, extras = resumed
            betas = torch.from_numpy(
                np.asarray(extras[0], np.float32)).to(dev)
            if record_betas:
                betas_hist = list(extras[1])
            history = list(chunks)
    t0 = time.time()
    for r in range(start_round, n_rounds):
        seg0 = r * exchange_interval
        n_seg = min(exchange_interval, spec.n_outer - seg0)
        carry, ys = kmod.run_segment_tempered(carry, betas, seg0, spec,
                                              n_seg)
        history.append(ys.cpu().numpy())
        if record_betas:
            # The betas under which this round's samples were generated.
            betas_hist.append(betas.cpu().numpy())
        if r + 1 < n_rounds:
            betas = exchange(betas, carry.energy.reshape(-1),
                             round_key(swap_seed, r), n_levels, r % 2)
        if checkpointer is not None:
            extras = (betas.cpu().numpy(),)
            if record_betas:
                extras += (np.stack(betas_hist) if betas_hist
                           else np.zeros((0, C), np.float32),)
            checkpointer.save(carry, r + 1, history,
                              seg_outer=exchange_interval, fingerprint=fp,
                              extras=extras)
        if verbose and (r + 1) % max(1, n_rounds // 10) == 0:
            e = carry.energy.reshape(-1)[:n_runs].cpu().numpy()
            be = carry.best_energy.reshape(-1)[:n_runs].cpu().numpy()
            print(f"[tempering] round {r + 1}/{n_rounds}: "
                  f"mean E={e.mean():.2f} best={be.min()}")
        if stop_at_energy is not None:
            be = carry.best_energy.reshape(-1)[:n_runs].cpu().numpy()
            if be.min() <= stop_at_energy:
                if verbose:
                    print(f"[tempering] early stop at round {r + 1}/"
                          f"{n_rounds}: best={be.min()}")
                break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    host = {name: getattr(carry, name).cpu().numpy()
            for name in runner_mod.state_fields(spec)}
    best_state, final_state = runner_mod.states_of(host, spec)
    s = slice(0, n_runs)
    out = {
        "best_energy": host["best_energy"].reshape(-1)[s],
        "best_state": best_state[s],
        "final_energy": host["energy"].reshape(-1)[s],
        "final_state": final_state[s],
        "energy_history": np.concatenate(history, axis=0).T[s],
        "betas": betas.cpu().numpy()[s],
        "ladder": ladder,
        "wall_time": wall,
        "proposals": int(host["total_bins"].sum()),
    }
    if record_betas:
        out["betas_history"] = np.stack(betas_hist, axis=0)[:, :n_runs]
    return out
