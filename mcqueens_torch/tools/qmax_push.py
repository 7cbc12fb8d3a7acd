"""Campaign: walk a Q_max(N, 3) lower bound up with tempered pushes on the
card (PyTorch port of ``python -m tools.qmax_push``).

The annealing probes of :mod:`.qmax_frontier` under-search near the
feasibility edge, so the edge is walked under the tempered floors protocol
itself: 65536 chains x 8M steps, a 16-level geometric beta ladder 0.8 -> 9,
an exchange every 62500 steps, stopping at the first zero-attack
placement.  Q is pushed up from ``--start`` until a push misses; each
certificate is re-scored by :mod:`.verify_board`'s oracle and archived, and
every outcome is recorded in ``artifacts/h100/qmax/qmax_frontier_N{N}.json``.

``--warm-start`` starts every chain from the archived Q-1 certificate
(``artifacts/h100/qmax/qmax_N{N}_Q{Q-1}.txt``) plus one extra queen on a
per-chain random empty cell, recorded as protocol ``tempered_push_warm``.
``--checkpoint-dir`` saves the tempering state there (at most every 5
minutes) so a killed push resumes mid-search; the checkpoint is removed when
the push completes.

    python -m mcqueens_torch.tools.qmax_push --n 24 --start 403 --warm-start
        [--checkpoint-dir DIR] [--seed 31337] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from mcqueens_torch import tools
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core.schedules import build_schedule
from mcqueens_torch.search import tempering as tempering_mod
from mcqueens_torch.tools.qmax import OUTDIR, write_certificate
from mcqueens_torch.tools.verify_board import energy as oracle_energy
from mcqueens_torch.tools.verify_board import read_queens
from mcqueens_torch.utils.checkpoint import Checkpointer

CHAINS = 65536
N_STEPS = 8_000_000
STRIDE = 62_500
LADDER_L = 16
BETAS = (0.8, 9.0)


def load_certificate(N, Q):
    """Archived zero-attack placement ``qmax_N{N}_Q{Q}.txt`` -> (Q, 3)."""
    path = os.path.join(OUTDIR, f"qmax_N{N}_Q{Q}.txt")
    arr = np.asarray(read_queens(path), np.int32)
    if arr.shape != (Q, 3) or oracle_energy(arr) != 0:
        raise ValueError(f"{path}: not a zero-attack placement of {Q} "
                         "queens")
    return arr


def warm_states(N, Q, chains, seed):
    """(chains, Q, 3) starts: the Q-1 certificate + one random empty cell."""
    base = load_certificate(N, Q - 1)
    occ = set(map(tuple, base.tolist()))
    empty = np.asarray(
        [c for c in np.ndindex(N, N, N) if c not in occ], np.int32)
    rng = np.random.default_rng(seed)
    extra = empty[rng.integers(0, len(empty), size=chains)]
    states = np.repeat(base[None], chains, axis=0)
    return np.concatenate([states, extra[:, None, :]], axis=1)


def push(N, Q, seed=31337, warm=False, checkpoint_dir=None, *,
         device="cuda"):
    """One tempered push at (N, Q); returns (best energy, its placement,
    wall s, proposals)."""
    spec = ChainSpec(
        N=N, n_steps=N_STEPS,
        schedule=build_schedule("constant", N_STEPS, beta_const=1.0),
        init_mode="random", mcmc_type="full_3d", kernel="pallas_shared",
        history_stride=STRIDE, Q=Q,
    )
    ladder = tempering_mod.geometric_ladder(*BETAS, LADDER_L)
    init = warm_states(N, Q, CHAINS, seed) if warm else None
    ckpt = None
    if checkpoint_dir is not None:
        # A save copies the whole carry to the host (~0.8 GB at N=24,
        # Q=403), so the cadence is capped at 5 minutes: a kill loses at
        # most that much search.
        tag = f"push_N{N}_Q{Q}_s{seed}" + ("_warm" if warm else "")
        ckpt = Checkpointer(checkpoint_dir, tag=tag, min_interval_s=300.0)
    t0 = time.time()
    out = tempering_mod.run_tempered(
        seed + np.arange(CHAINS, dtype=np.uint32), spec, ladder,
        device=device, swap_seed=seed, verbose=True, initial_states=init,
        stop_at_energy=0, checkpointer=ckpt,
    )
    if ckpt is not None:
        ckpt.clear()  # done: a stale carry must not shadow the next campaign
    r = int(np.argmin(out["best_energy"]))
    e = int(out["best_energy"][r])
    best = np.asarray(out["best_state"][r], np.int64)
    if e != oracle_energy(best):
        raise AssertionError(f"N={N} Q={Q}: reported energy {e} differs "
                             f"from the oracle's {oracle_energy(best)}")
    return e, best, time.time() - t0, out["proposals"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--start", type=int, required=True)
    ap.add_argument("--seed", type=int, default=31337)
    ap.add_argument("--warm-start", action="store_true",
                    help="start every chain from the archived Q-1 "
                         "certificate plus one random extra queen")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="persist the tempering carry here (~5 min cadence) "
                         "so a killed push resumes mid-search")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the CUDA kernels) or cpu "
                         "(their plain-torch twins)")
    args = ap.parse_args(argv)
    N = args.n

    protocol = "tempered_push_warm" if args.warm_start else "tempered_push"
    os.makedirs(tools.output_path(OUTDIR), exist_ok=True)
    path = tools.output_path(os.path.join(OUTDIR,
                                          f"qmax_frontier_N{N}.json"))
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    Q = args.start
    while Q < N * N:
        e, best, wall, proposals = push(N, Q, args.seed, warm=args.warm_start,
                                        checkpoint_dir=args.checkpoint_dir,
                                        device=args.device)
        rec = {"min_energy": e, "proposals": proposals,
               "wall_s": round(wall, 1), "protocol": protocol,
               "seed": args.seed}
        key = f"Q{Q}_push_warm" if args.warm_start else f"Q{Q}_push"
        if key in out and (out[key].get("seed", 31337) != args.seed
                           or out[key].get("protocol") != protocol):
            key = f"{key}_s{args.seed}"  # keep multi-seed evidence
        out[key] = rec
        if e == 0:
            bpath = os.path.join(OUTDIR, f"qmax_N{N}_Q{Q}.txt")
            write_certificate(bpath, best)
            rec["board"] = os.path.basename(bpath)
            out["lower_bound"] = max(out.get("lower_bound") or 0, Q)
            # A certificate at (or past) a recorded edge refutes that edge:
            # the size reads open again until a campaign re-closes it.
            edge = out.get("edge")
            if edge is not None and Q >= edge["q"]:
                out.setdefault("edge_history", []).append(
                    dict(edge, broken_by=f"Q{Q} certificate, seed "
                                         f"{args.seed}"))
                del out["edge"]
            out.pop("complete", None)
        print(json.dumps({f"Q{Q}_push": rec}), flush=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        if e > 0:
            break
        Q += 1
    print(f"FINAL Q_max({N},3) >= {out.get('lower_bound')}")


if __name__ == "__main__":
    main()
