"""Competition CLI: anneal hard, export the best placement (PyTorch port).

Same flags, defaults, guards and export format as
``python -m mcqueens.cli.competition``, plus ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain-torch twins).  ``--kernel`` takes the JAX
CLI's four samplers and its default ``tables``: ``tables`` and ``naive`` (the
scan samplers, independent chains with full history for <= 64 runs),
``pallas`` (independent chains) and ``pallas_shared`` (shared sites, the
throughput tier).  ``--mcmc-type board|full_3d``, ``--q`` and ``--tempering``
(``pallas_shared`` only) with ``--exchange-interval`` run as in the JAX CLI.
``--checkpoint-dir DIR`` saves the search's state there (at most every 30
s) and a rerun with the same flags resumes it.  ``--mesh`` shards the runs
over every device of ``--device``'s type
(:func:`mcqueens_torch.dist.mesh.mesh_for`): all visible cards on CUDA; on
the CPU, which torch sees as one device, a mesh of one shard, so the run
equals the one without ``--mesh``.

    python -m mcqueens_torch.cli.competition [--n 15] [--n-runs 10]
        [--n-steps 100000] [--beta-start 1.0] [--beta-end 3.0] [--seed 42]
        [--kernel tables|naive|pallas|pallas_shared]
        [--mcmc-type board|full_3d] [--q Q] [--tempering L] [--device cuda]
        [--checkpoint-dir DIR] [--mesh] [--outdir .]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n", type=int, default=15)
    parser.add_argument("--n-runs", type=int, default=10)
    parser.add_argument("--n-steps", type=int, default=100000)
    parser.add_argument("--init-mode", default="random")
    parser.add_argument("--mcmc-type", default="board",
                        choices=("board", "full_3d"),
                        help="board, or full_3d (a full_3d export lists "
                             "the Q queens)")
    parser.add_argument("--q", type=int, default=None, metavar="Q",
                        help="full_3d only: queen count (default N^2)")
    parser.add_argument("--beta-start", type=float, default=1.0)
    parser.add_argument("--beta-end", type=float, default=3.0)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--early-stop-patience", type=int, default=None)
    parser.add_argument("--kernel", default="tables",
                        choices=("tables", "naive", "pallas",
                                 "pallas_shared"),
                        help="tables/naive: the scan samplers; pallas: "
                             "independent chains; pallas_shared: the "
                             "shared-site throughput samplers (hand-written "
                             "CUDA kernels on --device cuda)")
    parser.add_argument("--history-stride", type=int, default=None,
                        help="default: full history for <=64 runs of "
                             "tables/naive, else n_steps // 1024")
    parser.add_argument("--n-bins", type=int, default=None,
                        help="acceptance-rate bins (default 100, shrunk so "
                             "n_steps * n_bins fits int32)")
    parser.add_argument("--tempering", type=int, default=0, metavar="L",
                        help="parallel tempering with an L-level geometric "
                             "beta ladder spanning [beta-start, beta-end] "
                             "(constant in time).  Requires --kernel "
                             "pallas_shared.  Chain c sits at ladder level "
                             "c %% L.")
    parser.add_argument("--mesh", action="store_true",
                        help="shard the runs over all devices of --device's "
                             "type (one shard on the CPU)")
    parser.add_argument("--outdir", default=".")
    parser.add_argument("--checkpoint-dir", default=None, metavar="DIR")
    parser.add_argument("--exchange-interval", type=int, default=1,
                        metavar="SEGS",
                        help="tempering: replica-exchange sweeps every this "
                             "many history-stride segments")
    parser.add_argument("--resume-from", default=None, metavar="BOARD_TXT",
                        help="warm-start every run from a previously exported "
                             "best_heights file (i,j,k lines)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (the CUDA kernels) or cpu "
                             "(their plain-torch twins)")
    args = parser.parse_args(argv)

    if args.q is not None:
        if args.mcmc_type != "full_3d":
            parser.error("--q only applies to --mcmc-type full_3d "
                         "(board mode is always N^2 queens)")
        if not 1 <= args.q < args.n ** 3:
            parser.error(f"--q must be in [1, N^3) (N^3={args.n ** 3}; "
                         "a free cell must exist for the move proposal)")

    from mcqueens_torch.chain.spec import ChainSpec
    from mcqueens_torch.core.schedules import build_schedule
    from mcqueens_torch.dist import mesh as mesh_mod
    from mcqueens_torch.dist import runner
    from mcqueens_torch.utils import profiling

    mesh = mesh_mod.mesh_for(args.device) if args.mesh else None

    stride = args.history_stride
    if stride is None:
        if args.kernel in ("pallas", "pallas_shared"):
            # one kernel launch per history point: keep chunks big
            stride = max(1, args.n_steps // 1024)
        else:
            stride = (1 if args.n_runs <= 64
                      else max(1, args.n_steps // 1024))
    n_bins = args.n_bins
    if n_bins is None:
        n_bins = max(1, min(100, (2 ** 31 - 1) // max(args.n_steps, 1)))

    checkpointer = None
    if args.checkpoint_dir:
        from mcqueens_torch.utils.checkpoint import Checkpointer

        # The tag carries every run-shaping flag so two different searches
        # sharing a --checkpoint-dir never clobber (or silently ignore)
        # each other's file; the spec fingerprint inside the checkpoint
        # still guards against anything the tag misses.
        tag = (f"competition_{args.mcmc_type}_N{args.n}"
               + (f"_Q{args.q}" if args.q is not None else "")
               + f"_r{args.n_runs}"
               f"_st{args.n_steps}_b{args.beta_start:g}-{args.beta_end:g}"
               f"_s{args.seed}_{args.kernel}"
               + (f"_T{args.tempering}" if args.tempering else ""))
        # History chunks are written once each, so a save costs the carry;
        # a 30 s floor between writes keeps large searches from spending
        # their time serializing state and bounds a kill's loss to ~30 s.
        checkpointer = Checkpointer(args.checkpoint_dir, tag=tag,
                                    min_interval_s=30.0)

    initial_states = None
    if args.resume_from:
        with open(args.resume_from) as f:
            rows = [[int(x) for x in line.strip().split(",")] for line in f]
        if args.mcmc_type == "board":
            state = np.zeros((args.n, args.n), np.int32)
            for i, j, k in rows:
                state[i, j] = k
        else:
            state = np.asarray(rows, np.int32)  # (Q, 3) queens
        initial_states = np.repeat(state[None], args.n_runs, axis=0)

    if args.tempering:
        from mcqueens_torch.search import tempering

        if args.kernel != "pallas_shared":
            parser.error("--tempering requires --kernel pallas_shared")

        spec = ChainSpec(
            N=args.n, n_steps=args.n_steps,
            schedule=build_schedule("constant", args.n_steps,
                                    beta_const=1.0),
            init_mode=args.init_mode, mcmc_type=args.mcmc_type,
            history_stride=stride, kernel=args.kernel, Q=args.q,
            n_bins=n_bins,
        )
        ladder = tempering.geometric_ladder(
            args.beta_start, args.beta_end, args.tempering)
        out = tempering.run_tempered(
            args.seed + np.arange(args.n_runs, dtype=np.uint32), spec,
            ladder, device=args.device, swap_seed=args.seed,
            initial_states=initial_states, verbose=True,
            exchange_interval=args.exchange_interval, mesh=mesh,
            checkpointer=checkpointer,
        )
        order = np.argsort(out["best_energy"], kind="stable")
        shown = [int(out["best_energy"][r]) for r in order[:20]]
        print(f"Best energies: {shown}{' ...' if args.n_runs > 20 else ''}")
        if args.n_runs > 20:
            print(f"(over {args.n_runs} runs: min "
                  f"{int(out['best_energy'].min())}, "
                  f"mean {out['best_energy'].mean():.1f})")
        best = out["best_state"][order[0]]
        print(best)
        print(f"{out['proposals']:.3e} proposals in {out['wall_time']:.1f}s "
              f"= {out['proposals'] / max(out['wall_time'], 1e-9):.3e} "
              f"moves/s")
        _export(args, best)
        return 0

    schedule = build_schedule(
        "linear_annealing", args.n_steps,
        beta_start=args.beta_start, beta_end=args.beta_end,
    )
    if initial_states is not None:
        spec = ChainSpec(
            N=args.n, n_steps=args.n_steps, schedule=schedule,
            init_mode=args.init_mode, mcmc_type=args.mcmc_type,
            early_stop_patience=args.early_stop_patience,
            history_stride=stride, kernel=args.kernel, Q=args.q,
            n_bins=n_bins,
        )
        res = runner.run_chains(
            args.seed + np.arange(args.n_runs, dtype=np.uint32), spec,
            device=args.device, mesh=mesh, verbose=True,
            initial_states=initial_states, checkpointer=checkpointer,
        )
    else:
        res = runner.run_experiment(
            N=args.n, n_steps=args.n_steps, init_mode=args.init_mode,
            schedule=schedule, n_runs=args.n_runs, base_seed=args.seed,
            device=args.device, mcmc_type=args.mcmc_type,
            early_stop_patience=args.early_stop_patience,
            verbose=True, history_stride=stride, kernel=args.kernel,
            n_bins=n_bins, checkpointer=checkpointer, Q=args.q, mesh=mesh,
        )

    order = np.argsort(res.best_energy, kind="stable")
    shown = [int(res.best_energy[r]) for r in order[:20]]
    suffix = " ..." if args.n_runs > 20 else ""
    print(f"Best energies: {shown}{suffix}")
    if args.n_runs > 20:
        print(f"(over {args.n_runs} runs: min {int(res.best_energy.min())}, "
              f"mean {res.best_energy.mean():.1f})")
    best = res.best_state[order[0]]
    print(best)
    print(profiling.throughput_of(res))

    _export(args, best)
    return 0


def _export(args, best) -> None:
    """Write the winning state as ``i,j,k`` lines to
    ``<outdir>/competition_results/best_heights_{N}_{timestamp}.txt``: a
    board's N^2 columns, or a full_3d state's Q queens."""
    out_dir = os.path.join(args.outdir, "competition_results")
    os.makedirs(out_dir, exist_ok=True)
    ts = time.strftime("%Y%m%d_%H%M")
    path = os.path.join(out_dir, f"best_heights_{args.n}_{ts}.txt")
    with open(path, "w") as f:
        if args.mcmc_type == "full_3d":
            for i, j, k in best:
                f.write(f"{i},{j},{k}\n")
        else:
            for i in range(args.n):
                for j in range(args.n):
                    f.write(f"{i},{j},{best[i, j]}\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    raise SystemExit(main())
