"""Regenerate the minimum-energy floors on the card with the tempered floors
protocol (PyTorch port of ``python -m tools.full3d_floors_campaign``).

Per size: a 16-level tempering ladder, 65536 chains x 8M steps, exchanges
every 62500 steps; a fresh search (beta 0.8 -> 7, seed 31337), an
independent fresh-seed confirmation (4242), then colder (beta 2 -> 10)
warm-started refinements from the best board so far until the floor stops
moving (at most ``--max-refines``).  Each search is one run of the port's
competition CLI; every exported board is re-scored by :mod:`.verify_board`'s
oracle before it is trusted, and the campaign log is flushed to
``artifacts/h100/{full3d,board}_floors/campaign.json`` after every search,
so a killed run loses nothing and a rerun skips what is banked.

``--mcmc-type board`` runs the protocol on the board-constrained chain;
``--refine-from BOARD.txt`` skips the fresh and confirm searches and runs
only the refinements from an existing board (which may lie anywhere).

    python -m mcqueens_torch.tools.full3d_floors_campaign [--sizes 12 14 15]
    python -m mcqueens_torch.tools.full3d_floors_campaign --mcmc-type board \\
        --sizes 14 --refine-from artifacts/competition_results/best_heights_14_*.txt
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
import time

from mcqueens_torch import tools

CHAINS = 65536
N_STEPS = 8_000_000
STRIDE = 62_500
LADDER = 16


def _outdir(mcmc_type: str) -> str:
    return str(tools.H100_ARTIFACTS / (
        "full3d_floors" if mcmc_type == "full_3d" else "board_floors"))


def _bank(export, outdir) -> str:
    """Move a search's export into ``<outdir>/competition_results/`` under a
    name no earlier export has (the CLI names files by the minute, and short
    searches can finish within one)."""
    stem = os.path.basename(export)[:-len(".txt")]
    path = os.path.join(outdir, "competition_results", f"{stem}.txt")
    i = 1
    while os.path.exists(path):
        path = os.path.join(outdir, "competition_results", f"{stem}_{i}.txt")
        i += 1
    os.replace(export, path)
    return path


def _search(n, seed, beta_start, beta_end, mcmc_type, outdir, resume_from=None,
            n_steps=N_STEPS, ladder=LADDER, device="cuda"):
    """One tempered search via the competition CLI; returns (energy, path,
    wall s)."""
    from mcqueens_torch.cli import competition
    from mcqueens_torch.tools.verify_board import verify

    argv = [
        "--n", str(n), "--mcmc-type", mcmc_type,
        "--n-runs", str(CHAINS), "--n-steps", str(n_steps),
        "--kernel", "pallas_shared", "--tempering", str(ladder),
        "--history-stride", str(STRIDE),
        "--beta-start", str(beta_start), "--beta-end", str(beta_end),
        "--seed", str(seed), "--device", device,
    ]
    if resume_from:
        argv += ["--resume-from", resume_from]
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=outdir) as stage:
        competition.main(argv + ["--outdir", stage])
        exports = glob.glob(os.path.join(stage, "competition_results",
                                         "*.txt"))
        if len(exports) != 1:
            raise AssertionError(f"search exported {len(exports)} boards")
        path = _bank(exports[0], outdir)
    rec = verify(path)
    if not rec["distinct_cells"]:
        raise AssertionError(f"{path}: two queens share a cell")
    return rec["oracle_energy"], path, round(time.time() - t0, 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sizes", type=int, nargs="+", default=[12, 14, 15])
    ap.add_argument("--max-refines", type=int, default=3)
    ap.add_argument("--mcmc-type", choices=["full_3d", "board"],
                    default="full_3d")
    ap.add_argument("--refine-from", default=None, metavar="BOARD_TXT",
                    help="skip fresh/confirm; run only colder warm-started "
                         "refinements from this board (one size)")
    ap.add_argument("--n-steps", type=int, default=N_STEPS,
                    help="steps per search (default the floor protocol's "
                         "8M)")
    ap.add_argument("--ladder", type=int, default=LADDER,
                    help="tempering ladder levels (default 16)")
    ap.add_argument("--kind-prefix", default="refine",
                    help="label prefix for refinement records, so protocol "
                         "variants (e.g. 'long' = 4x-budget schedules) bank "
                         "separately and never skip each other's runs")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the CUDA kernels) or cpu "
                         "(their plain-torch twins)")
    args = ap.parse_args(argv)
    if args.refine_from and len(args.sizes) != 1:
        ap.error("--refine-from requires exactly one --sizes value")

    from mcqueens_torch.tools.verify_board import verify

    outdir = str(tools.output_path(_outdir(args.mcmc_type)))
    os.makedirs(os.path.join(outdir, "competition_results"), exist_ok=True)
    log_path = tools.output_path(os.path.join(outdir, "campaign.json"))
    log = {}
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = json.load(f)

    def flush():
        with open(log_path, "w") as f:
            json.dump(log, f, indent=1)

    for n in args.sizes:
        key = f"N{n}"
        rec = log.setdefault(key, {"searches": []})
        done = {s["kind"] for s in rec["searches"]}

        def run(kind, seed, b0, b1, resume=None):
            if kind in done:
                return
            e, path, wall = _search(n, seed, b0, b1, args.mcmc_type, outdir,
                                    resume, n_steps=args.n_steps,
                                    ladder=args.ladder, device=args.device)
            entry = {
                "kind": kind, "seed": seed, "beta": [b0, b1],
                "energy": e, "board": os.path.basename(path),
                "wall_s": wall,
                "warm_from": os.path.basename(resume) if resume else None,
            }
            if args.n_steps != N_STEPS:
                entry["n_steps"] = args.n_steps
            if args.ladder != LADDER:
                entry["ladder"] = args.ladder
            rec["searches"].append(entry)
            print(json.dumps(rec["searches"][-1]), flush=True)
            flush()

        if args.refine_from:
            # Anchor the record on the existing board (re-scored by the
            # oracle, never trusted from its filename) so refinements
            # warm-start from it and "the floor stopped moving" is judged
            # against its energy.
            if "prior" not in done:
                prior = verify(args.refine_from)
                if not prior["distinct_cells"]:
                    raise AssertionError(f"{args.refine_from}: two queens "
                                         "share a cell")
                rec["searches"].append({
                    "kind": "prior", "seed": None, "beta": None,
                    "energy": prior["oracle_energy"],
                    "board": os.path.abspath(args.refine_from),
                    "wall_s": 0.0, "warm_from": None,
                })
                flush()
        else:
            run("fresh", 31337, 0.8, 7.0)
            run("confirm", 4242, 0.8, 7.0)

        def best():
            s = min(rec["searches"], key=lambda s: s["energy"])
            path = s["board"]
            if not os.path.isabs(path):
                path = os.path.join(outdir, "competition_results", path)
            return s["energy"], path

        for i in range(args.max_refines):
            e_before, board = best()
            run(f"{args.kind_prefix}{i}", 777 + i, 2.0, 10.0, resume=board)
            e_after, _ = best()
            if e_after >= e_before:
                break  # the floor stopped moving
        rec["floor"] = best()[0]
        rec["floor_board"] = os.path.basename(best()[1])
        flush()
        print(f"N={n} {args.mcmc_type} floor: {rec['floor']} "
              f"({rec['floor_board']})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
