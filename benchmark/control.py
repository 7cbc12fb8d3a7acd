"""Readings of a cell's check on the card, for setting its limits.

    python -m benchmark.control --workload <cell> --seeds <n> [<n> ...]
        [--control-seeds <k>]

For each seed: one search of the cell at its own size through the program,
as search 0 of a run with that seed, and the numbers the check compares
(:mod:`benchmark.check`) for it: the lower readings.  For the first
``--control-seeds`` seeds, also the control: the reference put in the
program's place with its accept test in bfloat16 instead of float32, judged
by the float32 reference on the same chains (the ``replay`` number): the
upper reading.  One JSON line a seed; the benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from benchmark import check, searches
    from benchmark import run as run_mod

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    _, cell = run_mod.load_cell(Path.cwd(), args.workload)
    spec = cell.spec()
    searcher = searches.Searcher(cell, "cuda")
    k = cell.workload.get("check_chains", 4)
    for n, seed in enumerate(args.seeds):
        base = searches.base_seed(seed, 0, spec.chains)
        t0 = time.perf_counter()
        result = searcher(base)
        t_search = time.perf_counter() - t0
        checks, notes = check.run_checks(spec, base, result, seed, k,
                                         "cuda")
        line = {"workload": cell.name, "seed": seed, "search_s": t_search,
                "checks": {name: c["value"] for name, c in checks.items()},
                "chains": notes["chains"]}
        if n < args.control_seeds:
            # The bfloat16 reference in the program's place, on the chains
            # the check walked: the float32 walks of those chains equal
            # the program's (the check's replay reads 0), so a bfloat16
            # walk that differs from the program's differs from them.
            t0 = time.perf_counter()
            chains = notes["chains"]
            line["control_replay"] = len(check.replay(
                spec, base, result, chains, precision="bfloat16"))
            line["control_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
