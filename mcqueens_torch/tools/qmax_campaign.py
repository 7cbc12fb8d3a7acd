"""One-command Q_max(N, 3) campaign on the card: descent probes, then the
warm walk (PyTorch port of ``python -m tools.qmax_campaign``).

  1. :mod:`.qmax_frontier`: adaptive descending annealing probes to a first
     zero-attack certificate, then a cold walk up to the apparent edge
     (``lower_bound`` in ``artifacts/h100/qmax/qmax_frontier_N{N}.json``).
  2. :mod:`.qmax_push` ``--warm-start``: tempered pushes from the Q-1
     certificate plus one random queen, walking the bound up until a
     full-budget miss.
  3. Optionally (``--confirm-seed``) the final warm miss is attacked again
     with an independent seed: it either breaks (the walk resumes) or
     becomes two-seed evidence.

Sizes with gcd(N, 210) = 1 are closed at N^2 by Klarner's construction and
refused.  Certificates and evidence are flushed after every probe and push,
so a killed campaign loses nothing banked; pushes checkpoint into
``--checkpoint-dir`` (default ``artifacts/h100/qmax/.ckpt``; ``''`` turns
it off).

    python -m mcqueens_torch.tools.qmax_campaign --n 20 [--confirm-seed 4242]
        [--skip-probes] [--budget-s S] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re

from mcqueens_torch import tools
from mcqueens_torch.tools import qmax_frontier, qmax_push
from mcqueens_torch.tools.qmax import OUTDIR

# One warm push's proposal budget (65536 chains x 8M steps); only misses at
# the FULL budget count as edge evidence: an early-stopped or truncated push
# proves nothing about infeasibility.
FULL_BUDGET = qmax_push.CHAINS * qmax_push.N_STEPS


def _frontier_path(N: int) -> str:
    return str(tools.output_path(
        os.path.join(OUTDIR, f"qmax_frontier_N{N}.json")))


def _load(N: int) -> dict:
    with open(_frontier_path(N)) as f:
        return json.load(f)


def derive_edge(out: dict, bound: int) -> dict | None:
    """Edge record for ``bound + 1`` from the banked full-budget warm misses.

    Scans the frontier JSON for ``tempered_push_warm`` records at
    Q = bound + 1 with ``min_energy > 0`` and the full proposal budget, and
    summarizes them as ``{"q", "seeds", "budget_proposals"}``.  Returns
    ``None`` when no qualifying miss exists: the size is then NOT
    edge-closed and no ``edge`` key may be written.
    """
    q = bound + 1
    pat = re.compile(rf"Q{q}_push_warm(_s\d+)?$")
    seeds, budgets = [], []
    for key, rec in out.items():
        if not (isinstance(rec, dict) and pat.fullmatch(key)):
            continue
        if rec.get("protocol") != "tempered_push_warm":
            continue
        if rec.get("min_energy", 0) <= 0:
            continue
        if rec.get("proposals", 0) < FULL_BUDGET:
            continue
        seeds.append(int(rec.get("seed", 31337)))
        budgets.append(int(rec["proposals"]))
    if not seeds:
        return None
    return {"q": q, "seeds": sorted(set(seeds)),
            "budget_proposals": min(budgets)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--seed", type=int, default=31337,
                    help="seed for the warm-start walk")
    ap.add_argument("--confirm-seed", type=int, default=None,
                    help="re-attack the final warm miss with this second "
                         "seed; if it breaks, resume the walk from there")
    ap.add_argument("--skip-probes", action="store_true",
                    help="reuse an existing frontier JSON's lower_bound "
                         "instead of re-running the descent probes")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="wall-clock budget for the probe phase "
                         "(forwarded to qmax_frontier)")
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(OUTDIR, ".ckpt"),
                    help="mid-push tempering checkpoints (default on); "
                         "pass '' to disable")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the CUDA kernels) or cpu "
                         "(their plain-torch twins)")
    args = ap.parse_args(argv)
    N = args.n
    if math.gcd(N, 210) == 1:
        raise SystemExit(f"N={N} is closed by Klarner: Q_max = N^2 = {N*N}")
    device_argv = ([] if args.device == "cuda"
                   else ["--device", args.device])

    if not args.skip_probes:
        frontier_argv = ["--n", str(N)]
        if args.budget_s is not None:
            frontier_argv += ["--budget-s", str(args.budget_s)]
        qmax_frontier.main(frontier_argv + device_argv)
    bound = _load(N)["lower_bound"]
    if bound is None:
        raise SystemExit(f"descent probes found no certificate for N={N}")

    ckpt_argv = (["--checkpoint-dir", args.checkpoint_dir]
                 if args.checkpoint_dir else [])

    def walk(seed):
        qmax_push.main(["--n", str(N), "--start", str(bound + 1),
                        "--seed", str(seed), "--warm-start"]
                       + ckpt_argv + device_argv)
        return _load(N)["lower_bound"]

    # Warm walk from one past the certified bound until a full-budget miss.
    bound = walk(args.seed)
    while args.confirm_seed is not None:
        new_bound = walk(args.confirm_seed)
        if new_bound == bound:
            break  # the miss held under the second seed: two-seed evidence
        # The second seed broke the edge: continue the primary walk.
        bound = new_bound
        bound = walk(args.seed)

    # The campaign's end state is the frontier closure, recorded as an
    # explicit ``edge`` record derived from the banked miss evidence itself.
    out = _load(N)
    out.pop("complete", None)  # retire the legacy conflated flag
    edge = derive_edge(out, bound)
    if edge is None:
        print(f"CAMPAIGN ENDED WITHOUT EDGE EVIDENCE: Q_max({N},3) >= "
              f"{bound}, but no full-budget warm miss at Q={bound + 1} is "
              f"banked; the size stays OPEN in {_frontier_path(N)}")
        return
    out["edge"] = edge
    with open(_frontier_path(N), "w") as f:
        json.dump(out, f, indent=1)

    print(f"CAMPAIGN DONE: Q_max({N},3) >= {bound}, edge at "
          f"Q={edge['q']} under seeds {edge['seeds']} "
          f"(evidence in {_frontier_path(N)})")


if __name__ == "__main__":
    main()
