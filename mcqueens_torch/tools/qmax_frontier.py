"""Campaign: bracket Q_max(N, 3) past the literature table on the card
(PyTorch port of ``python -m tools.qmax_frontier``).

Two queens in the same (i, j) column always attack, so Q_max(N, 3) <= N^2;
Klarner's construction attains it whenever gcd(N, 210) = 1, closing those
sizes (refused here).  For every other N > 10 this anneals the sub-N^2 path
at adaptively descending Q until a zero-attack placement appears, then walks
the bound up to the feasibility edge: gallop (+1, +2, +4, ...) to the first
cold miss, then bisect the last gap.  Each certified Q is a constructive
lower bound (oracle re-scored, exported); each miss under the escalated
budget is evidence, not proof, that Q_max lies below it.  Plain annealing
under-searches the edge: :mod:`.qmax_push` (``--warm-start``) is the
authoritative prober.

``--budget-s`` bounds the campaign by wall clock: no new probe starts after
it is spent, the frontier JSON (``artifacts/h100/qmax/qmax_frontier_N{N}.json``)
is flushed after every probe, and a budget-stopped walk records
``"probes_complete": false``; a rerun replays every banked probe for free and
goes on where the last run stopped.  ``probes_complete`` says only that the
cold walk finished: edge closure is the separate ``"edge"`` record that
:mod:`.qmax_campaign` writes.

    python -m mcqueens_torch.tools.qmax_frontier [--n 12] [--start Q0]
        [--budget-s 1800] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import time

import numpy as np

from mcqueens_torch import tools
from mcqueens_torch.tools.qmax import OUTDIR, search, write_certificate
from mcqueens_torch.tools.verify_board import energy as oracle_energy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--start", type=int, default=None,
                    help="first probe Q (default N^2 - 2)")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="wall-clock budget; no new probe starts past it")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the CUDA kernels) or cpu "
                         "(their plain-torch twins)")
    args = ap.parse_args(argv)
    N = args.n
    if math.gcd(N, 210) == 1:
        raise SystemExit(f"N={N} is closed by Klarner: Q_max = N^2 = {N*N}")

    os.makedirs(tools.output_path(OUTDIR), exist_ok=True)
    t_start = time.time()
    json_path = tools.output_path(
        os.path.join(OUTDIR, f"qmax_frontier_N{N}.json"))
    out, prior_bound = {}, None
    if os.path.exists(json_path):
        # Resume: a rerun never loses banked evidence.  Every record (probe
        # and push entries) survives the next flush, and probe() replays
        # banked results for free, so the control flow fast-forwards to
        # wherever the last run died.
        with open(json_path) as f:
            out = json.load(f)
        prior_bound = out.pop("lower_bound", None)
        out.pop("probes_complete", None)
        out.pop("complete", None)  # legacy conflated flag: never rewrite it

    def flush(best_zero, probes_complete):
        bound = best_zero
        if prior_bound is not None and (bound is None or prior_bound > bound):
            bound = prior_bound  # warm pushes may have raised it already
        out["lower_bound"] = bound
        out["probes_complete"] = probes_complete
        with open(json_path, "w") as f:
            json.dump(out, f, indent=1)
        return bound

    def budget_left():
        return (args.budget_s is None
                or time.time() - t_start < args.budget_s)

    def probe(Q):
        if f"Q{Q}" in out:  # banked by an earlier (killed) run: free replay
            return out[f"Q{Q}"]["min_energy"]
        e, best, wall, props = search(N, Q, 1 << 20, 6.0, device=args.device)
        if e > 0:  # escalate: 8x steps, colder end
            e2, b2, w2, p2 = search(N, Q, 1 << 23, 8.0, seed=9999,
                                    device=args.device)
            wall, props = wall + w2, props + p2
            if e2 < e:
                e, best = e2, b2
        rec = {"min_energy": e, "proposals": props, "wall_s": round(wall, 1)}
        out[f"Q{Q}"] = rec
        if e == 0:
            if oracle_energy(np.asarray(best, np.int64)) != 0:
                raise AssertionError(f"N={N} Q={Q}: certificate attacks")
            path = os.path.join(OUTDIR, f"qmax_N{N}_Q{Q}.txt")
            write_certificate(path, best)
            rec["board"] = os.path.basename(path)
        print(json.dumps({f"Q{Q}": rec}), flush=True)
        return e

    # Adaptive descent: min energy grows ~2 per excess queen (N=12), so a
    # miss at energy e suggests the edge is ~e/2 below.
    best_zero, smallest_miss = None, N * N
    complete = True
    Q = args.start if args.start is not None else N * N - 2
    while Q >= 1:
        if not budget_left():
            complete = False
            break
        e = probe(Q)
        if e == 0:
            best_zero = Q
        # Bank the new certificate before anything else can kill the
        # process.
        flush(best_zero, False)
        if e == 0:
            break
        smallest_miss = Q
        Q -= max(2, e // 2)
    if best_zero is not None:  # tighten: walk up to the edge
        # A zero-attack placement at Q yields one at every Q' < Q (delete
        # queens), so the walk is a monotone search: gallop to the first
        # cold miss, then bisect the last gap.
        lo, hi = best_zero, smallest_miss
        step = 1
        while lo + step < hi:  # gallop
            if not budget_left():
                complete = False
                break
            if probe(lo + step) == 0:
                lo = best_zero = lo + step
                flush(best_zero, False)
                step *= 2
            else:
                hi = lo + step
                break
        while complete and lo + 1 < hi:  # bisect the remaining gap
            if not budget_left():
                complete = False
                break
            mid = (lo + hi) // 2
            if probe(mid) == 0:
                lo = best_zero = mid
                flush(best_zero, False)
            else:
                hi = mid
    bound = flush(best_zero, complete)
    misses = sorted(int(k[1:]) for k, v in out.items()
                    if re.fullmatch(r"Q\d+", k) and v["min_energy"] > 0)
    tag = "" if complete else " [budget stop]"
    print(f"FINAL Q_max({N},3) >= {bound}; misses at {misses}{tag}")


if __name__ == "__main__":
    main()
