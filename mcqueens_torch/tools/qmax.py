"""Campaign: certify the literature Q_max(N, 3) values on the card (PyTorch
port of ``python -m tools.qmax``).

The reference report's Table 1 lists the best known maximum number of
mutually non-attacking queens in the N-cube for N = 3..10: 4, 7, 13, 21,
32, 48, 67, 91.  The sub-N^2 full-3D search re-derives them:

  * at Q = Q_max the annealer must FIND a zero-energy placement (a
    constructive certificate, re-scored by :mod:`.verify_board`'s oracle and
    exported to ``artifacts/h100/qmax/``);
  * at Q = Q_max + 1 the same budget should plateau above zero (evidence,
    not a proof of impossibility).

A Q_max instance that misses zero is searched once more with 16x the steps
and a colder end.  Evidence: ``artifacts/h100/qmax/qmax_certification.json``.

    python -m mcqueens_torch.tools.qmax [--device cuda]
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
from mcqueens_torch.dist import runner
from mcqueens_torch.tools.verify_board import energy as oracle_energy

# report Table 1: best known Q_max(N, 3), N = 3..10
QMAX = {3: 4, 4: 7, 5: 13, 6: 21, 7: 32, 8: 48, 9: 67, 10: 91}

CHAINS = 4096
OUTDIR = str(tools.H100_ARTIFACTS / "qmax")


def search(N, Q, n_steps, beta_end, seed=0, *, device="cuda"):
    """One annealed search of CHAINS chains on the shared-site full-3D
    kernel; returns (best energy, its (Q, 3) placement, wall s, proposals).
    The best placement's energy is re-scored by the oracle."""
    spec = ChainSpec(
        N=N, n_steps=n_steps,
        schedule=build_schedule("linear_annealing", n_steps,
                                beta_start=0.5, beta_end=beta_end),
        init_mode="random", mcmc_type="full_3d", kernel="pallas_shared",
        history_stride=max(1, n_steps // 64), Q=Q,
    )
    seeds = np.arange(seed, seed + CHAINS, dtype=np.uint32)
    t0 = time.time()
    res = runner.run_chains(seeds, spec, device=device)
    wall = time.time() - t0
    r = int(np.argmin(res.best_energy))
    best = np.asarray(res.best_state[r], np.int64)
    e = int(res.best_energy[r])
    if e != oracle_energy(best):
        raise AssertionError(f"N={N} Q={Q}: reported energy {e} differs "
                             f"from the oracle's {oracle_energy(best)}")
    return e, best, wall, CHAINS * n_steps


def write_certificate(path, best) -> None:
    """A placement as ``i,j,k`` lines (refused under the TPU's artifacts)."""
    with open(tools.output_path(path), "w") as f:
        for i, j, k in np.asarray(best).tolist():
            f.write(f"{i},{j},{k}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the CUDA kernels) or cpu "
                         "(their plain-torch twins)")
    args = ap.parse_args(argv)
    os.makedirs(tools.output_path(OUTDIR), exist_ok=True)
    out = {}
    for N, qmax in QMAX.items():
        for Q in (qmax, qmax + 1):
            n_steps, beta_end = 1 << 18, 5.0
            e, best, wall, props = search(N, Q, n_steps, beta_end,
                                          device=args.device)
            if Q == qmax and e > 0:  # escalate once: 16x steps, colder end
                n_steps, beta_end = 1 << 22, 7.0
                e2, best2, wall2, props2 = search(N, Q, n_steps, beta_end,
                                                  seed=CHAINS,
                                                  device=args.device)
                wall, props = wall + wall2, props + props2
                if e2 < e:
                    e, best = e2, best2
            rec = {"min_energy": e, "proposals": props,
                   "wall_s": round(wall, 1),
                   "certified": bool(Q == qmax and e == 0)}
            out[f"N{N}_Q{Q}"] = rec
            if Q == qmax and e == 0:
                path = os.path.join(OUTDIR, f"qmax_N{N}_Q{Q}.txt")
                write_certificate(path, best)
                rec["board"] = os.path.basename(path)
            print(json.dumps({f"N{N}_Q{Q}": rec}), flush=True)
    cert = tools.output_path(os.path.join(OUTDIR, "qmax_certification.json"))
    with open(cert, "w") as f:
        json.dump({**out, **tools.card(tools.device(args.device))}, f,
                  indent=1)
    n_cert = sum(r.get("certified", False) for r in out.values()
                 if isinstance(r, dict))
    print(f"FINAL certified {n_cert}/{len(QMAX)} Q_max values; "
          f"artifact {tools.shown(cert)}")


if __name__ == "__main__":
    main()
