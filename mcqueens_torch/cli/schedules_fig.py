"""Report figure: the four annealing shapes over a normalized horizon
(PyTorch port of ``python -m mcqueens.cli.schedules_fig``).

Plots the linear, logarithmic, exponential and cosine beta schedules (1 -> 3
over 1000 steps by default) into ``<outdir>/figures/beta_schedules.png``.
The betas come from the port's :func:`build_schedule` on the CPU;
matplotlib is imported only here, as hosts without it can import the module.

    python -m mcqueens_torch.cli.schedules_fig [--outdir .]
        [--beta-start 1.0] [--beta-end 3.0] [--n-steps 1000]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--outdir", default=".")
    parser.add_argument("--beta-start", type=float, default=1.0)
    parser.add_argument("--beta-end", type=float, default=3.0)
    parser.add_argument("--n-steps", type=int, default=1000)
    args = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    from mcqueens_torch.core.schedules import build_schedule

    steps = torch.arange(args.n_steps)
    plt.figure(figsize=(8, 5))
    for kind, label in [
        ("linear_annealing", "linear"),
        ("logarithmic_annealing", "logarithmic"),
        ("exponential_annealing", "exponential"),
        ("sinusoidal_annealing", "cosine"),
    ]:
        sched = build_schedule(kind, args.n_steps,
                               beta_start=args.beta_start,
                               beta_end=args.beta_end)
        plt.plot(steps.numpy(), sched(steps).numpy(), linewidth=2,
                 label=label)
    plt.xlabel("Step", fontsize=14)
    plt.ylabel(r"$\beta$", fontsize=14)
    plt.title("Annealing schedules", fontsize=14)
    plt.grid(True, alpha=0.3)
    plt.legend(fontsize=11)
    out = os.path.join(args.outdir, "figures", "beta_schedules.png")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    plt.savefig(out, bbox_inches="tight", dpi=150)
    plt.close()
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
