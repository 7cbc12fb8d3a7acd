"""Config-driven experiment CLI (PyTorch port).

Same config schema, drivers and outputs (``figures/``, ``results/*.csv``
under ``--outdir``) as ``python -m mcqueens.cli.experiments``; the runs go
through the port's kernels on ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain-torch twins).  ``--mesh`` and ``--profile-dir`` are not
ported yet (ROADMAP.md queue 1 item 7) and are refused, as are the
config's ``tpu.mesh`` and ``tpu.profile_dir``; ``tpu.checkpoint_dir`` makes
the sweep resumable (one checkpoint a cell).

    python -m mcqueens_torch.cli.experiments [--config config.yaml]
        [--outdir .] [--device cuda]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="config.yaml")
    parser.add_argument("--outdir", default=".",
                        help="root for figures/ and results/ outputs")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (the CUDA kernels) or cpu "
                             "(their plain-torch twins)")
    parser.add_argument("--mesh", action="store_true")
    parser.add_argument("--profile-dir", default=None)
    args = parser.parse_args(argv)

    not_ported = {"--mesh": args.mesh,
                  "--profile-dir": args.profile_dir is not None}
    refused = [flag for flag, given in not_ported.items() if given]
    if refused:
        parser.error(f"{', '.join(refused)}: not ported to mcqueens_torch "
                     "yet (ROADMAP.md queue 1 item 7); use python -m "
                     "mcqueens.cli.experiments")

    from mcqueens_torch.experiments import drivers
    from mcqueens_torch.experiments.config import load_config
    from mcqueens_torch.utils import profiling

    cfg = load_config(args.config)
    with profiling.timed(f"experiment {cfg.experiment_type}"):
        drivers.run_from_config(cfg, outdir=args.outdir, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
