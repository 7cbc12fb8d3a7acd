"""Config-driven experiment CLI (PyTorch port).

Same config schema, drivers and outputs (``figures/``, ``results/*.csv``
under ``--outdir``) as ``python -m mcqueens.cli.experiments``; the runs go
through the port's kernels on ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain-torch twins).  ``--profile-dir`` (or the config's
``tpu.profile_dir``) writes a ``torch.profiler`` trace of the sweep there;
``tpu.checkpoint_dir`` makes the sweep resumable (one checkpoint a cell).
``--mesh`` shards every run's chains over all devices of ``--device``'s
type, and the config's ``tpu.mesh`` over all (``true``) or the first n
(``n``): on CUDA every visible card or the first n; on the CPU, which torch
sees as one device, one shard or n shards of it
(:func:`mcqueens_torch.dist.mesh.mesh_for`).  ``--mesh`` overrides
``tpu.mesh``, as in the JAX CLI.

    python -m mcqueens_torch.cli.experiments [--config config.yaml]
        [--outdir .] [--device cuda] [--mesh] [--profile-dir DIR]
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
    parser.add_argument("--mesh", action="store_true",
                        help="shard chains over all devices of --device's "
                             "type (one shard on the CPU)")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace here")
    args = parser.parse_args(argv)

    from mcqueens_torch.dist import mesh as mesh_mod
    from mcqueens_torch.experiments import drivers
    from mcqueens_torch.experiments.config import load_config
    from mcqueens_torch.utils import profiling

    cfg = load_config(args.config)
    # Without --mesh the driver builds the config's tpu.mesh itself.
    mesh = mesh_mod.mesh_for(args.device) if args.mesh else None
    with profiling.trace(args.profile_dir or cfg.tpu.profile_dir):
        with profiling.timed(f"experiment {cfg.experiment_type}"):
            drivers.run_from_config(cfg, outdir=args.outdir,
                                    device=args.device, mesh=mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
