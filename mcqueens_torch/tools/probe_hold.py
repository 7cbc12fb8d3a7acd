"""Throughput of the shared-site full-3D kernel against its mover hold, port
of ``tools/probe_hold.py``.

The kernel (``kernels/csrc/full3d_shared.cu``) holds one shared mover for
``_HOLD`` steps, so the one-vs-all pass of the mover's old cell runs once a
chunk and the chunk's candidates share one pass over the queens: (1 + 1/H)
pass targets a step.  A longer hold saves at most ~1/(H+1) of the pass, and
holds H candidates' counts in registers; this probe measures what it saves
on the card, beside each instance's registers and spills from the build.

    python -m mcqueens_torch.tools.probe_hold --hold 16 [--n 16]
        [--chains 32768] [--seg 8192] [--seconds 5.0] [--device cuda]
        [--json PATH]

The hold is one of 8, 16 and 32 (the kernel's instances), and above 8 a
launch takes at least 1024 steps (``--seg``): below that the JAX kernel
skips the held chunks, so there is no reference.  ``_HOLD`` is patched for
the call and restored after it.  Chunks of ``--seg`` steps are timed with
CUDA events after one warm-up chunk (:func:`mcqueens_torch.bench.
timed_segments`).  Then the exactness invariant is checked on 256 chains
spread over the blocks: each incremental final energy must equal
``core.energy.full3d_energy`` of its final queens.

Prints the JAX tool's line (``hold``, ``moves_per_s_chip``, ``steps``,
``energy_exact``), then the card's name and power limit, and writes both,
with the instances' registers and spills, to ``--json`` (default
``artifacts/h100/probe_hold_h<hold>.json``).  On ``--device cpu`` the
kernel's plain-torch twin runs, and its rate is ``moves_per_s_cpu``: no
number of such a run is a device measurement (no build, so no registers).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mcqueens_torch import tools
from mcqueens_torch.bench import HORIZON, timed_segments
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core.energy import full3d_energy
from mcqueens_torch.core.schedules import build_schedule
from mcqueens_torch.kernels import _build, full3d_shared

EXACT_CHAINS = 256


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--hold", type=int, default=8)
    parser.add_argument("--n", type=int, default=16)
    parser.add_argument("--chains", type=int, default=32768)
    parser.add_argument("--seg", type=int, default=8192)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--json", default=None)
    args = parser.parse_args(argv)
    if args.hold not in full3d_shared.HOLDS:
        parser.error(f"--hold must be one of {full3d_shared.HOLDS}")
    if args.hold != 8 and args.seg < full3d_shared.LONG_LAUNCH:
        parser.error(f"--hold {args.hold} needs --seg >= "
                     f"{full3d_shared.LONG_LAUNCH}")
    path = tools.output_path(
        args.json or tools.H100_ARTIFACTS / f"probe_hold_h{args.hold}.json")
    dev = tools.device(args.device)

    held = full3d_shared._HOLD
    full3d_shared._HOLD = args.hold
    try:
        line, instances = _probe(args, dev)
    finally:
        full3d_shared._HOLD = held
    print(json.dumps(line))
    device = tools.card(dev)
    print(device["nvidia_smi_name_power_limit"])
    tools.write_json(path, {**line, **device, "chains": args.chains,
                            "n": args.n, "seg": args.seg,
                            "instances": instances})
    return 0


def _probe(args, dev):
    spec = ChainSpec(
        N=args.n, n_steps=HORIZON,
        schedule=build_schedule("linear_annealing", HORIZON,
                                beta_start=1.0, beta_end=5.0),
        init_mode="random", mcmc_type="full_3d", kernel="pallas_shared",
        history_stride=args.seg)
    seeds = np.arange(args.chains, dtype=np.uint32)
    carry = full3d_shared.init_carry_batch(seeds, spec, device=dev)
    carry, steps, seconds = timed_segments(full3d_shared, spec, carry,
                                           args.seconds)
    rate = steps * args.chains / seconds

    idx = torch.from_numpy(np.linspace(0, args.chains - 1, EXACT_CHAINS)
                           .astype(np.int64)).to(dev)
    queens = torch.stack([carry.qi, carry.qj, carry.qk], dim=-1)[idx]
    oracle = full3d_energy(queens)
    exact = bool(torch.equal(oracle.to(torch.int32),
                             carry.energy.reshape(-1)[idx]))

    instances = []
    if dev.type == "cuda":
        usage = full3d_shared.instances(_build.ptxas_usage())
        instances = [{"lanes": lanes, "shared_memory": shared, **use}
                     for (lanes, shared, h), use in sorted(usage.items())
                     if h == args.hold]
    key = "moves_per_s_chip" if dev.type == "cuda" else "moves_per_s_cpu"
    return ({"hold": args.hold, key: rate, "steps": steps,
             "energy_exact": exact}, instances)


if __name__ == "__main__":
    raise SystemExit(main())
