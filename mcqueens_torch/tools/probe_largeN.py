"""The shared-site board sampler at N=24 and N=32, port of
``tools/probe_largeN.py``.

    python -m mcqueens_torch.tools.probe_largeN [--seconds 5.0] [--quick]
        [--device cuda] [--json PATH]

At each size, the JAX package's block (``kernels/board_shared.py``
``block_size``: 1664 chains at N=24 of 16640, 896 at N=32 of 17920), the
bench's rate (:func:`mcqueens_torch.bench._measure`, ``pallas_shared``,
8192-step chunks for ``--seconds``) and its wall time with the build and
the warm-up, then the oracle: from seeds ``7 ..``, two 8192-step chunks,
after which the incremental energies of chains 0, C/2 and C-1 and the best
energy of chain 0 must equal ``core.energy.board_energy`` of their boards.
``--quick`` runs 64 chains a size with 64-step chunks, for the CPU tests.

Prints a line a size and ``FINAL`` with all of them, then the card's name
and power limit, and writes them to ``--json`` (default
``artifacts/h100/probe_largeN.json``).  On ``--device cpu`` the kernel's
plain-torch twin runs, and the rate is ``moves_per_s_cpu``: no number of
such a run is a device measurement.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from mcqueens_torch import bench, tools
from mcqueens_torch.core.energy import board_energy
from mcqueens_torch.kernels import board_shared

SIZES = ((24, 16640), (32, 17920))
SEG = 8192
QUICK_CHAINS, QUICK_SEG = 64, 64


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--quick", action="store_true",
                        help="64 chains a size, 64-step chunks")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--json", default=None)
    args = parser.parse_args(argv)
    path = tools.output_path(args.json
                             or tools.H100_ARTIFACTS / "probe_largeN.json")
    dev = tools.device(args.device)
    key = "moves_per_s_per_chip" if dev.type == "cuda" else "moves_per_s_cpu"

    out = {}
    for N, chains in SIZES:
        if args.quick:
            chains = QUICK_CHAINS
        seg = QUICK_SEG if args.quick else SEG
        spec = bench.bench_spec(N, seg, "pallas_shared")
        t0 = time.time()
        rate = bench._measure(N, chains, seg, args.seconds, "pallas_shared",
                              device=dev)
        out[f"N{N}"] = {"block": board_shared.block_size(chains, spec),
                        "chains": chains, key: rate,
                        "wall_incl_compile_s": round(time.time() - t0, 1)}
        _oracle(spec, chains, dev)
        out[f"N{N}"]["oracle_checked"] = True
        print(json.dumps({f"N{N}": out[f"N{N}"]}), flush=True)
    print("FINAL", json.dumps(out))
    device = tools.card(dev)
    print(device["nvidia_smi_name_power_limit"])
    tools.write_json(path, {"sizes": out, **device})
    return 0


def _oracle(spec, chains, dev) -> None:
    """Incremental energy == ``board_energy`` of the board, after two
    chunks, at chains 0, C/2 and C-1, and chain 0's best."""
    N = spec.N
    seeds = np.arange(7, 7 + chains, dtype=np.uint32)
    carry = board_shared.init_carry_batch(seeds, spec, device=dev)
    carry, _ = board_shared.run_segment(carry, 0, spec, 2)
    for r in (0, chains // 2, chains - 1):
        got = int(carry.energy[r, 0])
        want = int(board_energy(carry.heights[r].reshape(N, N)))
        if got != want:
            raise AssertionError(f"N={N} chain {r}: incremental energy {got}"
                                 f", oracle {want}")
    got = int(carry.best_energy[0, 0])
    want = int(board_energy(carry.best_heights[0].reshape(N, N)))
    if got != want:
        raise AssertionError(f"N={N} chain 0: best energy {got}, oracle of "
                             f"the best board {want}")


if __name__ == "__main__":
    raise SystemExit(main())
