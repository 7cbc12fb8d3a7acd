"""Headline benchmark of the port: proposed moves/s per card on the board
sampler, the counterpart of the JAX package's ``bench.py``.

    python -m mcqueens_torch.bench [--n 16] [--chains 32768]
        [--segment-steps 32768] [--target-seconds 5.0]
        [--kernel {pallas_shared,pallas,tables,naive}] [--quick]
        [--device cuda]

The configuration is ``bench.py``'s: board N=16, a linear 1 -> 5 schedule
over 2^24 steps (the opening stretch of a long anneal), random starts,
seeds ``0 .. chains - 1``, one history chunk of ``--segment-steps`` steps a
``run_segment`` call.  ``--kernel`` picks the sampler as ``bench.py`` does:
``pallas_shared`` the shared-site board kernel
(:mod:`mcqueens_torch.kernels.board_shared`), ``pallas`` the per-chain one
(:mod:`~.kernels.metropolis_pallas`), ``tables`` and ``naive`` the scan
sampler (:mod:`mcqueens_torch.chain.board`).  ``--quick`` is 1024 chains,
2048-step chunks and a 1 s budget.

One warm-up chunk (which builds and loads the kernels), then chunks until
the budget is spent, each followed by a synchronise so that the loop stops
at the budget; the loop's time is read from CUDA events recorded around it.
The rate is divided by the one card the run used.  ``--device`` is ``cuda``
unless ``cpu`` is asked for (the kernels' plain-torch twins, timed by the
host clock: no number of such a run is a device measurement); a missing
card raises.

Prints one JSON line with ``metric``, ``value`` (moves/s on the card),
``unit`` and, unless ``--quick`` or at 4096 chains, ``chains_4096_value``,
the same at ``BASELINE.json``'s 4096 chains (on the CPU the metric and
unit say so: ``moves/s/cpu``).  ``bench.py``'s
``vs_baseline`` and ``chains_4096_vs_baseline`` are left out: they divide
by a target set for another chip.  So are ``vs_best_round`` and
``regression``: they compare with the rounds that chip committed
(``BENCH_r*.json``).  Neither is a yardstick of this card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mcqueens_torch import tools
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core.schedules import build_schedule

KERNELS = ("pallas_shared", "pallas", "tables", "naive")
HORIZON = 2 ** 24


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=16)
    parser.add_argument("--chains", type=int, default=32768)
    parser.add_argument("--segment-steps", type=int, default=32768,
                        help="steps per timed run_segment call")
    parser.add_argument("--target-seconds", type=float, default=5.0)
    parser.add_argument("--kernel", default="pallas_shared", choices=KERNELS)
    parser.add_argument("--quick", action="store_true",
                        help="small shapes for smoke-testing the bench itself")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the CUDA kernels) or cpu (their "
                             "plain-torch twins)")
    args = parser.parse_args(argv)

    if args.quick:
        args.chains = 1024
        args.segment_steps = 2048
        args.target_seconds = 1.0

    per_card = _measure(args.n, args.chains, args.segment_steps,
                        args.target_seconds, args.kernel, device=args.device)
    if tools.device(args.device).type == "cuda":
        metric, unit = "proposed moves/sec/chip", "moves/s/chip"
    else:
        metric, unit = "proposed moves/sec on the CPU", "moves/s/cpu"
    record = {
        "metric": (f"{metric} (board N={args.n}, {args.chains} chains, "
                   f"{args.kernel} kernel)"),
        "value": per_card,
        "unit": unit,
    }
    if not args.quick and args.chains != 4096:
        record["chains_4096_value"] = _measure(
            args.n, 4096, args.segment_steps, args.target_seconds,
            args.kernel, device=args.device)
    print(json.dumps(record))
    return 0


def bench_spec(n, segment_steps, kernel) -> ChainSpec:
    """The bench's board spec: linear 1 -> 5 over :data:`HORIZON` steps,
    random starts, ``segment_steps`` steps a history chunk."""
    return ChainSpec(
        N=n,
        n_steps=HORIZON,
        schedule=build_schedule("linear_annealing", HORIZON, beta_start=1.0,
                                beta_end=5.0),
        init_mode="random",
        mcmc_type="board",
        kernel=kernel,
        history_stride=segment_steps,
    )


def _setup(n, chains, segment_steps, kernel, *, device="cuda"):
    """``(module, spec, carry)`` of the bench configuration: ``module`` is
    the sampler ``kernel`` names, ``carry`` its initial state of ``chains``
    chains on ``device``."""
    dev = tools.device(device)
    spec = bench_spec(n, segment_steps, kernel)
    seeds = np.arange(chains, dtype=np.uint32)
    if kernel == "pallas_shared":
        from mcqueens_torch.kernels import board_shared as mod
    elif kernel == "pallas":
        from mcqueens_torch.kernels import metropolis_pallas as mod
    else:
        from mcqueens_torch.chain import board as mod
        from mcqueens_torch.core import rng

        return mod, spec, mod.init_carry_batch(
            rng.chain_keys_from_seeds(seeds, dev), spec, device=dev)
    return mod, spec, mod.init_carry_batch(seeds, spec, device=dev)


def _measure(n, chains, segment_steps, target_seconds, kernel, *,
             device="cuda") -> float:
    """Proposed moves/s of ``kernel`` at the bench configuration: chunks of
    ``segment_steps`` steps after one warm-up chunk, until
    ``target_seconds`` have passed."""
    mod, spec, carry = _setup(n, chains, segment_steps, kernel,
                              device=device)
    _, steps, seconds = timed_segments(mod, spec, carry, target_seconds)
    return steps * chains / seconds


def timed_segments(mod, spec, carry, target_seconds):
    """One warm-up ``mod.run_segment`` chunk, then chunks until
    ``target_seconds`` have passed on the host clock, each synchronised;
    returns ``(carry, steps timed, seconds)``, the seconds read from CUDA
    events recorded around the timed chunks (the host clock on the CPU)."""
    dev = carry.device
    carry, _ = mod.run_segment(carry, 0, spec, 1)
    tools.sync(dev)
    on_card = dev.type == "cuda"
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    seg, t0 = 1, time.perf_counter()
    while True:
        carry, _ = mod.run_segment(carry, seg, spec, 1)
        seg += 1
        tools.sync(dev)
        if time.perf_counter() - t0 >= target_seconds:
            break
    if on_card:
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        seconds = time.perf_counter() - t0
    return carry, (seg - 1) * spec.history_stride, seconds


if __name__ == "__main__":
    raise SystemExit(main())
