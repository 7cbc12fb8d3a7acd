#!/usr/bin/env python
"""The card's roofline numbers and the samplers' moves/s, port of
``tools/roofline.py``.

Measures, on the card, (a) what shapes the kernels' design: memory
bandwidth (an in-place int32 add over a large buffer), the per-launch cost
of a tiny op issued from Python (the port has no XLA scan; its segments are
Python loops of launches), an in-place column add on a (chains, 7332) count
table, and the int32 add rate and latency (kernel A,
:func:`mcqueens_torch.kernels.probes.vpu_doubling`); and (b) proposed
moves/s of every sampler x variant through the runner's modules.  Prints a
markdown table and writes JSON (default ``artifacts/h100/roofline.json``).

Usage:  python -m mcqueens_torch.tools.roofline [--quick] [--skip-micro]
            [--json out.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mcqueens_torch import tools
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import rng as rng_mod
from mcqueens_torch.core.schedules import build_schedule
from mcqueens_torch.dist import runner as runner_mod
from mcqueens_torch.kernels import probes

# Kernel A's work per element: k accumulators x n_iter iterations x inner
# doublings (the TPU probe's shape).
VPU_N_ITER, VPU_K, VPU_INNER = 2048, 8, 16


def hbm_bandwidth_gbs(quick=False, *, device="cuda"):
    """Memory bandwidth in GB/s: an in-place int32 ``add_(1)`` over a 64 MB
    (quick) or 256 MB buffer, counted as one read and one write."""
    dev = tools.device(device)
    n = (64 if quick else 256) * 1024 * 1024 // 4
    n_iter = 16
    x = torch.arange(n, dtype=torch.int32, device=dev)
    x.add_(1)
    dt = tools.elapsed_s(lambda: x.add_(1), dev, reps=n_iter)
    return 2 * n * 4 / dt / 1e9


def launch_overhead_us(*, device="cuda"):
    """Microseconds per launch of a tiny in-place op issued from a Python
    loop: the host's enqueue and launch cost that every kernel of a segment
    loop pays (the JAX tool's XLA scan step has no counterpart here)."""
    dev = tools.device(device)
    n_iter = 10000
    c = torch.zeros((), dtype=torch.int32, device=dev)
    c.add_(1)
    tools.sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        c.add_(1)
    tools.sync(dev)
    return (time.perf_counter() - t0) / n_iter * 1e6


def column_add_ms(quick=False, *, device="cuda"):
    """Milliseconds per in-place ``tab[:, i % W] += 1`` on a (chains, 7332)
    int32 table (1024 chains quick, else 4096): the per-step update the
    count-table design would make, which the TPU's XLA scan paid as a
    whole-buffer rewrite."""
    dev = tools.device(device)
    C, W = (1024 if quick else 4096), 7332
    n_iter = 16 if quick else 64
    tab = torch.zeros((C, W), dtype=torch.int32, device=dev)
    tab[:, 0] += 1
    i = iter(range(n_iter))
    return tools.elapsed_s(lambda: tab[:, next(i) % W].add_(1), dev,
                           reps=n_iter) * 1e3


def vpu_ns_per_vreg(independent: bool, *, width=None, n_iter=VPU_N_ITER,
                    reps=4, device="cuda"):
    """Kernel A: ns per 1024 int32 adds (the TPU's vector register holds
    1024 lanes, so the number compares with the JAX tool's per-VREG one).

    independent=True: 8 accumulator chains per element (throughput);
    independent=False: one dependent chain (latency).  The (8, width) input
    is ones, as in the JAX tool; ``width`` defaults to
    :data:`tools.ALU_WIDTH` columns, which fills the card.
    """
    dev = tools.device(device)
    x = torch.ones((tools.ALU_ROWS, width or tools.ALU_WIDTH),
                   dtype=torch.int32, device=dev)

    def run():
        return probes.vpu_doubling(x, independent, n_iter=n_iter, k=VPU_K,
                                   inner=VPU_INNER)

    run()
    dt = tools.elapsed_s(run, dev, reps=reps)
    adds = n_iter * VPU_K * VPU_INNER * x.numel()
    return dt / adds * 1024 * 1e9


def kernel_moves_per_sec(kernel: str, mcmc_type: str, chains: int, seg: int,
                         seconds: float = 4.0, *, device="cuda"):
    """Proposed moves/s through the runner's sampler modules: N=16, linear
    beta 1 -> 5 over 2^24 steps, ``seg``-step segments, timed over a
    synchronised window of at least ``seconds``."""
    dev = tools.device(device)
    horizon = 2 ** 24
    spec = ChainSpec(
        N=16, n_steps=horizon,
        schedule=build_schedule("linear_annealing", horizon,
                                beta_start=1.0, beta_end=5.0),
        init_mode="random", mcmc_type=mcmc_type, kernel=kernel,
        history_stride=seg,
    )
    mod = runner_mod.sampler_module(spec)
    seeds = np.arange(chains, dtype=np.uint32)
    init = (seeds if kernel in ("pallas", "pallas_shared")
            else rng_mod.chain_keys_from_seeds(seeds, dev))
    carry = mod.init_carry_batch(init, spec, device=dev)
    carry, _ = mod.run_segment(carry, 0, spec, 1)
    tools.sync(dev)
    t0 = time.perf_counter()
    done, s = 0, 1
    while True:
        carry, _ = mod.run_segment(carry, s, spec, 1)
        s += 1
        done += seg
        tools.sync(dev)
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    return done * chains / elapsed


def table(quick: bool):
    """(label, kernel, mcmc_type, chains, segment) of the moves/s table:
    the JAX tool's rows, the quick run at a quarter of the chains and
    segment of the Pallas-kernel rows."""
    scale = 4 if quick else 1
    return [
        ("scan + count tables (board)", "tables", "board", 4096, 64),
        ("scan + dense dE (board)", "naive", "board", 4096, 64),
        ("per-chain-site (board)", "pallas", "board", 16384 // scale,
         8192 // scale),
        ("per-chain (full_3d)", "pallas", "full_3d", 16384 // scale,
         8192 // scale),
        ("shared-site lazy (full_3d)", "pallas_shared", "full_3d",
         32768 // scale, 8192 // scale),
        ("shared-site sliced (board)", "pallas_shared", "board",
         32768 // scale, 32768 // scale),
        # BASELINE.json's configuration (4096 chains).
        ("shared-site sliced (board, BASELINE config)", "pallas_shared",
         "board", 4096 // scale, 32768 // scale),
    ]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--json", default=str(tools.H100_ARTIFACTS
                                              / "roofline.json"))
    parser.add_argument("--skip-micro", action="store_true",
                        help="only the kernel throughput table")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    tools.output_path(args.json)
    dev = tools.device(args.device)

    out = tools.card(dev)
    out["quick"] = args.quick
    if not args.skip_micro:
        out["hbm_bandwidth_GB_s"] = hbm_bandwidth_gbs(args.quick, device=dev)
        print(f"memory bandwidth (in-place int32 add): "
              f"{out['hbm_bandwidth_GB_s']:.1f} GB/s", flush=True)
        out["launch_overhead_us"] = launch_overhead_us(device=dev)
        print(f"per-launch cost of a tiny op from Python: "
              f"{out['launch_overhead_us']:.2f} us", flush=True)
        out["column_add_ms_per_step"] = column_add_ms(args.quick, device=dev)
        print(f"in-place column add on a ({1024 if args.quick else 4096}, "
              f"7332) table: {out['column_add_ms_per_step']:.4f} ms/step",
              flush=True)
        out["vpu_width"] = tools.ALU_WIDTH
        thr = vpu_ns_per_vreg(True, device=dev)
        lat = vpu_ns_per_vreg(False, device=dev)
        out["int32_add_ns_per_1024_throughput"] = thr
        out["int32_add_ns_per_1024_latency"] = lat
        out["int32_add_ops_per_s"] = 1024 / thr * 1e9
        print(f"int32 adds, ns per 1024 over (8, {tools.ALU_WIDTH}): "
              f"{thr:.4f} (8 chains) / {lat:.4f} (1 chain) = "
              f"{out['int32_add_ops_per_s']:.4e} adds/s", flush=True)

    out["kernels"] = {}
    print("\n| path | moves/s (N=16) |\n|---|---|", flush=True)
    for label, kern, mt, chains, seg in table(args.quick):
        rate = kernel_moves_per_sec(kern, mt, chains, seg,
                                    seconds=1.5 if args.quick else 4.0,
                                    device=dev)
        out["kernels"][f"{label} ({chains} chains, {seg}-step segments)"] = \
            rate
        print(f"| {label} ({chains} chains) | {rate:.4g} |", flush=True)

    tools.write_json(args.json, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
