#!/usr/bin/env python3
"""Time the board scan sampler and the slice copy of one checkout of the
port on one CUDA GPU, so that two commits can be compared in one run:

    python3 pair_scan_slice.py --root DIR [--label NAME] [--json PATH]

``DIR`` is the root of a checkout: its ``mcqueens_torch`` is imported and
its kernels are built under ``DIR/build``.  To compare a commit with its
parent, unpack the parent with ``git archive`` into a git-ignored directory
and run parent, change, change, parent in one session on one card.  Only
public functions that both sides have are called.  Phases:

  * ``config.yaml`` as committed (compare_beta_end: N 12 and 18, 10 runs,
    1M steps, stride 1, kernel tables) through
    ``drivers.run_from_config(plot=False)``: wall time, after one tiny run
    that loads the kernel;
  * the board scan kernel alone at that configuration's launch shape (10
    chains, stride 1, 100000 steps from step 0): microseconds per step;
  * the board scan kernel alone at 4096 chains (N=16, linear 1->5 over
    2^24 steps, one 16384-step chunk after a first one), tables and naive:
    proposed moves/s;
  * the slice copy (``kernels/probes_mem.py``) at the slice tool's
    card-filling shape, (256, 67584) int32, 16 rows at row 240 (load) and
    48 (store), beside ``torch.narrow_copy`` and ``Tensor.index_fill``,
    each timed behind a spin kernel so that no launch waits for the host.

Prints one JSON line with the card's name and power limit; exits non-zero
without a CUDA GPU.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="root of the checkout whose port is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--json", default=None, help="also write the line here")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("pair_scan_slice: no CUDA GPU")
    from mcqueens_torch.chain import board
    from mcqueens_torch.chain.spec import ChainSpec
    from mcqueens_torch.core import rng
    from mcqueens_torch.core.schedules import build_schedule, chunk_betas
    from mcqueens_torch.experiments import drivers
    from mcqueens_torch.experiments.config import load_config
    from mcqueens_torch.kernels import probes_mem

    if not board.__file__.startswith(root):
        raise SystemExit(f"imported {board.__file__}, not from {root}")

    def events_ms(fn, reps=1, spin=False):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if spin:
            torch.cuda._sleep(5_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def spec_of(N, n_steps, stride, schedule, kernel):
        return ChainSpec(N=N, n_steps=n_steps, schedule=schedule,
                         kernel=kernel, history_stride=stride)

    def scan_state(spec, chains, start_outer):
        keys = rng.chain_keys_from_seeds(np.arange(chains, dtype=np.uint32),
                                         "cuda")
        carry = board.init_carry_batch(keys, spec, device="cuda")
        if start_outer:
            carry, _ = board.run_segment(carry, 0, spec, start_outer)
        return board.segment_state(carry)

    def scan_ms(spec, chains, start_outer, n_outer):
        st = scan_state(spec, chains, start_outer)
        stride = spec.history_stride
        beta = chunk_betas(spec.schedule, start_outer * stride,
                           n_outer * stride, "cuda")
        ys = torch.empty((n_outer, chains), dtype=torch.int32, device="cuda")
        return events_ms(lambda: board.segment_cuda(st, ys, start_outer,
                                                    n_outer, spec, beta))

    out = {"label": args.label, "root": root,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip().splitlines()[0]}

    # Load the kernel library and every kernel this run launches.
    flat = build_schedule("constant", 64, beta_const=1.0)
    for kern in ("tables", "naive"):
        scan_ms(spec_of(4, 64, 1, flat, kern), 4, 0, 8)

    cfg = load_config(os.path.join(root, "config.yaml"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d, \
            contextlib.redirect_stdout(io.StringIO()):
        drivers.run_from_config(cfg, outdir=d, device="cuda", plot=False)
    torch.cuda.synchronize()
    out["config_yaml_slice_s"] = time.perf_counter() - t0

    out["board_scan_us_per_step_c10"] = {}
    for N, beta_end in ((12, 3.0), (18, 5.0)):
        n = 10 ** 6
        spec = spec_of(N, n, 1, build_schedule(
            "exponential_annealing", n, beta_start=1.0, beta_end=beta_end),
            "tables")
        ms = scan_ms(spec, 10, 0, 100_000)
        out["board_scan_us_per_step_c10"][f"N={N}"] = ms * 1e3 / 100_000

    out["board_scan_4096_moves_per_s"] = {}
    horizon, stride, chains = 2 ** 24, 16384, 4096
    for kern in ("tables", "naive"):
        spec = spec_of(16, horizon, stride, build_schedule(
            "linear_annealing", horizon, beta_start=1.0, beta_end=5.0), kern)
        ms = scan_ms(spec, chains, 1, 1)
        out["board_scan_4096_moves_per_s"][kern] = stride * chains / ms * 1e3

    S, C, width = 256, 67584, 16
    x = torch.arange(S * C, dtype=torch.int32, device="cuda").reshape(S, C)
    out["slice_copy_ms"] = {}
    for mode, row in (("load", 240), ("store", 48)):
        off = torch.tensor([row], dtype=torch.int32, device="cuda")
        if mode == "load":
            kernel = lambda: probes_mem.slice_load_cuda(x, off, width)
            want = probes_mem.slice_load_reference(x, off, width)
            library = lambda: torch.narrow_copy(x, 0, row, width)
            name = "narrow_copy"
        else:
            rows = torch.arange(row, row + width, device="cuda")
            kernel = lambda: probes_mem.slice_store_cuda(x, off, width)
            want = probes_mem.slice_store_reference(x, off, width)
            library = lambda: x.index_fill(0, rows, 7)
            name = "index_fill"
        if not (torch.equal(kernel(), want) and torch.equal(library(), want)):
            raise AssertionError(f"slice {mode}: kernel or {name} is wrong")
        out["slice_copy_ms"][mode] = {
            "kernel": events_ms(kernel, 10, spin=True),
            name: events_ms(library, 10, spin=True)}
    line = json.dumps(out)
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
