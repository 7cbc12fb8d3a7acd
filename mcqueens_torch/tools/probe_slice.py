#!/usr/bin/env python
"""Dynamic row slices, pass costs, a row reduction and PRNG draws on the
card; port of ``tools/probe_slice.py``.

The JAX tool asks whether the TPU loads and stores a 16-sublane slice at a
data-dependent offset (the offset a scalar in SMEM), and what the
transposed layout's operations cost there.  The port runs each on the
card, through ``kernels/probes_mem.py``:

  * :func:`dyn_sublane_load`, :func:`dyn_sublane_store`: the slice copy
    (``kernels/csrc/probe_slice.cu``), the offset a one-word int32 tensor on
    the card that the kernel reads; checked against numpy;
  * :func:`dyn_slice_loop_cost`: the slice loop, a dependent load, add and
    store of a (w, C) slice per step, out of shared memory;
  * :func:`pass_cost`, :func:`independent_pass_cost`: kernel A's doubling
    chains, one chain or ``k`` (:func:`probes.vpu_doubling`, every doubling
    in its inner loop);
  * :func:`sublane_reduce_cost`: the reduce, (S, C) -> (1, C) per step;
  * :func:`prng_cost`: the PRNG draws.  The TPU kernel draws from the TPU's
    hardware generator; the card has none, and the port's kernels draw from
    lowbias32 and threefry, so this times both of those
    (:func:`probes_mem.prng_draws`).  No number here is the TPU's hardware
    PRNG.

The JAX tool's shapes, then one that fills the card for each cost (the
slice loop and the reduce grow columns).  Costs are ns per step and ns per
1024 words (the JAX tool's per-VREG unit).  ``--quick`` cuts the reps and
the reduce's and the draws' trip counts.  Writes
``artifacts/h100/probe_slice.json``.

Usage:  python -m mcqueens_torch.tools.probe_slice [--quick]
            [--json out.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mcqueens_torch import tools
from mcqueens_torch.kernels import probes, probes_mem

LOOP_N_ITER = 4096
PASS_N_ITER = 8192
IND_N_ITER = 2048
REDUCE_N_ITER = 4096
PRNG_N_ITER = 4096
QUICK_CUT = 8  # --quick's cut of the reduce's and the draws' trip counts
NOT_TPU = "the port's generator, not the TPU's hardware PRNG"


def _slice_inputs(S, C, offset, dev):
    x = np.arange(S * C, dtype=np.int32).reshape(S, C)
    off = torch.tensor([offset], dtype=torch.int32, device=dev)
    return x, torch.from_numpy(x).to(dev), off


def dyn_sublane_load(S, C, width, offset, *, device="cuda"):
    """Load a (width, C) slice of an (S, C) ``arange`` at a runtime row
    offset; check values."""
    dev = tools.device(device)
    x, xt, off = _slice_inputs(S, C, offset, dev)
    out = probes_mem.slice_load(xt, off, width).cpu().numpy()
    if not (out == x[offset:offset + width]).all():
        return "WRONG"
    return "correct"


def dyn_sublane_store(S, C, width, offset, *, device="cuda"):
    """Store 7 into a (width, C) slice at a runtime row offset; check
    values."""
    dev = tools.device(device)
    x, xt, off = _slice_inputs(S, C, offset, dev)
    out = probes_mem.slice_store(xt, off, width).cpu().numpy()
    expect = x.copy()
    expect[offset:offset + width] = 7
    if not (out == expect).all():
        return "WRONG"
    return "correct"


def _timed(fn, dev, n_iter, reps):
    fn()
    return tools.elapsed_s(fn, dev, reps=reps) / n_iter


def dyn_slice_loop_cost(S, C, width, n_iter=LOOP_N_ITER, *, reps=8,
                        device="cuda"):
    """Cost of a dependent load-slice -> add -> store-slice per step."""
    dev = tools.device(device)
    x = torch.zeros((S, C), dtype=torch.int32, device=dev)
    dt = _timed(lambda: probes_mem.slice_loop(x, width, n_iter=n_iter), dev,
                n_iter, reps)
    return (f"{dt * 1e9:.1f} ns per load+add+store of ({width},{C}) slice",
            {"ns_per_step": dt * 1e9,
             "ns_per_1024_words": tools.ns_per_1024(dt, width * C),
             "n_iter": n_iter})


def pass_cost(S, C, n_iter=PASS_N_ITER, *, reps=8, device="cuda"):
    """Dependent int32 add chain over (S, C): ns per pass."""
    dev = tools.device(device)
    x = torch.ones((S, C), dtype=torch.int32, device=dev)
    dt = _timed(lambda: probes.vpu_doubling(x, False, n_iter=1, k=1,
                                            inner=n_iter), dev, n_iter, reps)
    per = tools.ns_per_1024(dt, S * C)
    return (f"{dt * 1e9:.1f} ns/pass over ({S},{C}) = {per:.4f} ns per 1024 "
            f"words", {"ns_per_pass": dt * 1e9, "ns_per_1024_words": per,
                       "n_iter": n_iter})


def independent_pass_cost(S, C, n_iter=IND_N_ITER, k=8, *, reps=8,
                          device="cuda"):
    """k independent add chains over (S, C): ns per pass (throughput)."""
    dev = tools.device(device)
    x = torch.ones((S, C), dtype=torch.int32, device=dev)
    dt = _timed(lambda: probes.vpu_doubling(x, True, n_iter=1, k=k,
                                            inner=n_iter), dev, n_iter * k,
                reps)
    per = tools.ns_per_1024(dt, S * C)
    return (f"{dt * 1e9:.1f} ns/pass over ({S},{C}) = {per:.4f} ns per 1024 "
            f"words ({k} streams)", {"ns_per_pass": dt * 1e9,
                                     "ns_per_1024_words": per,
                                     "n_iter": n_iter, "k": k})


def sublane_reduce_cost(S, C, n_iter=REDUCE_N_ITER, *, reps=8,
                        device="cuda"):
    """(S, C) -> (1, C) sum along rows, dependent chain."""
    dev = tools.device(device)
    x = torch.ones((S, C), dtype=torch.int32, device=dev)
    dt = _timed(lambda: probes_mem.sublane_reduce(x, n_iter=n_iter), dev,
                n_iter, reps)
    return (f"{dt * 1e9:.1f} ns per ({S},{C})->(1,{C}) sum",
            {"ns_per_sum": dt * 1e9,
             "ns_per_1024_words": tools.ns_per_1024(dt, S * C),
             "n_iter": n_iter})


def prng_cost(R, C, n_iter=PRNG_N_ITER, *, reps=8, device="cuda"):
    """ns per (R, C) draw of each of the port's generators."""
    dev = tools.device(device)
    texts, nums = [], {"n_iter": n_iter, "generator": NOT_TPU}
    for mode in probes_mem.PRNG_MODES:
        dt = _timed(lambda: probes_mem.prng_draws(
            (R, C), mode, n_iter=n_iter, device=dev), dev, n_iter, reps)
        per = tools.ns_per_1024(dt, R * C)
        texts.append(f"{mode} {dt * 1e9:.1f} ns per ({R},{C}) draw "
                     f"({per:.4f} ns per 1024 words)")
        nums[f"{mode}_ns_per_draw"] = dt * 1e9
        nums[f"{mode}_ns_per_1024_words"] = per
    return "; ".join(texts) + f" [{NOT_TPU}]", nums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=str(tools.H100_ARTIFACTS
                                          / "probe_slice.json"))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    tools.output_path(args.json)
    dev = tools.device(args.device)
    reps = 2 if args.quick else 8
    cut = QUICK_CUT if args.quick else 1
    print(f"device: {tools.card(dev)}", flush=True)

    res = {}

    def probe(name, fn, *a, **kw):
        tools.probe(res, name, lambda: fn(*a, **kw, device=dev))

    C, T = 1024, tools.TIMING_THREADS
    W1 = tools.ONE_PASS_WORDS // 256
    probe("dyn sublane load (256,C) w16 off16", dyn_sublane_load,
          256, C, 16, 16)
    probe("dyn sublane load (256,C) w16 off8", dyn_sublane_load, 256, C, 16,
          8)
    probe("dyn sublane load (496,C) w16 off240", dyn_sublane_load, 496, C,
          16, 240)
    probe(f"dyn sublane load (256,{W1}) w16 off240 [fills the card]",
          dyn_sublane_load, 256, W1, 16, 240)
    probe("dyn sublane store (256,C) w16 off48", dyn_sublane_store, 256, C,
          16, 48)
    probe(f"dyn sublane store (256,{W1}) w16 off48 [fills the card]",
          dyn_sublane_store, 256, W1, 16, 48)
    probe("dyn sublane load unaligned (256,C) w16 off12", dyn_sublane_load,
          256, C, 16, 12)
    probe("slice loop cost (256,C) w16", dyn_slice_loop_cost, 256, C, 16,
          LOOP_N_ITER, reps=reps)
    probe(f"slice loop cost (256,{tools.ALU_WIDTH}) w16 [fills the card]",
          dyn_slice_loop_cost, 256, tools.ALU_WIDTH, 16, LOOP_N_ITER,
          reps=reps)
    for S, Cs in ((1, C), (8, C), (64, C), (256, C)):
        probe(f"pass cost ({S},C)", pass_cost, S, Cs, reps=reps)
    probe("pass cost (C,256) [old layout]", pass_cost, C, 256, reps=reps)
    probe(f"pass cost ({tools.ALU_ROWS},{tools.ALU_WIDTH}) [fills the card]",
          pass_cost, tools.ALU_ROWS, tools.ALU_WIDTH, reps=reps)
    probe("ind pass cost (64,C)", independent_pass_cost, 64, C, reps=reps)
    probe("ind pass cost (256,C)", independent_pass_cost, 256, C, reps=reps)
    probe(f"ind pass cost ({tools.ALU_ROWS},{tools.ALU_WIDTH}) "
          f"[fills the card]", independent_pass_cost, tools.ALU_ROWS,
          tools.ALU_WIDTH, reps=reps)
    red = REDUCE_N_ITER // cut
    probe("sublane reduce (64,C)", sublane_reduce_cost, 64, C, red,
          reps=reps)
    probe(f"sublane reduce (64,{T}) [fills the card]", sublane_reduce_cost,
          64, T, red, reps=reps)
    draws = PRNG_N_ITER // cut
    probe("prng (8,C)", prng_cost, 8, C, draws, reps=reps)
    probe("prng (2,C)", prng_cost, 2, C, draws, reps=reps)
    probe(f"prng ({tools.ALU_ROWS},{tools.ALU_WIDTH}) [fills the card]",
          prng_cost, tools.ALU_ROWS, tools.ALU_WIDTH, draws, reps=reps)

    out = {**tools.card(dev), "quick": args.quick, "reps": reps,
           "prng_generators": NOT_TPU, "probes": res}
    tools.write_json(args.json, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
