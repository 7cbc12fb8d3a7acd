#!/usr/bin/env python
"""Which dynamic-gather forms work, and what they cost on the card; port of
``tools/probe_gather.py``.

The JAX tool probes Mosaic's ``take_along_axis`` on the TPU: along lanes
(axis 1) and sublanes (axis 0), with an index as wide as the operand or
narrower, and the cost of a dependent gather chain against a dependent add
pass.  On the card a gather is a per-thread load, so every form is legal;
this tool checks each against numpy and times the same chains:

  * :func:`gather_correct`, :func:`gather_narrow_idx`: the gather kernel
    (``kernels/csrc/probe_gather.cu``, :func:`probes_mem.gather`);
  * :func:`gather_cost`: the gather chain out of shared memory
    (:func:`probes_mem.gather_chain`);
  * :func:`add_cost`: kernel A's dependent doubling chain
    (:func:`probes.vpu_doubling`, every doubling in its inner loop).

The JAX tool's shapes, then one that fills the card for each kind (the
TPU's (8, 128) is eight warps): axis-1 gathers grow rows, axis-0 gathers
columns.  Costs are in ns per step over the array and ns per 1024 words
(the JAX tool's per-VREG unit); each timed call includes the wrapper's
index check, which reads the index's range back from the card.  Writes
``artifacts/h100/probe_gather.json``.

Usage:  python -m mcqueens_torch.tools.probe_gather [--quick]
            [--json out.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mcqueens_torch import tools
from mcqueens_torch.kernels import probes, probes_mem

GATHER_N_ITER = 512
ADD_N_ITER = 2048


def _gather_inputs(S, L, shape, hi, seed, dev):
    x = np.arange(S * L, dtype=np.int32).reshape(S, L)
    idx = np.random.default_rng(seed).integers(0, hi, size=shape,
                                               dtype=np.int32)
    return x, idx, torch.from_numpy(x).to(dev), torch.from_numpy(idx).to(dev)


def gather_correct(S, L, axis, *, device="cuda"):
    """The gather of an (S, L) ``arange`` by a full-width random index,
    checked against numpy."""
    dev = tools.device(device)
    x, idx, xt, it = _gather_inputs(S, L, (S, L), L if axis == 1 else S, 0,
                                    dev)
    out = probes_mem.gather(xt, it, axis).cpu().numpy()
    expect = np.take_along_axis(x, idx, axis=axis)
    if not (out == expect).all():
        bad = int((out != expect).sum())
        return f"WRONG ({bad}/{out.size} mismatch)"
    return "correct"


def gather_narrow_idx(S, L, K, axis, *, device="cuda"):
    """The gather with an index narrower than the operand: (S, K) on axis
    1, (K, L) on axis 0."""
    dev = tools.device(device)
    shape, hi = ((S, K), L) if axis == 1 else ((K, L), S)
    x, idx, xt, it = _gather_inputs(S, L, shape, hi, 1, dev)
    out = probes_mem.gather(xt, it, axis).cpu().numpy()
    if not (out == np.take_along_axis(x, idx, axis=axis)).all():
        return "WRONG"
    return "correct"


def gather_cost(S, L, axis, n_iter=GATHER_N_ITER, *, reps=8, device="cuda"):
    """ns per gather step of the dependent chain ``acc = take_along_axis(
    acc, idx, axis) + 1`` over (S, L) int32."""
    dev = tools.device(device)
    x = torch.from_numpy(np.arange(S * L, dtype=np.int32).reshape(S, L) % 7)
    idx = np.random.default_rng(2).integers(0, L if axis == 1 else S,
                                            size=(S, L), dtype=np.int32)
    x, it = x.to(dev), torch.from_numpy(idx).to(dev)

    def run():
        return probes_mem.gather_chain(x, it, axis, n_iter=n_iter)

    run()
    dt = tools.elapsed_s(run, dev, reps=reps) / n_iter
    per = tools.ns_per_1024(dt, S * L)
    return (f"{dt * 1e9:.1f} ns/gather over {S * L} words ({per:.4f} ns per "
            f"1024 words)", {"ns_per_gather": dt * 1e9,
                             "ns_per_1024_words": per, "n_iter": n_iter})


def add_cost(S, L, n_iter=ADD_N_ITER, *, reps=8, device="cuda"):
    """Baseline: ns per dependent int32 add pass (``acc + acc``) over
    (S, L)."""
    dev = tools.device(device)
    x = torch.ones((S, L), dtype=torch.int32, device=dev)

    def run():
        return probes.vpu_doubling(x, False, n_iter=1, k=1, inner=n_iter)

    run()
    dt = tools.elapsed_s(run, dev, reps=reps) / n_iter
    per = tools.ns_per_1024(dt, S * L)
    return (f"{dt * 1e9:.1f} ns/add over {S * L} words ({per:.4f} ns per "
            f"1024 words)", {"ns_per_add": dt * 1e9,
                             "ns_per_1024_words": per, "n_iter": n_iter})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=str(tools.H100_ARTIFACTS
                                          / "probe_gather.json"))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    tools.output_path(args.json)
    dev = tools.device(args.device)
    reps = 2 if args.quick else 8
    print(f"device: {tools.card(dev)}", flush=True)

    res = {}

    def probe(name, fn, **kw):
        tools.probe(res, name, lambda: fn(**kw, device=dev))

    W1 = tools.ONE_PASS_WORDS
    # --- correctness / legality matrix ---
    for S, L in ((8, 128), (8, 256), (64, 128), (256, 512)):
        probe(f"lane-gather ({S},{L})", gather_correct, S=S, L=L, axis=1)
    probe(f"lane-gather ({W1 // 512},512) [fills the card]", gather_correct,
          S=W1 // 512, L=512, axis=1)
    for S, L in ((8, 128), (32, 128), (256, 128), (256, 1024)):
        probe(f"sublane-gather ({S},{L})", gather_correct, S=S, L=L, axis=0)
    probe(f"sublane-gather (256,{W1 // 256}) [fills the card]",
          gather_correct, S=256, L=W1 // 256, axis=0)
    # narrow-index forms (what the TPU kernel wanted: 64 of 256)
    probe("lane-gather narrow (8,256->64)", gather_narrow_idx, S=8, L=256,
          K=64, axis=1)
    probe("sublane-gather narrow (256,128->64)", gather_narrow_idx, S=256,
          L=128, K=64, axis=0)
    probe(f"lane-gather narrow ({W1 // 64},256->64) [fills the card]",
          gather_narrow_idx, S=W1 // 64, L=256, K=64, axis=1)
    # --- cost ---
    T = tools.TIMING_THREADS
    probe("add cost (256,1024)", add_cost, S=256, L=1024, reps=reps)
    probe(f"add cost ({tools.ALU_ROWS},{tools.ALU_WIDTH}) [fills the card]",
          add_cost, S=tools.ALU_ROWS, L=tools.ALU_WIDTH, reps=reps)
    probe("lane-gather cost (8,128)", gather_cost, S=8, L=128, axis=1,
          reps=reps)
    probe("lane-gather cost (64,256)", gather_cost, S=64, L=256, axis=1,
          reps=reps)
    probe(f"lane-gather cost ({T // 256},256) [fills the card]", gather_cost,
          S=T // 256, L=256, axis=1, reps=reps)
    probe("sublane-gather cost (256,1024)", gather_cost, S=256, L=1024,
          axis=0, reps=reps)
    # 8 threads per column of 256 rows
    probe(f"sublane-gather cost (256,{T // 8}) [fills the card]", gather_cost,
          S=256, L=T // 8, axis=0, reps=reps)

    out = {**tools.card(dev), "quick": args.quick, "reps": reps,
           "probes": res}
    tools.write_json(args.json, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
