#!/usr/bin/env python
"""Tie full-3D's fitted pass coefficient to the card's int32 rate, and time
the two alternatives to the production attack test; port of
``tools/probe_full3d_alternatives.py``.

``probe_full3d_cap`` fits the shared-site full-3D kernel's block-step time
as t(Q) = a + b*Q.  This probe asks whether b is what the card's int32
issue rate allows, and whether another form of the attack test is cheaper:

1. **The attack test in three forms** (:func:`_test_rate`, kernel B,
   ``kernels/csrc/probe_attack.cu``): ``production`` (the live two-test
   form with its six multiplies), ``nomul`` (the same predicate from
   absolute values and compares) and ``swar`` (two queens per int32 lane as
   biased 16-bit halves, the 7-relation equality form).  The number of
   independent accumulator chains ``k`` sets the exposed ILP; the saturated
   rate is the median at the largest k.
2. **int32 multiply against add** (:func:`_op_rate`, kernel C).
3. **One-hot scoring on the tensor cores** (:func:`mxu_onehot_rate`): one
   line family's candidate counts as a bf16 contraction against one-hot
   encodings that must be rebuilt every step, against the direct compare.

Then the issue bound: this card's SM count, 64 int32 lanes per SM and the
SM clock ``nvidia-smi`` reports during the run, against the rate implied by
the fitted b and the port's own kernel's count of int32 ops per attack test.

Rates are in ns per 1024 evaluations (per 1024 ops for kernel C), so they
read against the JAX tool's per-VREG numbers.  Writes
``artifacts/h100/probe_full3d_alternatives.json``; reads b from
``artifacts/h100/probe_full3d_cap.json`` (``--cap``), never the TPU's file.

Usage:  python -m mcqueens_torch.tools.probe_full3d_alternatives [--quick]
            [--json out.json] [--cap cap.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mcqueens_torch import tools
from mcqueens_torch.kernels import full3d_shared, probes

# int32 ops of one (queen, target) attack test in the port's shared-site
# kernel (csrc/full3d_shared.cu: attacks() plus the occupancy bit and the
# accumulate), the count chip_smoke.py's bound of that kernel uses.
FULL3D_OPS_PER_TEST = 22
# Per chain and queen, one 8-step mover chunk scores 8 candidates and the
# mover's old cell.
TESTS_PER_QUEEN_STEP = 9 / 8
# Queens one evaluation tests.
PER_QUEEN = {"production": 1, "nomul": 1, "swar": 2}


def _rows(value: int, width: int, dev) -> torch.Tensor:
    return torch.full((tools.ALU_ROWS, width), value, dtype=torch.int32,
                      device=dev)


def _test_rate(kind: str, n_iter: int = 2048, reps: int = 4, k: int = 4, *,
               width: int | None = None, device="cuda"):
    """Per-rep ns per 1024 evaluations of one attack test (kernel B).

    The input is ``(8, width)`` int32 filled with 70, as the JAX tool's
    ``(8, 1024)``; ``width`` defaults to :data:`tools.ALU_WIDTH` columns,
    which fills the card (every element computes the same function).
    """
    dev = tools.device(device)
    x = _rows(70, width or tools.ALU_WIDTH, dev)

    def run():
        return probes.attack_test(x, kind, n_iter=n_iter, k=k)

    run()
    evals = n_iter * k * probes._test_u(k) * x.numel() / 1024
    return [tools.elapsed_s(run, dev) / evals * 1e9 for _ in range(reps)]


def _op_rate(op: str, n_iter: int = 4096, reps: int = 4, k: int = 16, *,
             width: int | None = None, device="cuda"):
    """ns per 1024 int32 ops (``add`` or ``mul``, each with its ``| 1``),
    k independent chains (kernel C) over ``(8, width)`` filled with 3."""
    dev = tools.device(device)
    x = _rows(3, width or tools.ALU_WIDTH, dev)
    u = 8

    def run():
        return probes.op_chain(x, op, n_iter=n_iter, k=k, u=u)

    run()
    dt = tools.elapsed_s(run, dev, reps=reps)
    # 2 ops per unroll element (op + or)
    return dt / (n_iter * k * u * 2 * x.numel() / 1024) * 1e9


def mxu_onehot_rate(Q: int = 256, C: int = 2048, L: int = 32, reps: int = 8,
                    *, device="cuda"):
    """One line family's candidate scoring: one-hot rebuild + bf16
    contraction against the direct compare.  Returns (direct_us,
    onehot_us) per step."""
    dev = tools.device(device)
    lines = torch.as_tensor(np.random.default_rng(0).integers(0, L, (Q, C)),
                            dtype=torch.int32, device=dev)
    cand = torch.as_tensor(np.random.default_rng(1).integers(0, L, (C,)),
                           dtype=torch.int32, device=dev)
    ar = torch.arange(L, dtype=torch.int32, device=dev)

    def direct():
        return (lines == cand[None, :]).to(torch.int32).sum(0)

    def onehot():
        # the per-step one-hot rebuild no scatter-free design can avoid
        oh = (lines[:, :, None] == ar).to(torch.bfloat16)     # (Q, C, L)
        ohc = (cand[:, None] == ar).to(torch.bfloat16)        # (C, L)
        return torch.einsum("qcl,cl->c", oh, ohc)

    out = {}
    for name, fn in (("direct", direct), ("onehot", onehot)):
        fn()
        out[name] = tools.elapsed_s(fn, dev, reps=reps) * 1e6
    return out["direct"], out["onehot"]


def issue_bound(out: dict, dev, cap_path) -> None:
    """The issue-bound section of ``out``: this card's int32 rate against
    the one implied by the fitted b (read from ``cap_path``).  The rate is
    given for the ALU pipe's 64 int32 lanes per SM and for the issue limit
    of both int32 pipes (ALU and FMA, 128 lanes), which kernel C's add + or
    chains exceed the first of."""
    props = torch.cuda.get_device_properties(dev)
    mhz = float(tools.nvidia_smi("clocks.sm").split()[0])
    lanes = {"alu_pipe": tools.INT32_LANES_PER_SM,
             "both_pipes": tools.INT32_ISSUE_LANES_PER_SM}
    rates = {k: props.multi_processor_count * v * mhz * 1e6
             for k, v in lanes.items()}
    out["int32_issue_bound"] = {
        "sms": props.multi_processor_count, "int32_lanes_per_sm": lanes,
        "sm_clock_mhz_during_run": mhz, "ops_per_s": rates,
        "ns_per_1024_ops": {k: 1024 / r * 1e9 for k, r in rates.items()}}
    ops = (FULL3D_OPS_PER_TEST * TESTS_PER_QUEEN_STEP
           * full3d_shared.DEFAULT_BLOCK)
    out["sweep_int32_ops_per_queen_block_step"] = ops
    cap_path = tools.input_path(cap_path)
    if not cap_path.exists():
        out["fitted_b_us_per_queen"] = f"not measured (no {cap_path})"
        return
    fit = json.loads(cap_path.read_text())["fit"]
    b = fit["b_us_per_queen"]
    out["fitted_b_us_per_queen"] = b
    out["fitted_b_source"] = tools.shown(cap_path)
    out["harness_replay_over_fitted"] = (
        out["harness_replay_b_us_per_queen"] / b)
    out["implied_sustained_int32_ops_per_s"] = ops / (b * 1e-6)
    out["sweep_fraction_of_issue_bound"] = {
        k: ops / (b * 1e-6) / r for k, r in rates.items()}
    band = fit.get("b_us_per_queen_band")
    if band:
        out["sweep_fraction_of_issue_bound_band"] = {
            k: sorted(ops / (v * 1e-6) / r for v in band)
            for k, r in rates.items()}
    # The cost per queen changes with Q: the same ratios per Q range, from
    # the slope between neighbouring points of the fit.
    slopes = fit.get("segment_slopes_us_per_queen", {})
    out["by_q_range"] = {
        seg: {"b_us_per_queen": v,
              "harness_replay_over_slope":
                  out["harness_replay_b_us_per_queen"] / v,
              "sweep_fraction_of_issue_bound": {
                  k: ops / (v * 1e-6) / r for k, r in rates.items()}}
        for seg, v in slopes.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=str(tools.H100_ARTIFACTS
                                          / "probe_full3d_alternatives.json"))
    ap.add_argument("--cap", default=str(tools.H100_ARTIFACTS
                                         / "probe_full3d_cap.json"),
                    help="probe_full3d_cap's JSON on this card (b)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    tools.output_path(args.json)
    dev = tools.device(args.device)

    n_iter = 256 if args.quick else 2048
    out = {**tools.card(dev), "width": tools.ALU_WIDTH, "n_iter": n_iter}

    # Sweep exposed ILP until the rate saturates; each (kind, k) point is
    # timed ``reps`` times and summarised as min/median/max; the saturated
    # rate is the median at the largest k.
    reps = 3 if args.quick else 7
    ks = (4, 16) if args.quick else (2, 4, 8, 16, 32)
    out["reps_per_ilp_point"] = reps
    for kind in probes.TEST_KINDS:
        per_q = {k: [v / PER_QUEEN[kind] for v in
                     _test_rate(kind, n_iter=n_iter, k=k, reps=reps,
                                device=dev)]
                 for k in ks}
        out[f"{kind}_ns_per_1024_queens_by_ilp"] = {
            str(k): {"min": min(v), "median": float(np.median(v)),
                     "max": max(v)} for k, v in per_q.items()}
        medians = {k: float(np.median(v)) for k, v in per_q.items()}
        out[f"{kind}_test_ns_per_1024_queens"] = medians[max(ks)]
        viol = [f"k={a}->k={b}: {medians[a]:.4f} -> {medians[b]:.4f}"
                for a, b in zip(ks, ks[1:])
                if medians[b] > medians[a] * 1.05
                and medians[b] > min(per_q[a]) * 1.05]
        out[f"{kind}_ilp_monotonic"] = not viol
        if viol:
            out[f"{kind}_ilp_monotonicity_violations"] = viol
        print(f"{kind}: {medians[max(ks)]:.4f} ns per 1024 queens at "
              f"k={max(ks)}", flush=True)
    prod_ns = out["production_test_ns_per_1024_queens"]
    out["swar_vs_production"] = out["swar_test_ns_per_1024_queens"] / prod_ns
    out["nomul_vs_production"] = (out["nomul_test_ns_per_1024_queens"]
                                  / prod_ns)

    out["int32_add_ns_per_1024_ops"] = _op_rate("add", device=dev)
    out["int32_mul_ns_per_1024_ops"] = _op_rate("mul", device=dev)
    out["mul_vs_add"] = (out["int32_mul_ns_per_1024_ops"]
                         / out["int32_add_ns_per_1024_ops"])

    # Harness-replay b: per step the fused sweep scores 9 targets per 8
    # steps against every queen, over a DEFAULT_BLOCK-chain block.
    out["harness_replay_b_us_per_queen"] = (
        prod_ns * TESTS_PER_QUEEN_STEP * full3d_shared.DEFAULT_BLOCK / 1024
        / 1e3)
    if dev.type == "cuda":
        issue_bound(out, dev, args.cap)
    else:
        out["int32_issue_bound"] = "not measured (no card)"

    d_us, o_us = mxu_onehot_rate(Q=64 if args.quick else 256, C=2048, L=32,
                                 device=dev)
    out["onehot_direct_us_per_family_step"] = d_us
    out["onehot_onehot_us_per_family_step"] = o_us
    out["onehot_slowdown"] = o_us / d_us

    print(json.dumps(out, indent=1))
    tools.write_json(args.json, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
