#!/usr/bin/env python
"""The packed (SWAR) attack test inside the production sweep's structure,
port of ``tools/probe_swar_sweep.py``.

Both attack tests run inside a harness with the structure of the
shared-site full-3D kernel's fused pass (``kernels/csrc/full3d_shared.cu``):
per chunk, 9 hash-varied targets (8 candidates and the mover's old cell)
scored against every row of the resident coordinate planes, one
accumulator per target, each target's column sum folded into carried rows
(kernel D, ``kernels/csrc/probe_attack.cu``).  It reports the chunk time
and the time per queen-step of a ``DEFAULT_BLOCK``-column block for each.

* ``production``: (QS, C) int32 coordinate planes, the live two-test form
  ``a2*(a2-m)`` per axis, occupancy at bit 16 of one accumulator.
* ``swar``: (QS/2, C) planes, two queens per lane as biased 16-bit halves
  (field = coord + 64 - cand); the 7-relation equality form, occupancy in a
  second accumulator per target.

Calibration: the harness's production variant should land near the fitted
production coefficient b of ``probe_full3d_cap`` on this card
(``artifacts/h100/probe_full3d_cap.json``, or ``--cap``).

Usage:  python -m mcqueens_torch.tools.probe_swar_sweep [--quick]
            [--json out.json] [--cap cap.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mcqueens_torch import tools
from mcqueens_torch.kernels import full3d_shared, probes
from mcqueens_torch.kernels.probes import prod_scores, swar_scores  # noqa: F401

HOLD = 8  # steps per chunk: one chunk is 8 steps of the sweep's O(Q) work


def sweep_planes(kind: str, Q: int, C: int):
    """The JAX tool's three ``(QS, C)`` int32 planes from ``seed 0``:
    coordinates in [0, 16), or for ``swar`` two per lane as biased halves
    (coord + 64 per 16-bit field), ``QS = Q // 2``."""
    rng = np.random.default_rng(0)
    if kind == "swar":
        def packed():
            c = rng.integers(0, 16, size=(Q // 2, 2, C)).astype(np.int64) + 64
            return (c[:, 0] | (c[:, 1] << 16)).astype(np.int32)
        return [packed() for _ in range(3)]
    return [rng.integers(0, 16, size=(Q, C)).astype(np.int32)
            for _ in range(3)]


def _sweep_time(kind: str, Q: int, C: int = 2048, n_chunks: int = 512,
                reps: int = 5, *, width: int | None = None, device="cuda"):
    """Seconds per rep of ``n_chunks`` production-shaped chunk sweeps.

    The planes are the JAX tool's ``(QS, C)`` ones tiled to ``width``
    columns (a multiple of ``C``; by default the least one of at least
    :data:`tools.SWEEP_WIDTH`, which fills the card), so every column
    computes what the JAX tool's column ``c % C`` computes.
    """
    dev = tools.device(device)
    if width is None:
        width = C * -(-tools.SWEEP_WIDTH // C)
    if width % C:
        raise ValueError(f"width {width} is not a multiple of C={C}")
    args = [torch.from_numpy(np.tile(p, (1, width // C))).to(dev)
            for p in sweep_planes(kind, Q, C)]

    def run():
        return probes.sweep(*args, kind, n_chunks=n_chunks)

    run()
    return [tools.elapsed_s(run, dev) for _ in range(reps)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=str(tools.H100_ARTIFACTS
                                          / "probe_swar_sweep.json"))
    ap.add_argument("--cap", default=str(tools.H100_ARTIFACTS
                                         / "probe_full3d_cap.json"),
                    help="probe_full3d_cap's JSON on this card (b)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    tools.output_path(args.json)
    dev = tools.device(args.device)

    C = 2048
    width = C * -(-tools.SWEEP_WIDTH // C)
    block = full3d_shared.DEFAULT_BLOCK
    n_chunks = 64 if args.quick else 512
    reps = 3 if args.quick else 7
    out = {**tools.card(dev), "n_chunks": n_chunks, "reps": reps,
           "width": width, "chains_per_block": block,
           "structure": "9 targets x QS rows per chunk, one thread per "
                        "column (csrc/full3d_shared.cu's fused pass)"}

    for Q in ((144, 256) if not args.quick else (256,)):
        row = {}
        for kind in probes.SWEEP_KINDS:
            times = _sweep_time(kind, Q, C, n_chunks=n_chunks, reps=reps,
                                width=width, device=dev)
            per_chunk_us = [t / n_chunks * 1e6 for t in times]
            # per queen-step of one block-wide share of the launch
            per_queen_step_ns = [u * 1e3 / (HOLD * Q) * block / width
                                 for u in per_chunk_us]
            row[kind] = {
                "chunk_us": {"min": min(per_chunk_us),
                             "median": float(np.median(per_chunk_us)),
                             "max": max(per_chunk_us)},
                "b_ns_per_queen_step": {
                    "min": min(per_queen_step_ns),
                    "median": float(np.median(per_queen_step_ns)),
                    "max": max(per_queen_step_ns)},
            }
        prod_b = row["production"]["b_ns_per_queen_step"]["median"]
        swar_b = row["swar"]["b_ns_per_queen_step"]["median"]
        row["swar_vs_production"] = swar_b / prod_b
        out[f"Q{Q}"] = row
        print(f"Q={Q}: production b={prod_b:.6f} ns/queen-step, swar "
              f"b={swar_b:.6f} ns/queen-step, ratio "
              f"{row['swar_vs_production']:.4f}", flush=True)

    # Calibration against the fitted production coefficient on this card
    # (us/queen = ns/queen-step / 1e3).
    cap = tools.input_path(args.cap)
    if cap.exists():
        fit = json.loads(cap.read_text())["fit"]
        fitted = fit["b_us_per_queen"]
        harness = out["Q256"]["production"]["b_ns_per_queen_step"]["median"]
        out["fitted_b_us_per_queen"] = fitted
        out["fitted_b_source"] = tools.shown(cap)
        out["harness_production_over_fitted"] = harness / 1e3 / fitted
        # per Q range of the fit: its cost per queen grows with Q
        out["harness_production_over_slope_by_q_range"] = {
            seg: harness / 1e3 / v for seg, v in
            fit.get("segment_slopes_us_per_queen", {}).items()}
    else:
        out["fitted_b_us_per_queen"] = f"not measured (no {cap})"

    print(json.dumps(out, indent=1))
    tools.write_json(args.json, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
