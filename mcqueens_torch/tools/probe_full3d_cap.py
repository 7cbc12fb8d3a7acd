#!/usr/bin/env python
"""The operation that caps full-3D throughput, port of
``tools/probe_full3d_cap.py``.

Every exact full-3D Metropolis step must know how many queens attack the
proposed cell; the shared-site kernel (``kernels/csrc/full3d_shared.cu``)
gets it from one O(Q) pass over the queen coordinate planes per 8-step
mover chunk.  This probe times that production kernel at several queen
counts Q (same N, chains and segment) and fits

    block-step time  t(Q) = a + b * Q

where a block is ``DEFAULT_BLOCK`` chains and its step time is the launch
time spread over all blocks (on the card the blocks run side by side).  The
b*Q term is the coordinate pass; the fit prints its share of the step, its
residuals and the slope between neighbouring Q points (on the H100 the cost
per queen grows with Q, so one b does not describe every range).

Usage:  python -m mcqueens_torch.tools.probe_full3d_cap [--json out.json]
            [--quick] [--reps R] [--chains C] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from mcqueens_torch import tools
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core.schedules import build_schedule
from mcqueens_torch.kernels import full3d_shared as mod


def kernel_block_step_us(Q: int, chains: int = 32768, seg: int = 8192,
                         seconds: float = 5.0, *, device="cuda"):
    """(us for one ``DEFAULT_BLOCK``-chain block to advance one step,
    proposed moves/s): N=16, ``seg``-step segments, timed over a
    synchronised window of at least ``seconds``."""
    dev = tools.device(device)
    horizon = 2 ** 24
    spec = ChainSpec(
        N=16, n_steps=horizon, Q=Q,
        schedule=build_schedule("linear_annealing", horizon,
                                beta_start=1.0, beta_end=5.0),
        init_mode="random", mcmc_type="full_3d", kernel="pallas_shared",
        history_stride=seg,
    )
    seeds = np.arange(chains, dtype=np.uint32)
    carry = mod.init_carry_batch(seeds, spec, device=dev)
    carry, _ = mod.run_segment(carry, 0, spec, 1)
    tools.sync(dev)
    t0 = time.perf_counter()
    done, s = 0, 1
    while True:
        carry, _ = mod.run_segment(carry, s, spec, 1)
        s += 1
        done += seg
        tools.sync(dev)
        dt = time.perf_counter() - t0
        if dt >= seconds:
            break
    n_blocks = max(1, chains // mod.DEFAULT_BLOCK)
    return dt / (done * n_blocks) * 1e6, done * chains / dt


def _fit(qs, ts):
    """Least-squares t = a + b*Q."""
    A = np.stack([np.ones(len(qs)), np.asarray(qs, float)], axis=1)
    (a, b), *_ = np.linalg.lstsq(A, np.asarray(ts), rcond=None)
    return float(a), float(b)


def _segments(qs, ts):
    """Slope of t between neighbouring Q points, ``{"q0-q1": us per
    queen}``: where the cost per queen changes with Q, one line's b hides
    it."""
    return {f"{q0}-{q1}": (t1 - t0) / (q1 - q0)
            for q0, q1, t0, t1 in zip(qs, qs[1:], ts, ts[1:])}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--json", default=str(tools.H100_ARTIFACTS
                                              / "probe_full3d_cap.json"))
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--reps", type=int, default=None,
                        help="independent timing windows per Q point "
                             "(default 3, 1 with --quick); the fit reports "
                             "a [min, max]-rep band")
    parser.add_argument("--chains", type=int, default=32768,
                        help="chains per launch (the JAX tool's 32768); "
                             "fewer shrink the planes' footprint")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    tools.output_path(args.json)
    dev = tools.device(args.device)

    qs = [64, 256] if args.quick else [32, 64, 128, 256, 384]
    seconds = 2.0 if args.quick else 5.0
    reps = args.reps if args.reps is not None else (1 if args.quick else 3)
    chains = args.chains
    out = {**tools.card(dev), "N": 16, "chains": chains,
           "block": mod.DEFAULT_BLOCK, "reps_per_point": reps, "points": {}}
    t_med, t_min, t_max = [], [], []
    for Q in qs:
        samples = [kernel_block_step_us(Q, chains, seconds=seconds,
                                        device=dev) for _ in range(reps)]
        uss = [u for u, _ in samples]
        rate = max(r for _, r in samples)
        out["points"][str(Q)] = {
            "block_step_us": float(np.median(uss)),
            "block_step_us_spread": [min(uss), max(uss)],
            "moves_per_s": rate,
        }
        t_med.append(float(np.median(uss)))
        t_min.append(min(uss))
        t_max.append(max(uss))
        print(f"Q={Q}: block-step {np.median(uss):.4f} us "
              f"[{min(uss):.4f}, {max(uss):.4f}] over {reps} reps "
              f"-> {rate:.4e} moves/s", flush=True)
    a, b = _fit(qs, t_med)
    _, b_lo = _fit(qs, t_min)
    _, b_hi = _fit(qs, t_max)
    share_256 = b * 256 / (a + b * 256)
    slopes = _segments(qs, t_med)
    out["fit"] = {"a_us": a, "b_us_per_queen": b,
                  "b_us_per_queen_band": [min(b_lo, b_hi), max(b_lo, b_hi)],
                  "pass_share_at_Q256": share_256,
                  # the band is the spread between reps; these show how far
                  # the points are from one line
                  "residuals_us": {str(q): t - (a + b * q)
                                   for q, t in zip(qs, t_med)},
                  "segment_slopes_us_per_queen": slopes}
    print(f"fit: t(Q) = {a:.4f} + {b:.6f}*Q us (b band "
          f"[{min(b_lo, b_hi):.6f}, {max(b_lo, b_hi):.6f}]); O(Q) pass share "
          f"at Q=256: {share_256:.1%}; slope between neighbouring points: "
          + ", ".join(f"{k} {v:.6f}" for k, v in slopes.items()), flush=True)
    tools.write_json(args.json, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
