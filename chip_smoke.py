#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``mcqueens_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and the script
exits non-zero without printing a result:

1. device: CUDA must be available (no CPU fallback); prints the card,
   ``nvidia-smi``'s name and power limit, and the torch/CUDA versions.
2. build: compiles ``mcqueens_torch/kernels/csrc/board_shared.cu`` with nvcc.
3. kernel vs twin: one chunk through the CUDA kernel and one through its
   plain-torch twin (``segment_reference``), both on the card from the same
   ``init_carry_batch`` state and betas; every carry field (the energy is
   the chunk's history point) must be equal (``torch.equal``, tolerance
   none), and each side is timed alone.  Shapes: the main path's
   chunk (N=16, 32768 chains, 48 steps), N=16 at 4096 chains (two blocks)
   for 2048 steps, N=5 with patience early-stop, N=11 klarner at beta=100
   (energies stay 0), and a chunk starting past step 2^24 (float32 step
   rounding in beta).
4. the slice end to end: ``mcqueens_torch.cli.competition.main`` at N=16,
   32768 runs, 50000 steps; the exported board is re-scored with the
   oracle, and the kernel's launch count must equal the chunks run.
5. throughput: proposed moves/s at ``bench.py``'s configuration (N=16,
   linear 1->5 over 2^24 steps, 32768-step chunks) at 32768 and 4096 chains.

Then one JSON line describing the kernels, the ``nvidia-smi`` name/power
line, and last ``{"ok": true, "device": {...}}``.
"""

import sys

_PRELOADED = set(sys.modules)

import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mcqueens_torch.chain.spec import ChainSpec  # noqa: E402
from mcqueens_torch.cli import competition  # noqa: E402
from mcqueens_torch.core.energy import board_energy  # noqa: E402
from mcqueens_torch.core.schedules import build_schedule  # noqa: E402
from mcqueens_torch.dist.runner import plan_segments  # noqa: E402
from mcqueens_torch.kernels import _build, board_shared  # noqa: E402
from mcqueens_torch.kernels.carry import FIELDS  # noqa: E402

KERNEL_SOURCE = "mcqueens_torch/kernels/csrc/board_shared.cu"
KERNEL_REPLACES = "mcqueens/kernels/board_shared.py:176"


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def spec_of(N, n_steps, stride, schedule, **kw):
    return ChainSpec(N=N, n_steps=n_steps, schedule=schedule,
                     kernel="pallas_shared", history_stride=stride, **kw)


def cuda_ms(fn, reps=1):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_case(name, spec, n_chains, start_outer=0, seed0=0):
    """One chunk through the kernel and through the twin, on the card, from
    one ``init_carry_batch`` state and one beta tensor; returns
    (max_abs_err, kernel_ms, twin_ms, the kernel's final carry)."""
    seeds = seed0 + np.arange(n_chains, dtype=np.uint32)
    carry = board_shared.init_carry_batch(seeds, spec, device="cuda")
    step0, n_inner = start_outer * spec.history_stride, spec.history_stride
    beta = board_shared.chunk_betas(spec, step0, n_inner, carry.device)
    k_st = board_shared.segment_state(carry)
    t_st = board_shared.segment_state(carry)
    kernel_ms = cuda_ms(lambda: board_shared.segment_cuda(
        k_st, step0, n_inner, spec, beta))
    twin_ms = cuda_ms(lambda: board_shared.segment_reference(
        t_st, step0, n_inner, spec, beta))
    # The energy after the chunk is the chunk's history point, so the carry
    # fields cover the history too.
    kc, tc = board_shared.carry_of(k_st), board_shared.carry_of(t_st)
    err = 0
    for field in FIELDS:
        a, b = getattr(kc, field), getattr(tc, field)
        if not torch.equal(a, b):
            err = max(err, int((a.long() - b.long()).abs().max()))
            phase("compare", f"{name}: field {field} differs "
                  f"({int((a != b).sum())} entries)")
    if err:
        raise AssertionError(f"kernel != twin on {name}: max abs err {err}")
    props = int(kc.total_bins.sum()) - int(carry.total_bins.sum())
    phase("compare", f"{name}: kernel == twin on all {len(FIELDS)} carry "
          f"fields; {props} proposals; kernel {kernel_ms:.3f} ms, twin "
          f"{twin_ms:.1f} ms")
    return err, kernel_ms, twin_ms, kc


def main():
    # 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA GPU (no CPU fallback)")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    phase("device", f"{kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    # 2. build ------------------------------------------------------------
    existed = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log = _build.library_path().with_suffix(".log")
    ptxas = [ln.strip() for ln in (log.read_text().splitlines()
                                   if log.exists() else [])
             if "registers" in ln or "spill" in ln]
    phase("build", f"{'loaded existing' if existed else 'nvcc built'} "
          f"{_build.library_path().name} in {build_s:.2f} s; "
          + " | ".join(ptxas))

    # 3. kernel vs twin ---------------------------------------------------
    lin = build_schedule("linear_annealing", 2048, beta_start=1.0,
                         beta_end=5.0)
    cases = [
        ("main-path chunk N=16 C=32768 48 steps",
         spec_of(16, 50000, 48, build_schedule(
             "linear_annealing", 50000, beta_start=1.0, beta_end=3.0)),
         32768, 0, 42),
        ("N=16 C=4096 2048 steps", spec_of(16, 2048, 2048, lin), 4096, 0, 0),
        ("N=5 patience 40 beta=50", spec_of(
            5, 600, 600, build_schedule("constant", 600, beta_const=50.0),
            early_stop_patience=40), 1024, 0, 3),
        ("N=11 klarner beta=100", spec_of(
            11, 256, 256, build_schedule("constant", 256, beta_const=100.0),
            init_mode="klarner"), 256, 0, 0),
        ("N=16 C=4096 step0 > 2^24", spec_of(
            16, 2 ** 25, 1024, build_schedule(
                "linear_annealing", 2 ** 25, beta_start=1.0, beta_end=5.0),
            n_bins=50), 4096, 16387, 0),
    ]
    max_err, kernel_ms, twin_ms = 0, None, None
    for name, spec, n_chains, start_outer, seed0 in cases:
        err, k_ms, t_ms, kc = compare_case(name, spec, n_chains, start_outer,
                                           seed0)
        max_err = max(max_err, err)
        if name.startswith("N=16 C=4096 2048"):
            kernel_ms, twin_ms = k_ms, t_ms
        if "patience" in name:
            stopped = int((kc.stop_step < spec.n_steps).sum())
            if stopped == 0:
                raise AssertionError("no chain early-stopped")
            phase("compare", f"{name}: {stopped}/{n_chains} chains stopped")
        if "klarner" in name:
            if int(kc.energy.abs().max()) or int(kc.best_energy.abs().max()):
                raise AssertionError("klarner energies left 0")
    step0 = 16387 * 1024
    if float(np.float32(step0 + 1)) == step0 + 1:
        raise AssertionError("the >2^24 case does not exercise rounding")

    # 4. the slice end to end ---------------------------------------------
    n_runs, n_steps = 32768, 50000
    stride = max(1, n_steps // 1024)
    n_segs, seg_outer = plan_segments(-(-n_steps // stride), n_runs, stride,
                                      min_segments=10)
    with tempfile.TemporaryDirectory() as outdir:
        buf = io.StringIO()
        board_shared.KERNEL_LAUNCHES = 0
        with contextlib.redirect_stdout(buf):
            rc = competition.main([
                "--kernel", "pallas_shared", "--n", "16", "--n-runs",
                str(n_runs), "--n-steps", str(n_steps), "--device", "cuda",
                "--outdir", outdir])
        launches = board_shared.KERNEL_LAUNCHES
        text = buf.getvalue()
        (path,) = [os.path.join(root, f) for root, _, files in
                   os.walk(outdir) for f in files]
        best = np.zeros((16, 16), np.int64)
        with open(path) as f:
            for line in f:
                i, j, k = map(int, line.split(","))
                best[i, j] = k
    if rc != 0:
        raise AssertionError(f"competition.main returned {rc}")
    reported = int(re.search(r"Best energies: \[(-?\d+)", text).group(1))
    rescored = int(board_energy(torch.from_numpy(best)))
    rate = re.search(r"= ([0-9.e+]+) moves/s", text).group(1)
    if rescored != reported:
        raise AssertionError(f"exported board scores {rescored}, CLI "
                             f"reported {reported}")
    if launches != n_segs * seg_outer:
        raise AssertionError(f"{launches} kernel launches, expected "
                             f"{n_segs * seg_outer}")
    phase("slice", f"competition N=16 runs={n_runs} steps={n_steps} "
          f"stride={stride}: best energy {reported} (oracle re-score "
          f"{rescored}); {launches} kernel launches; {rate} moves/s "
          f"reported by the CLI")

    # 5. throughput at bench.py's configuration ---------------------------
    horizon, seg_steps = 2 ** 24, 32768
    bench_spec = spec_of(16, horizon, seg_steps, build_schedule(
        "linear_annealing", horizon, beta_start=1.0, beta_end=5.0))
    rates = {}
    for chains in (32768, 4096):
        carry = board_shared.init_carry_batch(
            np.arange(chains, dtype=np.uint32), bench_spec, device="cuda")
        carry, _ = board_shared.run_segment(carry, 0, bench_spec, 1)
        torch.cuda.synchronize()
        seg, t0 = 1, time.perf_counter()
        while True:
            carry, _ = board_shared.run_segment(carry, seg, bench_spec, 1)
            seg += 1
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            if elapsed >= 3.0:
                break
        rates[chains] = (seg - 1) * seg_steps * chains / elapsed
        st = board_shared.segment_state(carry)
        beta = board_shared.chunk_betas(bench_spec, seg * seg_steps,
                                        seg_steps, st.energy.device)
        k_ms = cuda_ms(lambda: board_shared.segment_cuda(
            st, seg * seg_steps, seg_steps, bench_spec, beta))
        phase("throughput", f"N=16 chains={chains}: {rates[chains]:.4e} "
              f"proposed moves/s over {seg - 1} x {seg_steps}-step "
              f"run_segment calls ({elapsed:.2f} s); kernel alone "
              f"{k_ms:.1f} ms per {seg_steps}-step chunk = "
              f"{seg_steps * chains / k_ms * 1e3:.4e} moves/s")
    phase("throughput", "nvidia-smi clocks.sm,power.draw,temperature.gpu: "
          + nvidia_smi("clocks.sm,power.draw,temperature.gpu"))

    leaked = sorted(m for m in set(sys.modules) - _PRELOADED
                    if m == "jax" or m.startswith(("jax.", "mcqueens.")))
    if leaked:
        raise AssertionError(f"the port imported {leaked}")

    print(json.dumps({"kernels": [{
        "name": "board_shared_kernel",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
