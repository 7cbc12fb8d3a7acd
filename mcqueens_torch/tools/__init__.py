"""Measurement tools of the port, ports of the JAX package's ``tools/``:

  * :mod:`.roofline`: memory bandwidth, launch overhead, an in-place column
    add, the int32 add rate (kernel A) and moves/s of every sampler;
  * :mod:`.probe_full3d_cap`: t(Q) = a + b·Q of the full-3D shared-site
    kernel;
  * :mod:`.probe_full3d_alternatives`: the attack test's three forms
    (kernel B), int32 multiply against add (kernel C), one-hot scoring;
  * :mod:`.probe_swar_sweep`: both attack tests inside the production
    sweep's structure (kernel D);
  * :mod:`.probe_gather`: the dynamic gather's forms and costs, and an int32
    add pass (``kernels/probes_mem.py``);
  * :mod:`.probe_slice`: dynamic row slices, pass costs, a row reduction
    and the port's PRNG draws (``kernels/probes_mem.py``).

Each runs on the card unless given ``--device cpu`` (the kernels' plain
twins; no number of such a run is a device measurement) and writes its
JSON under ``artifacts/h100/``, with the card's name and power limit.

The campaign tools, ports of the tools that produced the certificates and
floors in ``artifacts/``:

  * :mod:`.verify_board`: re-score exported boards with a straight-loop
    oracle;
  * :mod:`.qmax`, :mod:`.qmax_frontier`, :mod:`.qmax_push`,
    :mod:`.qmax_campaign`: Q_max(N, 3) certificates, under
    ``artifacts/h100/qmax/``;
  * :mod:`.full3d_floors_campaign`: the tempered floors protocol, under
    ``artifacts/h100/full3d_floors/`` and ``artifacts/h100/board_floors/``.

The TPU's measurements in ``artifacts/`` are never read or written, at any
depth; board files given to a tool as a warm start or to re-score may come
from anywhere.  This module holds what the tools share: timing, the card's
description and the output paths.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
H100_ARTIFACTS = REPO / "artifacts" / "h100"
_TPU_ARTIFACTS = REPO / "artifacts"

# The probes' default timing widths: eight times 132 SMs x 32 warps x 32
# lanes of threads, so the card runs at least 32 warps per SM and the last
# wave of blocks is a small share of the launch whatever number of blocks
# a kernel's registers let reside on an SM.
TIMING_THREADS = 8 * 132 * 32 * 32
ALU_ROWS = 8  # the TPU probes' (8, C) rows
# Hopper SM: int32 work runs on two pipes of 64 lanes each, the ALU pipe
# (IADD3, LOP3, ISETP, ...) and the FMA pipe (IMAD, which ptxas also uses for
# adds), and its four schedulers issue one warp instruction (32 lanes) each
# per clock: 128 int32 lanes in all when both pipes are busy.
INT32_LANES_PER_SM = 64
INT32_ISSUE_LANES_PER_SM = 2 * INT32_LANES_PER_SM
ALU_WIDTH = TIMING_THREADS // ALU_ROWS
SWEEP_WIDTH = TIMING_THREADS
# Words a one-pass probe (a gather, a slice copy) moves at its card-filling
# shape: 16 per timing thread, 69 MB an array, past the 50 MB L2, so the
# launch is a small share of the time.
ONE_PASS_WORDS = 16 * TIMING_THREADS


def device(name) -> torch.device:
    """``cpu`` or ``cuda``; a CUDA device must exist (no fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def elapsed_s(fn, dev: torch.device, reps: int = 1) -> float:
    """Seconds per call of ``fn`` over ``reps`` calls: CUDA events on the
    card, the host clock on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def probe(results: dict, name: str, fn) -> None:
    """One probe of the gather and slice tools, as their JAX tools' ``probe``
    runs it: print ``PROBE <name>: OK <result>  [<s>s]`` or ``FAIL
    <error>``, and record it in ``results[name]``.  ``fn`` returns its
    result text, or (text, a dict of numbers)."""
    t0 = time.time()
    try:
        out = fn()
        text, numbers = out if isinstance(out, tuple) else (out, {})
        dt = time.time() - t0
        print(f"PROBE {name}: OK {text}  [{dt:.1f}s]", flush=True)
        results[name] = {"status": "OK", "result": text, "seconds": dt,
                         **numbers}
    except Exception as e:  # noqa: BLE001
        dt = time.time() - t0
        msg = " | ".join(str(e).split("\n")[:3])[:300]
        print(f"PROBE {name}: FAIL {type(e).__name__}: {msg}  [{dt:.1f}s]",
              flush=True)
        results[name] = {"status": "FAIL",
                         "result": f"{type(e).__name__}: {msg}",
                         "seconds": dt}


def ns_per_1024(seconds: float, words: int) -> float:
    """Nanoseconds per 1024 words (the TPU tools' per-VREG unit)."""
    return seconds * 1e9 / (words / 1024)


def nvidia_smi(query: str) -> str:
    """One line of ``nvidia-smi --query-gpu=<query> --format=csv,noheader``
    for the first card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card(dev: torch.device) -> dict:
    """What a result ran on: the device, and for the card its name and
    ``nvidia-smi``'s name and power limit."""
    if dev.type != "cuda":
        return {"device": "cpu", "card": None,
                "nvidia_smi_name_power_limit": "not measured"}
    return {"device": "cuda", "card": torch.cuda.get_device_name(dev),
            "nvidia_smi_name_power_limit": nvidia_smi("name,power.limit")}


def output_path(path) -> Path:
    """``path`` as a Path, refused if it lies anywhere under the TPU's
    ``artifacts/`` directory, at any depth, other than under
    ``artifacts/h100/`` (the port's results; the campaign tools' roots are
    its ``qmax/``, ``full3d_floors/`` and ``board_floors/``)."""
    p = Path(path)
    full = p.resolve()
    if (full.is_relative_to(_TPU_ARTIFACTS.resolve())
            and not full.is_relative_to(H100_ARTIFACTS.resolve())):
        raise ValueError(f"{p}: artifacts/ holds the TPU's results; the "
                         f"port reads and writes under {H100_ARTIFACTS}")
    return p


input_path = output_path  # the same rule for the measurements a tool reads


def shown(path) -> str:
    """``path`` relative to the checkout where it lies inside it."""
    p = Path(path).resolve()
    return str(p.relative_to(REPO)) if p.is_relative_to(REPO) else str(p)


def write_json(path, out: dict) -> None:
    p = output_path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {shown(p)}")
