"""One run of one benchmark cell of ``mcqueens_torch`` on the card(s).

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration is ``benchmark/configs/<config>.json``,
whose sampler ``family`` names its reference ``benchmark/reference/
<family>.py`` and work count ``benchmark/work/<family>.py``; its searches
are ``benchmark/workloads/<cell>.json``, whose ``search`` names its kind
``benchmark/kinds/<search>.py``; each metric is read by ``benchmark/
metrics/<reader>.py`` (:func:`reader`).  All are found by name.

Set-up (``setup_s``, from the process's start): the imports, a CUDA
context on each card, one warm-up search of the cell's widths cut to
``warmup_segments`` launches (it builds or loads the kernel library,
``build/mcqueens_torch/`` in the checkout).  Then the window: whole
searches, one after another, until ``--seconds`` have passed; it runs from
the first call to the last return.  With ``--trace 1`` the window runs
under ``torch.profiler`` and the run reports the per-layer metrics instead
of the end-to-end ones.  After the window one search, drawn from the seed,
is checked against the reference (:mod:`benchmark.check`); the last line
of standard output is one JSON object: ``correct``, ``attempted``
(searches), ``failed`` (1 if the checked search was wrong), ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit, which also end standard error.

No card, or fewer than the cell asks for: exit 3 and no result.  ``jax``,
``jaxlib``, ``flax`` or ``mcqueens`` loaded once the window has closed:
exit 4 and no result.
"""

from __future__ import annotations

import time

_IMPORTED = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mcqueens")


def process_start() -> float:
    """The wall-clock time this process started (Linux ``/proc``; the
    import of this module elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


def load_cell(root: Path, name: str):
    """``(manifest, Cell)`` of cell ``name`` under checkout ``root``."""
    from benchmark.searches import Cell

    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; "
                         f"known: {sorted(cells)}")
    w = cells[name]
    here = root / HERE.name
    config = json.loads((here / "configs" / f"{w['config']}.json")
                        .read_text())
    workload = json.loads((here / "workloads" / f"{name}.json").read_text())
    return manifest, Cell.load(here, name, config, workload, int(w["chips"]))


def metrics_of(manifest: dict, cell: str, kind: str):
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports."""
    return [m for m in manifest[kind]
            if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class RunInfo:
    """What a metric reader reads: the run's clocks and counts, and the
    trace of a traced run."""

    setup_s: float
    window_s: float           # host clock, first call to last return
    proposals: int            # chains x steps of every search returned
    least_s: float            # least card time of their sampler launches,
                              # summed over the cards
    cards: tuple              # card indices the run used
    sampler: tuple            # name parts of the sampler kernels
    trace: object = None      # benchmark.trace.Trace of a traced run


def least_seconds(cell) -> float:
    """Least card time of one search's sampler launches, over its cards
    (``work/<family>.py`` counts a launch)."""
    from benchmark import peaks
    from benchmark.searches import n_bins

    chains = -(-cell.config["chains"] // cell.shards)
    nb = n_bins(cell.config["n_steps"])
    return cell.shards * sum(
        peaks.least_seconds(*cell.work.launch(cell.config, chains, n, nb))
        for n in cell.launches())


def reader(metric: str) -> str:
    """The reader of a metric: ``metrics/<name>.py``, by the part of its
    name before the first dot (``moves_per_s.board`` and
    ``moves_per_s.full3d`` are both read by ``metrics/moves_per_s.py``;
    the part after it names the cells that share a bound)."""
    return metric.split(".", 1)[0]


def guard() -> list:
    """Top-level names of forbidden modules loaded in this process."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(root: Path, manifest: dict, cell, seed: int, seconds: float,
        trace: bool, device: str = "cuda", t_start: float | None = None):
    """One run of ``cell``; returns the result object (or raises)."""
    import torch

    from benchmark import check, searches
    from benchmark import trace as trace_mod

    t_start = process_start() if t_start is None else t_start
    cards = tuple(range(cell.chips)) if device == "cuda" else (0,)
    if device == "cuda":
        for c in cards:
            torch.empty(1, device=f"cuda:{c}")
    searcher = searches.Searcher(cell, device)
    chains = cell.config["chains"]
    searcher(searches.base_seed(seed, -1, chains),
             n_steps=cell.stride * cell.workload.get("warmup_segments", 1))
    if device == "cuda":
        for c in cards:
            torch.cuda.synchronize(c)
            torch.cuda.reset_peak_memory_stats(c)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    span = (torch.profiler.record_function if trace
            else lambda name: contextlib.nullcontext())
    # The search that is checked: drawn from the seed among the first few,
    # the last one if the window ends before it.  Only its result is held;
    # the others are dropped as a caller's loop drops them (holding every
    # result made later searches of a window slower).
    keep = check.drawn_search(seed)
    held, returns = None, []
    t_window = time.time()
    with span(trace_mod.WINDOW):
        t0 = time.perf_counter()
        while True:
            base = searches.base_seed(seed, len(returns), chains)
            with span(trace_mod.SEARCH):
                result = searcher(base)
            if held is None or held[0] < keep:
                held = (len(returns), base, result)
            del result
            returns.append(time.perf_counter() - t0)
            if returns[-1] >= seconds:
                break
        window_s = returns[-1]
    peak = (max(torch.cuda.max_memory_allocated(c) for c in cards)
            if device == "cuda" else 0)
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
        t_read = time.perf_counter()
        tr = trace_mod.from_profiler(prof)
        del prof
        print(f"benchmark: {tr.events} profiler events read in "
              f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    del searcher
    if device == "cuda":
        torch.cuda.empty_cache()

    info = RunInfo(
        setup_s=t_window - t_start, window_s=window_s,
        proposals=cell.proposals * len(returns),
        least_s=least_seconds(cell) * len(returns), cards=cards,
        sampler=tuple(cell.config["sampler_kernels"]), trace=tr)
    metrics = {}
    for m in metrics_of(manifest, cell.name,
                        "per_layer" if trace else "end_to_end"):
        v = searches.load_module(
            root / HERE.name / "metrics" / f"{reader(m['name'])}.py"
        ).read(info)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    checks, notes = check.run_checks(
        cell.spec(), held[1], held[2], seed,
        cell.workload.get("check_chains", 4), device)
    notes["search"] = held[0]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": len(cards), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(returns),
           "failed": int(not correct),
           "metrics": metrics, "device": dev}
    if tr is not None:
        busy = [trace_mod.union(tr.device.get(c, []), *tr.window) * 1e-6
                for c in cards]
        dev["busy_s"] = sum(busy) / len(busy)
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": trace_mod.top_device_ops(tr),
                            "idle_gaps": trace_mod.idle_by_host(tr)}
    out["search_s"] = [b - a for a, b in zip([0.0] + returns, returns)]
    if tr is not None:
        out["search_busy_s"] = [
            sum(trace_mod.union(tr.device.get(c, []), lo, hi)
                for c in cards) * 1e-6 for lo, hi in tr.searches]
    out["check_notes"] = notes
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    manifest, cell = load_cell(root, args.workload)

    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device (torch.cuda.is_available() is "
              "False); the benchmark runs only on the card", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    out = run(root, manifest, cell, args.seed, args.seconds,
              bool(args.trace), "cuda", t_start)
    loaded = guard()
    if loaded:
        print(f"benchmark: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
