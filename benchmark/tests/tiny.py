"""A checkout with small cells beside the real ones, for runs on the CPU.

:func:`checkout` copies ``BENCHMARK.json`` and the benchmark's folder into
a temporary directory and adds, as a later change would, configurations
``tiny_board`` (N=6) and ``tiny_3d`` (N=5, Q=20) of 4096 chains, and one
cell of each of the real cells' workloads on them.
A run there drives the program's plain-torch twins on the CPU.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

TINY = {
    "tiny_board": ("board_n16", dict(N=6, chains=4096, n_steps=1024,
                                      history_stride=128)),
    "tiny_3d": ("full3d_n15q225", dict(N=5, Q=20, chains=4096,
                                       n_steps=1000, history_stride=125)),
}
# tiny cell -> (the real cell whose workload it copies, chips)
CELLS = {
    "tiny_board.anneal": ("board_n16.anneal", 1),
    "tiny_board.tempered": ("board_n16.tempered", 1),
    "tiny_3d.floors": ("full3d_n15q225.floors", 1),
    "tiny_3d.floors_x4": ("full3d_n15q225.floors_x4", 4),
}


def add_cell(root: Path, name: str, config: str, workload: dict,
             like: str, chips: int = 1) -> None:
    """Add cell ``name`` to the checkout at ``root``: its workload file and
    its entry in ``BENCHMARK.json``, reporting the metrics of cell
    ``like``, and nothing else."""
    (root / "benchmark" / "workloads" / f"{name}.json").write_text(
        json.dumps(workload))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({
        "name": name, "config": config, "traffic": name.split(".", 1)[1],
        "chips": chips, "why": "a small cell for the CPU tests"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


def checkout(tmp: Path) -> Path:
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root)
    configs = root / "benchmark" / "configs"
    for name, (real, changes) in TINY.items():
        cfg = json.loads((configs / f"{real}.json").read_text())
        cfg.update(name=name, **changes)
        (configs / f"{name}.json").write_text(json.dumps(cfg))
    for name, (real, chips) in CELLS.items():
        workload = json.loads(
            (root / "benchmark" / "workloads" / f"{real}.json").read_text())
        workload["warmup_segments"] = 1
        add_cell(root, name, name.split(".")[0], workload, real, chips)
    return root


def run(root: Path, cell: str, seed: int = 2 ** 31 + 7, trace=False,
        seconds: float = 0.0):
    """One run of ``cell`` in the checkout at ``root`` on the CPU."""
    from benchmark import run as run_mod

    manifest, c = run_mod.load_cell(root, cell)
    return run_mod.run(root, manifest, c, seed, seconds, trace,
                       device="cpu")
