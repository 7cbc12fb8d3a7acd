"""Experiment searches (``"search": "experiment"``): the configuration run
as the experiments CLI runs a YAML file, through
:func:`mcqueens_torch.experiments.drivers.run_single_n`, with its mesh and
a checkpoint after every segment.

Each search builds the driver's ``Config`` from the configuration's values
(:func:`config_of`; no YAML is read), with the search's base seed and
``tpu.checkpoint_dir`` set to a fresh directory of its own under the
checkout's ``build/``, removed when the search returns, so that no search
resumes from another's saves (a deployment's directory holds one run's
checkpoint: left in place, a run's saves slowed its later searches by ~3%
on an H100 host whose root filesystem is 9p).  The driver's ``verbose``
output goes to ``log.txt`` in that directory, so that the harness's JSON
stays the last line of standard output.

Durability is checked before the directory goes (:func:`save_faults`): the
search's last save must be that of its last segment, hold every returned
chain's final and best boards and energies, best step, stop step, bins and
energy history, and, where the program counts its saves
(``checkpoint.SAVES``), the search must have saved once a segment.  The
chains it does not hold are added to the ``proposals`` number of
:func:`claims` (the one number of :mod:`benchmark.check` a kind gives), so a
search whose saves are skipped, stale or unwritten is not correct.

:mod:`benchmark.searches` calls :func:`search`; :mod:`benchmark.check`
asks a kind for :func:`claims`, :func:`chain_betas` and ``REPORTED``; the
last two are the anneal kind's (a linear schedule, per-chain bins and best
step).
"""

from __future__ import annotations

import contextlib
import re
import tempfile
from pathlib import Path

import numpy as np

from benchmark.check import field
from benchmark.kinds import anneal
from benchmark.kinds.anneal import REPORTED, chain_betas  # noqa: F401
from benchmark.searches import n_bins

ROOT = Path(__file__).resolve().parents[2]
# A board carry's saved field -> the result's field that returns it.
SAVED = {"heights": "final_state", "best_heights": "best_state",
         "energy": "final_energy", "best_energy": "best_energy",
         "best_step": "steps_to_best", "stop_step": "stop_step",
         "accept_bins": "accept_bins", "total_bins": "total_bins"}
# Base seed of each search this kind ran -> its save_faults (a cell loads
# its kind anew, so each cell has its own).
_FAULTS: dict = {}


def config_of(cell, base: int, n_steps: int, checkpoint_dir: str):
    """The experiments driver's ``Config`` of one search: the
    configuration's values in the YAML schema, through ``parse_config``."""
    from mcqueens_torch.experiments.config import parse_config

    c = cell.config
    return parse_config({
        "experiment_type": c["experiment_type"],
        "common": {
            "n_steps": n_steps, "n_runs": c["chains"],
            "verbose": c["verbose"], "initialization": c["init_mode"],
            "mcmc_type": c["mcmc_type"],
            "early_stop_patience": c["early_stop_patience"],
            "betta_scheduling": {"type": "linear_annealing",
                                 "base_seed": base,
                                 "beta_start": c["beta_start"],
                                 "beta_end": c["beta_end"]}},
        "single_N": {"N": c["N"]},
        "tpu": {"kernel": c["kernel"], "history_stride": cell.stride,
                "n_bins": n_bins(n_steps), "mesh": c["mesh"],
                "checkpoint_dir": checkpoint_dir}})


def save_faults(directory: Path, result, saves) -> int:
    """The chains of ``result`` that the search's last save in
    ``directory`` does not hold: every chain if that save is not the last
    segment's (its segments are not its history chunks, do not cover the
    history, or are not ``saves``, the saves the program counted, where it
    counts them; None where it does not)."""
    hist = np.asarray(field(result, "energy_history"))
    chains, outer = hist.shape[0], hist.shape[1] - 1
    main = list(directory.glob("*.npz"))
    chunk_files = {int(re.search(r"\.hist(\d+)\.npy$", p.name).group(1)): p
                   for p in directory.glob("*.hist*.npy")}
    if len(main) != 1:
        return chains
    with np.load(main[0]) as s:
        segs = int(s["segments_done"])
        if (segs != int(s["n_history_chunks"])
                or segs * int(s["seg_outer"]) < outer
                or saves not in (None, segs)
                or sorted(chunk_files) != list(range(segs))):
            return chains
        bad = np.zeros(chains, bool)
        for name, got in SAVED.items():
            want = np.asarray(field(result, got)).reshape(chains, -1)
            bad |= (s[f"carry_{name}"][:chains].reshape(chains, -1)
                    != want).any(1)
    saved = np.concatenate([np.load(chunk_files[i]) for i in range(segs)])
    bad |= (saved[:outer, :chains].T != hist[:, 1:]).any(1)
    return int(bad.sum())


def search(cell, device: str, mesh, base: int, n_steps: int):
    """One search of ``n_steps`` steps from base seed ``base`` through the
    experiments driver, on ``mesh`` (the harness's mesh of the cell's
    cards) or, without one, on the configuration's; its save is checked
    (:func:`save_faults`) before its directory goes."""
    from mcqueens_torch.experiments import drivers
    from mcqueens_torch.utils import checkpoint

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="bench_ckpt_",
                                     dir=ROOT / "build") as d:
        saves = getattr(checkpoint, "SAVES", None)
        with open(Path(d) / "log.txt", "w") as log, \
                contextlib.redirect_stdout(log):
            result = drivers.run_single_n(
                config_of(cell, base, n_steps, d), device=device, mesh=mesh,
                plot=False)["result"]
        if saves is not None:
            saves = checkpoint.SAVES - saves
        _FAULTS[base] = save_faults(Path(d), result, saves)
    return result


def claims(spec, base: int, result, history) -> dict:
    """``proposals``: the anneal kind's count, plus the chains the
    search's last save did not hold (every chain of a search this kind did
    not run)."""
    out = anneal.claims(spec, base, result, history)
    out["proposals"] += _FAULTS.get(base, spec.chains)
    return out
