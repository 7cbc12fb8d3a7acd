"""Anneal searches (``"search": "anneal"``): a linear beta schedule from
the configuration's ``beta_start`` to its ``beta_end`` over a search's
steps, :func:`run_experiment` as the competition CLI calls it.

:mod:`benchmark.searches` calls :func:`search`; :mod:`benchmark.check`
asks a kind for its whole-batch numbers (:func:`claims`), the betas of the
chains it walks again (:func:`chain_betas`) and what a search reports of a
chain beside its energies and states (``REPORTED``).
"""

from __future__ import annotations

import numpy as np

from benchmark.check import field
from benchmark.reference import chains as R
from benchmark.searches import n_bins

# The walk's key -> the result's field, beside energies and states.
REPORTED = {"best_step": "steps_to_best", "accept_bins": "accept_bins",
            "total_bins": "total_bins"}


def search(cell, device: str, mesh, base: int, n_steps: int):
    """One anneal of ``n_steps`` steps from base seed ``base``."""
    from mcqueens_torch.core.schedules import build_schedule
    from mcqueens_torch.dist import runner

    c = cell.config
    schedule = build_schedule("linear_annealing", n_steps,
                              beta_start=c["beta_start"],
                              beta_end=c["beta_end"])
    return runner.run_experiment(
        N=c["N"], n_steps=n_steps, init_mode=c["init_mode"],
        schedule=schedule, n_runs=c["chains"], base_seed=base,
        device=device, mcmc_type=c["mcmc_type"],
        early_stop_patience=c.get("early_stop_patience"), verbose=False,
        history_stride=cell.stride, kernel=c["kernel"],
        n_bins=n_bins(n_steps), Q=c["Q"], mesh=mesh)


def claims(spec, base: int, result, history) -> dict:
    """``proposals``: chains whose proposals in some bin are not the
    spec's steps there."""
    want = np.diff(np.asarray(R.bin_starts(spec.n_steps, spec.n_bins)))
    got = np.asarray(field(result, "total_bins"))
    return {"proposals": int((got != want[None, :]).any(1).sum())}


def chain_betas(spec, base: int, history, chains):
    """(float32 beta of every step for each of ``chains``, None: an
    anneal reports no betas)."""
    b = R.schedule_betas("linear_annealing", spec.n_steps,
                         {"beta_start": spec.config["beta_start"],
                          "beta_end": spec.config["beta_end"]})
    return [b] * len(chains), None
