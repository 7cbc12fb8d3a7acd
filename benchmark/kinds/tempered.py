"""Tempered searches (``"search": "tempered"``): a geometric ladder of
``ladder_levels`` betas from the configuration's ``beta_start`` to its
``beta_end``, an exchange after every launch, :func:`run_tempered` as the
competition CLI's ``--tempering`` calls it (a constant schedule of 1 that
each chain's ladder beta scales).

:mod:`benchmark.searches` calls :func:`search`; :mod:`benchmark.check`
asks a kind for its whole-batch numbers (:func:`claims`), the betas of the
chains it walks again (:func:`chain_betas`) and what a search reports of a
chain beside its energies and states (``REPORTED``).
"""

from __future__ import annotations

import numpy as np

from benchmark.check import field
from benchmark.reference import chains as R
from benchmark.reference import exchange as X
from benchmark.searches import n_bins

# A tempered search reports no per-chain bins or best step.
REPORTED = {}


def _ladder(spec):
    return X.ladder(spec.config["beta_start"], spec.config["beta_end"],
                    spec.workload["ladder_levels"])


def search(cell, device: str, mesh, base: int, n_steps: int):
    """One tempered search of ``n_steps`` steps from base seed ``base``:
    chains ``base + 0 ..``, swap seed ``base``."""
    from mcqueens_torch.chain.spec import ChainSpec
    from mcqueens_torch.core.schedules import build_schedule
    from mcqueens_torch.search import tempering

    c = cell.config
    spec = ChainSpec(
        N=c["N"], n_steps=n_steps,
        schedule=build_schedule("constant", n_steps, beta_const=1.0),
        init_mode=c["init_mode"], mcmc_type=c["mcmc_type"],
        history_stride=cell.stride, kernel=c["kernel"], Q=c["Q"],
        n_bins=n_bins(n_steps))
    ladder = tempering.geometric_ladder(
        c["beta_start"], c["beta_end"], cell.workload["ladder_levels"])
    return tempering.run_tempered(
        base + np.arange(c["chains"], dtype=np.uint32), spec, ladder,
        device=device, swap_seed=base, mesh=mesh)


def claims(spec, base: int, result, history) -> dict:
    """``proposals``: how far the reported total is from chains x steps;
    ``exchange``: ladder groups whose final betas are not those worked out
    from the reported energies, or not a permutation of the ladder;
    ``ambiguous``: the (G,) groups whose exchanges were ambiguous, left
    out of ``exchange`` and of the chains walked again."""
    lad = _ladder(spec)
    L = lad.shape[0]
    fin, _, amb = X.betas_by_round(history, lad, base)
    got = np.asarray(field(result, "betas"), np.float32)
    G = spec.chains // L
    g_got = got[:G * L].reshape(G, L)
    wrong = (g_got != fin[:G * L].reshape(G, L)).any(1) & ~amb
    wrong |= (np.sort(g_got, 1) != np.sort(lad)[None, :]).any(1)
    return {"proposals": abs(int(field(result, "proposals"))
                             - spec.chains * spec.n_steps),
            "exchange": int(wrong.sum()), "ambiguous": amb}


def chain_betas(spec, base: int, history, chains):
    """(float32 beta of every step for each of ``chains``: its ladder beta
    of each launch, worked out from the reported energies; their final
    betas)."""
    fin, kept, _ = X.betas_by_round(history, _ladder(spec), base, chains)
    one = R.schedule_betas("constant", spec.n_steps, {"beta_const": 1.0})
    betas = [(one * np.repeat(kept[:, n], spec.stride)[:spec.n_steps])
             .astype(np.float32) for n in range(len(chains))]
    return betas, fin[list(chains)]
