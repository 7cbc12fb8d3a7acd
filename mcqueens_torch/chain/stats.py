"""Run statistics for the plots and CSVs, copied from
:mod:`mcqueens.chain.stats` (plain numpy, no device code):

  * mean +/- std energy curves over runs,
  * pooled per-bin acceptance rates with NaN for empty bins,
  * best-energy / steps-to-best summaries.
"""

from __future__ import annotations

import numpy as np


def energy_curve_stats(histories, lens=None):
    """(R, P) energy histories -> (mean, std) over runs (population std).

    With ``lens`` (per-run history lengths, ``ChainResult.history_len``)
    each run contributes only its first ``lens[r]`` points (an early-stopped
    run's history ends, it does not repeat its frozen value), and the curves
    end at ``max(lens)``.
    """
    h = np.asarray(histories, dtype=np.float64)
    if lens is None:
        return h.mean(axis=0), h.std(axis=0)
    lens = np.asarray(lens, dtype=np.int64)
    p_max = int(lens.max())
    h = h[:, :p_max]
    alive = np.arange(p_max)[None, :] < lens[:, None]  # (R, <=P)
    count = alive.sum(axis=0)  # >= 1 everywhere: the longest run spans p_max
    mean = np.where(alive, h, 0.0).sum(axis=0) / count
    var = np.where(alive, (h - mean) ** 2, 0.0).sum(axis=0) / count
    return mean, np.sqrt(var)


def acceptance_rate_bins(accept_bins, total_bins):
    """Pooled acceptance rate per bin over all runs; NaN where no proposals.

    accept_bins/total_bins: (R, n_bins) int arrays.
    """
    acc = np.asarray(accept_bins, dtype=np.int64).sum(axis=0)
    tot = np.asarray(total_bins, dtype=np.int64).sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        rate = np.where(tot > 0, acc / np.maximum(tot, 1), np.nan)
    return rate


def bin_centers(n_steps: int, n_bins: int = 100):
    """Bin centers: midpoints of ``linspace(0, n_steps, n_bins + 1)``."""
    edges = np.linspace(0, n_steps, n_bins + 1)
    return (edges[:-1] + edges[1:]) / 2


def summarize_best(best_energies, steps_to_best):
    """Mean/std of best energies and steps-to-best across runs."""
    be = np.asarray(best_energies, dtype=np.float64)
    sb = np.asarray(steps_to_best, dtype=np.float64)
    return {
        "mean_min_energy": be.mean(),
        "std_min_energy": be.std(),
        "mean_steps_to_best": sb.mean(),
        "std_steps_to_best": sb.std(),
    }
