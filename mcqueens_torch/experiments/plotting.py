"""Figure and CSV sinks, port of :mod:`mcqueens.experiments.plotting`.

The same files with the same names, columns and values:
  * energy-history figure (mean +/- std band per label, log-y) with
    ``results/{label}.csv`` (step, mean_energy, std_energy);
  * binned acceptance-rate figure with
    ``results/acceptance_rates_{label}.csv`` (bin_center, acceptance_rate);
  * the two-N side-by-side energy comparison;
  * min-energy-vs-N and steps-to-best-vs-N figures with per-init CSVs.

All sinks are rooted at ``outdir``.  ``matplotlib`` (Agg backend) and
``pandas`` are imported by the functions that draw and write, so the drivers
import on a machine without them.
"""

from __future__ import annotations

import os

import numpy as np

from mcqueens_torch.chain import stats

COLOR_CYCLE = [
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
]


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _write_csv(columns: dict, outdir, name) -> None:
    import pandas as pd

    d = os.path.join(outdir, "results")
    os.makedirs(d, exist_ok=True)
    pd.DataFrame(columns).to_csv(os.path.join(d, name), index=False)


def _save(fig, fig_path, outdir) -> None:
    """Save ``fig`` under ``outdir`` (or show it when no path is given)."""
    plt = _pyplot()
    if fig_path is None:
        plt.show()
        return
    full = os.path.join(outdir, fig_path)
    if os.path.dirname(full):
        os.makedirs(os.path.dirname(full), exist_ok=True)
    fig.savefig(full, bbox_inches="tight", dpi=150)
    plt.close(fig)


def plot_energy_histories(histories_by_label, steps_by_label, title,
                          out_path=None, outdir=".", lens_by_label=None):
    """Mean +/- std energy curves per label (log-y) + per-label CSVs.

    ``histories_by_label``: {label: (R, P)}; ``steps_by_label``: {label:
    (P,)}; ``lens_by_label``: optional {label: (R,) history lengths}, so
    early-stopped runs contribute only their own prefix.
    """
    plt = _pyplot()
    fig = plt.figure(figsize=(12, 7))
    for idx, (label, hist) in enumerate(histories_by_label.items()):
        lens = None if lens_by_label is None else lens_by_label.get(label)
        mean, std = stats.energy_curve_stats(hist, lens)
        steps = np.asarray(steps_by_label[label])[: len(mean)]
        color = COLOR_CYCLE[idx % len(COLOR_CYCLE)]
        _write_csv({"step": steps, "mean_energy": mean, "std_energy": std},
                   outdir, f"{label}.csv")
        plt.plot(steps, mean, linewidth=2.5, label=label, color=color)
        plt.fill_between(steps, mean - std, mean + std, alpha=0.25,
                         color=color)
    plt.xlabel("Step", fontsize=20)
    plt.ylabel("Energy", fontsize=20)
    plt.title(title, fontsize=18, fontweight="bold")
    plt.yscale("log")
    plt.grid(True, alpha=0.3, linestyle="--", linewidth=0.5)
    plt.legend(fontsize=12, framealpha=0.9, loc="best")
    plt.xlim(left=0)
    plt.tight_layout()
    _save(fig, out_path, outdir)


def plot_acceptance_rates_binned(bins_by_label, n_steps, title=None,
                                 out_path=None, outdir="."):
    """Pooled per-bin acceptance-rate curves per label + CSVs.

    ``bins_by_label``: {label: (accept_bins (R, B), total_bins (R, B))}.
    """
    plt = _pyplot()
    fig = plt.figure(figsize=(12, 7))
    for idx, (label, (acc, tot)) in enumerate(bins_by_label.items()):
        n_bins = np.asarray(acc).shape[1]
        rate = stats.acceptance_rate_bins(acc, tot)
        centers = stats.bin_centers(n_steps, n_bins)
        _write_csv({"bin_center": centers, "acceptance_rate": rate}, outdir,
                   f"acceptance_rates_{label}.csv")
        valid = ~np.isnan(rate)
        plt.plot(centers[valid], rate[valid], linewidth=2.5, label=label,
                 color=COLOR_CYCLE[idx % len(COLOR_CYCLE)])
    plt.xlabel("Step", fontsize=20)
    plt.ylabel("Acceptance Rate", fontsize=20)
    if title:
        plt.title(title, fontsize=18, fontweight="bold")
    plt.grid(True, alpha=0.3, linestyle="--", linewidth=0.5)
    plt.legend(fontsize=12, framealpha=0.9, loc="best")
    plt.xlim(left=0)
    plt.tight_layout()
    _save(fig, out_path, outdir)


def plot_energy_histories_side_by_side(
    histories_n1, steps_n1, histories_n2, steps_n2, n1, n2, title,
    out_path=None, outdir=".", schedule_labels=None,
    annealing_type=None, init_mode=None, lens_n1=None, lens_n2=None,
):
    """Two-panel (N1 | N2) mean +/- std energy comparison; annealing_type
    and init_mode are folded into the title."""
    plt = _pyplot()
    if schedule_labels is None:
        schedule_labels = list(histories_n1.keys())
    if annealing_type or init_mode:
        extras = ", ".join(
            str(x) for x in (annealing_type, init_mode) if x is not None)
        title = f"{title} ({extras})" if extras else title

    fig, axes = plt.subplots(1, 2, figsize=(12, 7))
    for ax, hists, steps_axis, lens_axis, n in (
        (axes[0], histories_n1, steps_n1, lens_n1, n1),
        (axes[1], histories_n2, steps_n2, lens_n2, n2),
    ):
        for idx, label in enumerate(schedule_labels):
            if label not in hists:
                continue
            lens = None if lens_axis is None else lens_axis.get(label)
            mean, std = stats.energy_curve_stats(hists[label], lens)
            steps = np.asarray(steps_axis[label])[: len(mean)]
            color = COLOR_CYCLE[idx % len(COLOR_CYCLE)]
            ax.plot(steps, mean, linewidth=2.5, label=label, color=color)
            ax.fill_between(steps, np.maximum(mean - std, 1e-10), mean + std,
                            alpha=0.25, color=color)
        ax.set_xlabel("Step", fontsize=20)
        ax.set_ylabel("Energy", fontsize=20)
        ax.set_title(f"N={n}", fontsize=18, fontweight="bold")
        ax.set_yscale("log")
        ax.grid(True, alpha=0.3, linestyle="--", linewidth=0.5)
        ax.legend(fontsize=12, framealpha=0.9, loc="best")
    fig.suptitle(title, fontsize=20, fontweight="bold", y=1.02)
    plt.tight_layout()
    _save(fig, out_path, outdir)


def plot_min_energy_vs_n(ns, results_by_init, out_path=None, outdir="."):
    """Min-energy-vs-N and steps-to-best-vs-N figures + per-init CSVs.

    ``results_by_init``: {init_mode: the mean/std arrays of
    ``drivers.measure_min_energy_vs_n``}.  The second figure goes to
    ``<out_path stem>_convergence<ext>``.
    """
    plt = _pyplot()
    ns_arr = np.asarray(ns)
    init_modes = list(results_by_init.keys())
    colors = plt.cm.tab10(np.linspace(0, 1, len(init_modes)))
    conv_path = None
    if out_path is not None:
        base, ext = os.path.splitext(out_path)
        conv_path = base + "_convergence" + (ext if ext else ".png")
    for stat, col, csv, ylabel, title, path in (
        ("min_energies", "min_energy", "min_energy_vs_N",
         "Minimal energy reached", "MCMC: Minimal Energy vs. Board Size N",
         out_path),
        ("steps_to_best", "steps_to_best", "steps_to_best_vs_N",
         "Steps to best energy",
         "MCMC: Steps to Best Energy vs. Board Size N", conv_path),
    ):
        fig = plt.figure(figsize=(10, 6))
        for idx, init_mode in enumerate(init_modes):
            r = results_by_init[init_mode]
            mean, std = r[f"mean_{stat}"], r[f"std_{stat}"]
            _write_csv({"N": ns_arr, f"{init_mode}_mean_{col}": mean,
                        f"{init_mode}_std_{col}": std},
                       outdir, f"{csv}_{init_mode}.csv")
            plt.plot(ns_arr, mean, "o-", linewidth=2, markersize=6,
                     color=colors[idx], label=init_mode)
            plt.fill_between(ns_arr, mean - std, mean + std, alpha=0.2,
                             color=colors[idx])
        plt.xlabel("Board size N", fontsize=20)
        plt.ylabel(ylabel, fontsize=20)
        plt.title(title, fontsize=18, fontweight="bold")
        plt.grid(True, alpha=0.3)
        plt.legend(fontsize=12)
        _save(fig, path, outdir)
