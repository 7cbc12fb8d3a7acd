"""Experiment drivers, port of :mod:`mcqueens.experiments.drivers`.

The four reference experiment types, each run as batches of chains on one
device through :func:`mcqueens_torch.dist.runner.run_experiment`, with the
JAX package's seed derivations exactly:

  * ``single_N``: one board size, one schedule or a schedule comparison;
  * ``beta_start_end_pairs``: pair ``idx`` runs from ``base_seed + 1000 *
    idx``;
  * ``compare_beta_end``: the pair sweep at two N, the second from
    ``base_seed + 10000``;
  * ``measure_min_energy_vs_N``: cell ``(idx, init_mode)`` runs from
    ``base_seed + 10 * idx + sum(ord(c) for c in init_mode) % 1000``.

``device`` ("cuda" unless the caller asks for "cpu") goes to every run.
With ``tpu.checkpoint_dir`` every cell saves its run there under its own
tag and a rerun resumes it.
:mod:`mcqueens_torch.experiments.plotting` is imported only where a figure
is drawn; ``plot=False`` (every driver, :func:`run_from_config` included)
draws none, for hosts without matplotlib.
"""

from __future__ import annotations

import numpy as np

from mcqueens_torch.core import schedules as sched_mod
from mcqueens_torch.dist import runner
from mcqueens_torch.experiments.config import Config, TpuConfig
from mcqueens_torch.utils.checkpoint import Checkpointer


def _run(tpu, N, n_steps, init_mode, schedule, n_runs, base_seed,
         mcmc_type, early_stop_patience, verbose, device):
    """One batched experiment with the tpu-section knobs applied."""
    checkpointer = None
    if tpu.checkpoint_dir:
        # one checkpoint per sweep cell: resumable sweeps never collide
        tag = f"{mcmc_type}_N{N}_{init_mode}_{schedule.kind}_s{base_seed}"
        checkpointer = Checkpointer(tpu.checkpoint_dir, tag=tag)
    return runner.run_experiment(
        N=N, n_steps=n_steps, init_mode=init_mode, schedule=schedule,
        n_runs=n_runs, base_seed=base_seed, device=device,
        mcmc_type=mcmc_type, early_stop_patience=early_stop_patience,
        verbose=verbose, history_stride=tpu.history_stride,
        kernel=tpu.kernel, n_bins=tpu.n_bins, checkpointer=checkpointer)


def run_single_n(cfg: Config, outdir: str = ".", *, device="cuda",
                 plot: bool = True):
    """single_N: one board size; a list-valued schedule type compares the
    schedules, all from the same base seed."""
    if plot:
        from mcqueens_torch.experiments import plotting

    N = cfg.section("single_N")["N"]
    sched_cfg = cfg.sched_cfg
    sched_type = sched_cfg["type"]

    if isinstance(sched_type, list):
        schedules = sched_mod.schedules_from_types(sched_type, sched_cfg,
                                                   cfg.n_steps)
        histories, steps, lens, bests = {}, {}, {}, {}
        for schedule, base_seed in schedules:
            res = _run(cfg.tpu, N, cfg.n_steps, cfg.init_mode, schedule,
                       cfg.n_runs, base_seed, cfg.mcmc_type,
                       cfg.early_stop_patience, cfg.verbose, device)
            histories[schedule.label] = res.energy_history
            steps[schedule.label] = res.history_steps
            lens[schedule.label] = res.history_len
            bests[schedule.label] = res.best_energy
            if cfg.verbose:
                for e in res.best_energy:
                    print(e)
        if plot:
            title = f"Energy History (N={N}, {len(schedules)} schedules)"
            plotting.plot_energy_histories(histories, steps, title,
                                           out_path=cfg.output_path,
                                           outdir=outdir, lens_by_label=lens)
        return {"all_histories": histories, "all_best_energies": bests}

    schedule, base_seed = sched_mod.schedule_from_common(cfg.common,
                                                         cfg.n_steps)
    res = _run(cfg.tpu, N, cfg.n_steps, cfg.init_mode, schedule, cfg.n_runs,
               base_seed, cfg.mcmc_type, cfg.early_stop_patience,
               cfg.verbose, device)
    if cfg.verbose:
        for e in res.best_energy:
            print(e)
    if plot:
        title = f"Energy History (N={N}, {schedule.desc})"
        plotting.plot_energy_histories(
            {"Schedule": res.energy_history}, {"Schedule": res.history_steps},
            title, out_path=cfg.output_path, outdir=outdir,
            lens_by_label={"Schedule": res.history_len})
    return {
        "all_histories": {"Schedule": res.energy_history},
        "all_best_energies": {"Schedule": res.best_energy},
        "result": res,
    }


def run_beta_start_end_pairs(
    N, n_steps, beta_start_ends, annealing_type="linear_annealing",
    init_mode="random", n_runs=5, base_seed=0, verbose=True, plot=True,
    out_path=None, out_path_acceptance=None, mcmc_type="board",
    early_stop_patience=100000, tpu=None, outdir=".", *, device="cuda",
):
    """Sweep (beta_start, beta_end) pairs at a fixed annealing type."""
    tpu = tpu or TpuConfig()
    histories, steps, lens, bests, bins = {}, {}, {}, {}, {}
    for idx, (beta_start, beta_end) in enumerate(beta_start_ends):
        schedule = sched_mod.build_schedule(
            annealing_type, n_steps, beta_start=beta_start, beta_end=beta_end)
        res = _run(tpu, N, n_steps, init_mode, schedule, n_runs,
                   base_seed + idx * 1000, mcmc_type, early_stop_patience,
                   verbose, device)
        label = f"beta: {beta_start}->{beta_end}"
        histories[label] = res.energy_history
        steps[label] = res.history_steps
        lens[label] = res.history_len
        bests[label] = res.best_energy
        bins[label] = (res.accept_bins, res.total_bins)
        if verbose:
            for e in res.best_energy:
                print(e)
            print(np.mean(res.best_energy))

    if plot:
        from mcqueens_torch.experiments import plotting

        title = (f"Energy History for Different beta Ranges "
                 f"(N={N}, {annealing_type}, init_mode={init_mode})")
        plotting.plot_energy_histories(histories, steps, title,
                                       out_path=out_path, outdir=outdir,
                                       lens_by_label=lens)
        if out_path_acceptance is not None:
            title_acc = (f"Acceptance Rate for Different beta Ranges "
                         f"(N={N}, {annealing_type}, init_mode={init_mode})")
            plotting.plot_acceptance_rates_binned(
                bins, n_steps, title=title_acc,
                out_path=out_path_acceptance, outdir=outdir)
    return {
        "all_histories": histories,
        "all_history_steps": steps,
        "all_history_lens": lens,
        "all_best_energies": bests,
        "all_bins": bins,
    }


def run_compare_beta_end(
    Ns, n_steps, beta_start_ends, annealing_type="linear_annealing",
    init_mode="random", n_runs=5, base_seed=0, verbose=True, plot=True,
    out_path=None, mcmc_type="board", early_stop_patience=100000,
    tpu=None, outdir=".", *, device="cuda",
):
    """The pair sweep at two board sizes, plotted side by side."""
    if len(Ns) != 2:
        raise ValueError("Ns must contain exactly 2 values")
    n1, n2 = Ns
    common = dict(
        n_steps=n_steps, beta_start_ends=beta_start_ends,
        annealing_type=annealing_type, init_mode=init_mode, n_runs=n_runs,
        verbose=verbose, plot=False, mcmc_type=mcmc_type,
        early_stop_patience=early_stop_patience, tpu=tpu, outdir=outdir,
        device=device)
    res1 = run_beta_start_end_pairs(N=n1, base_seed=base_seed, **common)
    res2 = run_beta_start_end_pairs(N=n2, base_seed=base_seed + 10000,
                                    **common)

    if plot:
        from mcqueens_torch.experiments import plotting

        plotting.plot_energy_histories_side_by_side(
            res1["all_histories"], res1["all_history_steps"],
            res2["all_histories"], res2["all_history_steps"],
            n1, n2, title="Energy History Comparison", out_path=out_path,
            outdir=outdir, schedule_labels=list(res1["all_histories"]),
            annealing_type=annealing_type, init_mode=init_mode,
            lens_n1=res1["all_history_lens"],
            lens_n2=res2["all_history_lens"])
    return {"N1": n1, "N2": n2, "result_N1": res1, "result_N2": res2}


def measure_min_energy_vs_n(
    Ns, n_steps, schedule, init_modes=("random",), n_runs=5, base_seed=100,
    verbose=True, plot=True, out_path=None, mcmc_type="board",
    early_stop_patience=100000, tpu=None, outdir=".", *, device="cuda",
):
    """Sweep board sizes x init modes; collect best energies and steps to
    best."""
    tpu = tpu or TpuConfig()
    if isinstance(init_modes, str):
        init_modes = [init_modes]

    results = {}
    for init_mode in init_modes:
        init_offset = sum(ord(c) for c in init_mode) % 1000
        mins_mean, mins_std, all_mins = [], [], []
        steps_mean, steps_std, all_steps = [], [], []
        for idx, N in enumerate(Ns):
            res = _run(tpu, N, n_steps, init_mode, schedule, n_runs,
                       base_seed + 10 * idx + init_offset, mcmc_type,
                       early_stop_patience, verbose, device)
            all_mins.append(res.best_energy)
            mins_mean.append(res.best_energy.mean())
            mins_std.append(res.best_energy.std())
            all_steps.append(res.steps_to_best)
            steps_mean.append(res.steps_to_best.mean())
            steps_std.append(res.steps_to_best.std())
            if verbose:
                print(mins_mean[-1])
        results[init_mode] = {
            "mean_min_energies": np.asarray(mins_mean),
            "std_min_energies": np.asarray(mins_std),
            "all_min_energies": all_mins,
            "mean_steps_to_best": np.asarray(steps_mean),
            "std_steps_to_best": np.asarray(steps_std),
            "all_steps_to_best": all_steps,
        }

    if plot:
        from mcqueens_torch.experiments import plotting

        plotting.plot_min_energy_vs_n(Ns, results, out_path=out_path,
                                      outdir=outdir)
    return {"Ns": Ns, "results": results}


def run_from_config(cfg: Config, outdir: str = ".", *, device="cuda",
                    plot: bool = True):
    """Dispatch on the config's experiment_type."""
    et = cfg.experiment_type
    if et == "single_N":
        return run_single_n(cfg, outdir=outdir, device=device, plot=plot)

    knobs = dict(
        n_steps=cfg.n_steps, init_mode=cfg.init_mode, n_runs=cfg.n_runs,
        verbose=cfg.verbose, plot=plot, mcmc_type=cfg.mcmc_type,
        early_stop_patience=cfg.early_stop_patience, tpu=cfg.tpu,
        outdir=outdir, device=device)
    if et == "measure_min_energy_vs_N":
        params = cfg.section("measure_min_energy_vs_N")
        schedule, base_seed = sched_mod.schedule_from_common(cfg.common,
                                                             cfg.n_steps)
        knobs.pop("init_mode")
        result = measure_min_energy_vs_n(
            Ns=params["Ns"], schedule=schedule,
            init_modes=params.get("init_modes", [cfg.init_mode]),
            base_seed=base_seed, out_path=cfg.output_path, **knobs)
        if cfg.verbose:
            for init_mode in result["results"]:
                for m in result["results"][init_mode]["mean_min_energies"]:
                    print(m)
        return result

    base_seed = cfg.sched_cfg.get("base_seed", 0)
    if et == "beta_start_end_pairs":
        params = cfg.section("beta_start_end_pairs")
        result = run_beta_start_end_pairs(
            N=params["N"], beta_start_ends=params["beta_start_ends"],
            annealing_type=params.get("annealing_type", "linear_annealing"),
            base_seed=base_seed,
            out_path=params.get("output_path", cfg.output_path),
            out_path_acceptance=params.get("output_path_acceptance"),
            **knobs)
        if cfg.verbose:
            for bests in result["all_best_energies"].values():
                print(np.mean(bests))
        return result

    if et == "compare_beta_end":
        params = cfg.section("compare_beta_end")
        result = run_compare_beta_end(
            Ns=params["Ns"], beta_start_ends=params["beta_start_ends"],
            annealing_type=params.get("annealing_type", "linear_annealing"),
            base_seed=base_seed,
            out_path=params.get(
                "output_path", "figures/energy_history_compare_beta_end.png"),
            **knobs)
        if cfg.verbose:
            for res in (result["result_N1"], result["result_N2"]):
                for bests in res["all_best_energies"].values():
                    print(np.mean(bests))
        return result

    raise ValueError(f"Unknown experiment_type: {et}")
