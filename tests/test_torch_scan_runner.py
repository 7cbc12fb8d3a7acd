"""Parity of the port's runner, competition CLI and experiments CLI on the
tables/naive scan samplers with the JAX package (CPU).

``run_experiment`` with ``kernel="tables"`` / ``"naive"`` (the seeds become
threefry keys, ten verbose segments), warm starts, the competition CLI with
the JAX default kernel and a ``config.yaml``-shaped sweep through both
experiments CLIs.  Tolerance: none; every ``ChainResult`` field, the exports
and the CSVs are compared bitwise.  The samplers themselves are held to JAX
in ``tests/test_torch_chain.py``.
"""

import contextlib
import glob
import io
import os

import numpy as np
import pytest
import yaml

from mcqueens.cli import competition as jax_competition
from mcqueens.cli import experiments as jax_experiments
from mcqueens.core import schedules as jschedules
from mcqueens.dist import runner as jrunner
from mcqueens_torch.chain import board
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.cli import competition
from mcqueens_torch.cli import experiments
from mcqueens_torch.core import schedules
from mcqueens_torch.dist import runner
from tests.test_torch_chain import (EXP, LIN, RESULT_FIELDS, SEEDS, _specs,
                                    _warm)
from tests.test_torch_foundations import release_jax_executables  # noqa: F401

@pytest.mark.parametrize("mcmc_type,kernel", [
    ("board", "tables"), ("board", "naive"), ("full_3d", "tables"),
    ("full_3d", "naive")])
def test_run_experiment_parity(mcmc_type, kernel, capsys):
    """The runner's seed-to-key path, ten verbose segments and every
    ChainResult field, for both kernels and both state kinds."""
    N, n = (5, 200) if mcmc_type == "board" else (3, 100)
    kw = dict(N=N, n_steps=n, init_mode="random", n_runs=5, base_seed=11,
              mcmc_type=mcmc_type, early_stop_patience=60, verbose=True,
              history_stride=1, kernel=kernel)
    want = jrunner.run_experiment(
        schedule=jschedules.build_schedule(n_steps=n, **EXP), **kw)
    got = runner.run_experiment(
        schedule=schedules.build_schedule(n_steps=n, **EXP),
        device="cpu", **kw)
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
        assert getattr(got, name).dtype == np.asarray(
            getattr(want, name)).dtype, name
    assert got.energy_history.shape == (5, n + 1)
    if mcmc_type == "board":
        assert (got.stop_step < 200).any()


def test_run_chains_warm_start_parity():
    jspec, spec = _specs(dict(N=4, n_steps=100, history_stride=10), LIN,
                         kernel="naive", mcmc_type="full_3d", Q=9)
    starts = _warm(spec, 5)
    want = jrunner.run_chains(SEEDS, jspec, initial_states=starts)
    got = runner.run_chains(SEEDS, spec, device="cpu", initial_states=starts)
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _exported(outdir, N):
    (path,) = glob.glob(os.path.join(outdir, "competition_results",
                                     f"best_heights_{N}_*.txt"))
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("extra", [[], ["--kernel", "naive", "--mcmc-type",
                                        "full_3d", "--q", "13"]])
def test_competition_cli_default_kernel_parity(tmp_path, extra):
    """Both CLIs with the JAX default kernel (tables; stride 1 for <= 64
    runs) and with naive full_3d export the same state and report the same
    energies."""
    N = 5
    argv = ["--n", str(N), "--n-runs", "4", "--n-steps", "150"] + extra
    jout = _cli(jax_competition.main, argv + ["--outdir",
                                              str(tmp_path / "jax")])
    out = _cli(competition.main, argv + ["--device", "cpu", "--outdir",
                                         str(tmp_path / "torch")])
    assert _exported(tmp_path / "torch", N) == _exported(tmp_path / "jax", N)

    def lines(text):
        return [ln for ln in text.splitlines()
                if ln.startswith(("Best energies", "[mcqueens] step"))]

    assert lines(out) == lines(jout)
    assert len([ln for ln in lines(out) if "step" in ln]) == 10


def _config(experiment_type):
    """config.yaml's shape (kernel tables, stride 1, exponential, base seed
    42, patience None), cut to a CPU test's size."""
    return {
        "experiment_type": experiment_type,
        "common": {
            "n_steps": 80, "n_runs": 3, "verbose": False,
            "initialization": "random", "mcmc_type": "board",
            "early_stop_patience": "None",
            "betta_scheduling": {"type": "exponential_annealing",
                                 "base_seed": 42, "beta_const": 5.0,
                                 "beta_start": 1.0, "beta_end": 3.0},
            "output_path": "figures/out.png",
        },
        "single_N": {"N": 4},
        "measure_min_energy_vs_N": {"Ns": [3, 4],
                                    "init_modes": ["random", "klarner"]},
        "beta_start_end_pairs": {
            "N": 4, "beta_start_ends": [[0.5, 3.0], [1.0, 5.0]],
            "annealing_type": "linear_annealing",
            "output_path": "figures/pairs.png",
            "output_path_acceptance": "figures/acc.png"},
        "compare_beta_end": {"Ns": [3, 4], "beta_start_ends": [[1.0, 3.0]],
                             "annealing_type": "exponential_annealing",
                             "output_path": "figures/cmp.png"},
        "tpu": {"kernel": "tables", "history_stride": 1, "n_bins": 100,
                "mesh": False, "checkpoint_dir": None, "profile_dir": None},
    }


@pytest.mark.parametrize("experiment_type", [
    "single_N", "measure_min_energy_vs_N", "beta_start_end_pairs",
    "compare_beta_end"])
def test_experiments_cli_matches_jax(tmp_path, experiment_type):
    """A config.yaml-shaped sweep through both experiments CLIs: every CSV
    equal byte for byte, every figure in both trees."""
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_config(experiment_type)))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_experiments.main(["--config", str(path), "--outdir",
                                 jdir]) == 0
    assert experiments.main(["--config", str(path), "--outdir", tdir,
                             "--device", "cpu"]) == 0

    def files(root, sub):
        d = os.path.join(root, sub)
        return sorted(os.listdir(d)) if os.path.isdir(d) else []

    csvs = files(jdir, "results")
    assert bool(csvs) == (experiment_type != "compare_beta_end")
    assert files(tdir, "results") == csvs
    for name in csvs:
        with open(os.path.join(jdir, "results", name)) as f:
            want = f.read()
        with open(os.path.join(tdir, "results", name)) as f:
            assert f.read() == want, name
    assert files(tdir, "figures") == files(jdir, "figures") != []


def test_repo_config_yaml_parses_to_the_scan_path():
    """The repo's own config.yaml (the experiments CLI's default) now
    selects a ported kernel."""
    from mcqueens_torch.experiments import config

    cfg = config.load_config(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "config.yaml"))
    assert cfg.tpu.kernel == "tables" and cfg.tpu.history_stride == 1
    assert runner.sampler_module(ChainSpec(
        N=4, n_steps=10, kernel=cfg.tpu.kernel,
        schedule=schedules.build_schedule("constant", 10,
                                          beta_const=1.0))) is board
