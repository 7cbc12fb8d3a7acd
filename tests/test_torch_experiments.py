"""Parity of the port's config-driven experiments path with the JAX package.

The same small YAML (``tpu.kernel: pallas``) goes through
``python -m mcqueens.cli.experiments`` (its Pallas kernels in interpret
mode) and ``python -m mcqueens_torch.cli.experiments --device cpu`` (the
kernels' plain-torch twins); every CSV under ``results/`` must be equal,
byte for byte, and every figure must exist in both trees.  The experiment
sections share one schedule, so their runs share specs and the JAX side
compiles each spec once.  Config guards, the schedule factories and the
numpy statistics are compared with the JAX package directly.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from mcqueens.chain import stats as jstats
from mcqueens.cli import experiments as jax_cli
from mcqueens.core import schedules as jschedules
from mcqueens.experiments import config as jconfig
from mcqueens_torch.chain import stats
from mcqueens_torch.cli import experiments as cli
from mcqueens_torch.core import schedules
from mcqueens_torch.dist import runner
from mcqueens_torch.experiments import config, drivers
from tests.test_torch_foundations import release_jax_executables  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _raw(experiment_type, mcmc_type="board"):
    return {
        "experiment_type": experiment_type,
        "common": {
            "n_steps": 200, "n_runs": 3, "verbose": False,
            "initialization": "random", "mcmc_type": mcmc_type,
            "early_stop_patience": "None",
            "betta_scheduling": {"type": "linear_annealing", "base_seed": 7,
                                 "beta_const": 5.0, "beta_start": 0.5,
                                 "beta_end": 3.0},
            "output_path": "figures/out.png",
        },
        "single_N": {"N": 5},
        "measure_min_energy_vs_N": {"Ns": [4, 5],
                                    "init_modes": ["random", "latin"]},
        "beta_start_end_pairs": {
            "N": 3 if mcmc_type == "full_3d" else 5,
            "beta_start_ends": ([[0.5, 3.0]] if mcmc_type == "full_3d"
                                else [[0.5, 3.0], [1.0, 5.0]]),
            "annealing_type": "linear_annealing",
            "output_path": "figures/pairs.png",
            "output_path_acceptance": "figures/acc.png",
        },
        "compare_beta_end": {"Ns": [4, 5], "beta_start_ends": [[0.5, 3.0]],
                             "annealing_type": "linear_annealing",
                             "output_path": "figures/cmp.png"},
        "tpu": {"kernel": "pallas", "history_stride": 50},
    }


def _files(root, sub):
    d = os.path.join(root, sub)
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


@pytest.mark.parametrize("experiment_type,mcmc_type", [
    ("single_N", "board"), ("measure_min_energy_vs_N", "board"),
    ("beta_start_end_pairs", "board"), ("compare_beta_end", "board"),
    ("beta_start_end_pairs", "full_3d"),
])
def test_cli_outputs_match_jax(tmp_path, experiment_type, mcmc_type):
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_raw(experiment_type, mcmc_type)))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    with pltpu.force_tpu_interpret_mode():
        assert jax_cli.main(["--config", str(path), "--outdir", jdir]) == 0
    assert cli.main(["--config", str(path), "--outdir", tdir,
                     "--device", "cpu"]) == 0
    csvs = _files(jdir, "results")
    # The side-by-side comparison draws its figure and writes no CSV.
    assert bool(csvs) == (experiment_type != "compare_beta_end")
    assert _files(tdir, "results") == csvs
    for name in csvs:
        with open(os.path.join(jdir, "results", name)) as f:
            want = f.read()
        with open(os.path.join(tdir, "results", name)) as f:
            assert f.read() == want, name
    figures = _files(jdir, "figures")
    assert figures and _files(tdir, "figures") == figures
    for name in figures:
        assert os.path.getsize(os.path.join(tdir, "figures", name)) > 0


def test_seed_derivations_and_results():
    """The drivers' seeds: ``+1000 * idx`` per pair, ``+10000`` for the
    second N, ``+10 * idx + sum(ord(init)) % 1000`` per sweep cell."""
    tpu = config.TpuConfig(kernel="pallas", history_stride=30)
    common = dict(n_steps=60, n_runs=2, verbose=False, tpu=tpu,
                  device="cpu", early_stop_patience=None)
    sched = schedules.build_schedule("linear_annealing", 60, beta_start=0.5,
                                     beta_end=3.0)

    def best(N, init, seed, schedule=sched):
        return runner.run_experiment(
            N=N, n_steps=60, init_mode=init, schedule=schedule, n_runs=2,
            base_seed=seed, device="cpu", early_stop_patience=None,
            history_stride=30, kernel="pallas").best_energy

    pairs = [[0.5, 3.0], [1.0, 5.0]]
    out = drivers.run_compare_beta_end([4, 5], beta_start_ends=pairs,
                                       base_seed=11, plot=False, **common)
    for res, N, seed in ((out["result_N1"], 4, 11),
                         (out["result_N2"], 5, 10011)):
        for idx, (b0, b1) in enumerate(pairs):
            got = res["all_best_energies"][f"beta: {b0}->{b1}"]
            want = best(N, "random", seed + 1000 * idx,
                        schedules.build_schedule("linear_annealing", 60,
                                                 beta_start=b0, beta_end=b1))
            np.testing.assert_array_equal(got, want)
    out = drivers.measure_min_energy_vs_n(
        [4, 5], schedule=sched, init_modes=["random", "latin"], base_seed=3,
        plot=False, **common)
    for init in ("random", "latin"):
        offset = sum(ord(c) for c in init) % 1000
        for idx, N in enumerate([4, 5]):
            np.testing.assert_array_equal(
                out["results"][init]["all_min_energies"][idx],
                best(N, init, 3 + 10 * idx + offset))


def test_drivers_run_without_yaml_matplotlib_pandas():
    """The drivers and the CLI module import, and run with ``plot=False``,
    where yaml, matplotlib and pandas cannot be imported."""
    code = (
        "import sys\n"
        "for m in ('yaml', 'matplotlib', 'pandas'): sys.modules[m] = None\n"
        "from mcqueens_torch.cli import experiments\n"
        "from mcqueens_torch.experiments import config, drivers\n"
        "cfg = config.parse_config({'experiment_type': 'single_N',\n"
        "                           'common': {}, 'tpu': {'mesh': False}})\n"
        "tpu = config.TpuConfig(kernel='pallas', history_stride=20)\n"
        "res = drivers.run_beta_start_end_pairs(\n"
        "    N=4, n_steps=40, beta_start_ends=[[0.5, 3.0]], n_runs=2,\n"
        "    verbose=False, plot=False, tpu=tpu, device='cpu')\n"
        "assert list(res['all_best_energies']) == ['beta: 0.5->3.0']\n"
        "assert 'jax' not in sys.modules and 'mcqueens' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_config_guards_match_jax():
    base = _raw("single_N")
    for parse in (jconfig.parse_config, config.parse_config):
        cfg = parse(base)
        assert (cfg.tpu.kernel, cfg.n_steps, cfg.early_stop_patience) == (
            "pallas", 200, None)
        for tpu, msg in (({"kernle": "tables"}, "Unknown tpu config keys"),
                         ({"kernel": "pallas_shared"},
                          "allow_correlated_runs")):
            with pytest.raises(ValueError, match=msg):
                parse({**base, "tpu": tpu})
        assert parse({**base, "tpu": {"kernel": "pallas_shared",
                                      "allow_correlated_runs": True}})
        with pytest.raises(ValueError, match="experiment_type"):
            parse({**base, "experiment_type": "bogus"})
        with pytest.raises(ValueError, match="common.output_path"):
            parse({**base, "common": {}}).output_path
        with pytest.raises(ValueError, match="'single_N' section"):
            parse({k: v for k, v in base.items()
                   if k != "single_N"}).section("single_N")
    for tpu in ({"mesh": True}, {"mesh": 2}, {"profile_dir": "trace"},
                {"checkpoint_dir": "ck", "mesh": True}):
        with pytest.raises(NotImplementedError, match="queue 1 item 7"):
            config.parse_config({**base, "tpu": tpu})
    assert config.parse_config({**base, "tpu": {
        "mesh": False, "checkpoint_dir": None, "profile_dir": None}})
    # checkpoint_dir is ported (tests/test_torch_checkpoint.py)
    assert config.parse_config({**base, "tpu": {
        "checkpoint_dir": "ck"}}).tpu.checkpoint_dir == "ck"


def test_repo_configs_load():
    """The committed configs parse in the port; pod_scale's mesh is refused
    until it is ported (its checkpoint_dir is ported)."""
    for name in ("config.yaml", "configs/reference_parity.yaml",
                 "configs/beyond_reference.yaml"):
        path = os.path.join(REPO, name)
        want, got = jconfig.load_config(path), config.load_config(path)
        assert got.raw == want.raw and got.tpu.__dict__ == want.tpu.__dict__
    with pytest.raises(NotImplementedError, match="mesh"):
        config.load_config(os.path.join(REPO, "configs/pod_scale.yaml"))


@pytest.mark.parametrize("flags", [["--mesh"], ["--profile-dir", "trace"]])
def test_cli_refuses_unported_flags(flags):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--config", "config.yaml", "--device", "cpu"] + flags)
    assert exc.value.code == 2


@pytest.mark.parametrize("kind", schedules.SCHEDULE_TYPES)
def test_schedule_factories_match_jax(kind):
    """``linear`` and ``constant`` betas are bitwise; exp/log/cos kinds are
    within 2 float32 ulp of XLA's (ROADMAP.md queue 3)."""
    sched_cfg = {"type": kind, "base_seed": 9, "beta_const": 2.5,
                 "beta_start": 0.5, "beta_end": 4.0}
    common = {"betta_scheduling": sched_cfg}
    n = 5000
    want = [jschedules.schedule_from_common(common, n)] + \
        jschedules.schedules_from_types([kind, "linear_annealing"],
                                        sched_cfg, n)
    got = [schedules.schedule_from_common(common, n)] + \
        schedules.schedules_from_types([kind, "linear_annealing"],
                                       sched_cfg, n)
    steps = np.arange(0, n + 7, 3, dtype=np.int32)
    for (jsched, jseed), (sched, seed) in zip(want, got):
        assert seed == jseed == 9
        assert (sched.kind, sched.n_steps, sched.label, sched.desc) == (
            jsched.kind, jsched.n_steps, jsched.label, jsched.desc)
        jb = np.asarray(jsched(jnp.asarray(steps)), np.float32)
        tb = sched(torch.from_numpy(steps)).numpy()
        if sched.kind in ("linear_annealing", "constant"):
            np.testing.assert_array_equal(tb, jb)
        else:
            np.testing.assert_array_max_ulp(tb, jb, maxulp=2)


def test_stats_match_jax():
    rng = np.random.default_rng(4)
    hist = rng.integers(0, 50, size=(6, 9))
    lens = np.array([9, 3, 9, 1, 5, 9])
    for args in ((hist,), (hist, lens)):
        for a, b in zip(stats.energy_curve_stats(*args),
                        jstats.energy_curve_stats(*args)):
            np.testing.assert_array_equal(a, b)
    acc = rng.integers(0, 5, size=(6, 10))
    tot = acc + rng.integers(0, 3, size=(6, 10))
    tot[:, 3] = acc[:, 3] = 0
    np.testing.assert_array_equal(stats.acceptance_rate_bins(acc, tot),
                                  jstats.acceptance_rate_bins(acc, tot))
    np.testing.assert_array_equal(stats.bin_centers(350, 7),
                                  jstats.bin_centers(350, 7))
    assert stats.summarize_best(hist[:, 0], lens) == jstats.summarize_best(
        hist[:, 0], lens)
