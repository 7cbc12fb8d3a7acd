"""The port's profiler trace (``mcqueens_torch.utils.profiling.trace``), the
counterpart of the JAX package's ``jax.profiler`` trace (CPU).

A traced run writes one Chrome trace file under its directory and changes
no result: every ``ChainResult`` array equals the untraced run's.  The
experiments CLI takes ``--profile-dir`` and the config's
``tpu.profile_dir``.  No JAX: nothing here compares with the JAX package.
"""

import json
import os

import numpy as np
import pytest
import yaml

from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.cli import experiments as exp_cli
from mcqueens_torch.core.schedules import build_schedule
from mcqueens_torch.dist import runner
from mcqueens_torch.experiments import config
from mcqueens_torch.utils import profiling

RESULT_ARRAYS = ("energy_history", "history_steps", "history_len",
                 "final_energy", "final_state", "best_energy", "best_state",
                 "steps_to_best", "stop_step", "accept_bins", "total_bins")


def _traces(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".pt.trace.json"))


def test_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "nested" / "dir"
    with profiling.trace(str(d)):
        pass
    (name,) = _traces(d)
    with open(d / name) as f:
        assert "traceEvents" in json.load(f)


def test_trace_of_none_does_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.trace(None):
        pass
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("kernel,mcmc_type", [
    ("pallas_shared", "board"), ("pallas", "board"),
    ("tables", "full_3d"), ("pallas_shared", "full_3d")])
def test_traced_run_equals_untraced(tmp_path, kernel, mcmc_type):
    spec = ChainSpec(N=5, n_steps=96, kernel=kernel, mcmc_type=mcmc_type,
                     history_stride=32, Q=13 if mcmc_type == "full_3d"
                     else None,
                     schedule=build_schedule("linear_annealing", 96,
                                             beta_start=0.5, beta_end=3.0))
    seeds = np.arange(8, dtype=np.uint32)
    want = runner.run_chains(seeds, spec, device="cpu")
    got = runner.run_chains(seeds, spec, device="cpu",
                            profile_dir=str(tmp_path))
    assert len(_traces(tmp_path)) == 1
    for name in RESULT_ARRAYS:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def _config(tmp_path, **tpu):
    raw = {
        "experiment_type": "single_N",
        "common": {
            "n_steps": 100, "n_runs": 2, "verbose": False,
            "initialization": "random", "mcmc_type": "board",
            "early_stop_patience": "None",
            "betta_scheduling": {"type": "linear_annealing", "base_seed": 7,
                                 "beta_const": 5.0, "beta_start": 0.5,
                                 "beta_end": 3.0},
            "output_path": "figures/out.png",
        },
        "single_N": {"N": 5},
        "tpu": {"kernel": "pallas", "history_stride": 50, **tpu},
    }
    path = tmp_path / f"cfg{len(tpu)}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _results(root):
    d = os.path.join(root, "results")
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            out[name] = f.read()
    return out


def test_experiments_cli_traces_from_flag_and_config(tmp_path):
    pytest.importorskip("matplotlib")
    plain, flag, cfg = (str(tmp_path / s) for s in ("plain", "flag", "cfg"))
    assert exp_cli.main(["--config", _config(tmp_path), "--outdir", plain,
                         "--device", "cpu"]) == 0
    assert exp_cli.main(["--config", _config(tmp_path), "--outdir", flag,
                         "--device", "cpu", "--profile-dir",
                         str(tmp_path / "t_flag")]) == 0
    path = _config(tmp_path, profile_dir=str(tmp_path / "t_cfg"))
    assert config.load_config(path).tpu.profile_dir == str(tmp_path / "t_cfg")
    assert exp_cli.main(["--config", path, "--outdir", cfg,
                         "--device", "cpu"]) == 0
    assert len(_traces(tmp_path / "t_flag")) == 1
    assert len(_traces(tmp_path / "t_cfg")) == 1
    want = _results(plain)
    assert want and _results(flag) == want and _results(cfg) == want


def test_mesh_still_raises(tmp_path):
    """The mesh is ported: a sharded run traces like any other and returns
    the unsharded run's arrays; only a mesh that is no sequence of devices
    raises, before anything is traced."""
    spec = ChainSpec(N=4, n_steps=8, kernel="pallas_shared",
                     schedule=build_schedule("constant", 8, beta_const=1.0))
    seeds = np.arange(4, dtype=np.uint32)
    with pytest.raises(TypeError, match="sequence of devices"):
        runner.run_chains(seeds, spec, device="cpu", mesh=object(),
                          profile_dir=str(tmp_path))
    assert not os.listdir(tmp_path)
    got = runner.run_chains(seeds, spec, device="cpu", mesh=["cpu"] * 2,
                            profile_dir=str(tmp_path))
    assert len(_traces(tmp_path)) == 1
    want = runner.run_chains(seeds, spec, device="cpu", mesh=["cpu"] * 2)
    for name in ("energy_history", "final_state", "best_state",
                 "accept_bins", "total_bins"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
