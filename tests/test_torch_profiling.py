"""The port's profiler trace (``mcqueens_torch.utils.profiling.trace``), the
counterpart of the JAX package's ``jax.profiler`` trace, and its spans
(``profiling.span``) (CPU).

A traced run writes one Chrome trace file under its directory and changes
no result: every ``ChainResult`` array equals the untraced run's.  The
experiments CLI takes ``--profile-dir`` and the config's
``tpu.profile_dir``.  Under a profiler a search records its span tree as
host operators (never user annotations, which the profiler mirrors on the
card); with none, a span is one shared null context.  No JAX: nothing here
compares with the JAX package.
"""

import collections
import json
import os

import numpy as np
import pytest
import torch
import yaml
from torch.profiler import ProfilerActivity, profile

from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.cli import experiments as exp_cli
from mcqueens_torch.core.schedules import build_schedule
from mcqueens_torch.dist import runner
from mcqueens_torch.experiments import config
from mcqueens_torch.search import tempering
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


# Where each span may sit: the innermost span of the program around it.
PARENTS = {
    "mcq.search": {None},
    "mcq.init": {"mcq.search"},
    "mcq.round": {"mcq.search"},
    "mcq.drain": {"mcq.search"},
    "mcq.launch": {"mcq.round", "mcq.mesh.shard"},
    "mcq.betas": {"mcq.launch"},
    "mcq.transpose": {"mcq.round", "mcq.mesh.shard"},
    "mcq.read": {"mcq.init", "mcq.round", "mcq.drain", "mcq.transpose"},
    "mcq.exchange": {"mcq.round"},
    "mcq.mesh.shard": {"mcq.round"},
    "mcq.mesh.gather": {"mcq.round", "mcq.exchange"},
    "mcq.sync": {"mcq.drain"},
}


def _span_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("mcq.")]


def _parents(events):
    """Each span's name with the name of the innermost span enclosing it
    (None for a root), from their times on the one host thread."""
    evs = sorted(events, key=lambda e: (e.start_ns(), -e.end_ns()))
    stack, out = [], []
    for e in evs:
        while stack and stack[-1].end_ns() < e.end_ns():
            stack.pop()
        out.append((e.name(), stack[-1].name() if stack else None))
        stack.append(e)
    return out


def _search(case, device="cpu"):
    """One small search of ``case``; returns (result, launches, rounds,
    shards)."""
    seeds = np.arange(8, dtype=np.uint32)
    if case == "tempered":
        spec = ChainSpec(N=5, n_steps=96, kernel="pallas_shared",
                         history_stride=32,
                         schedule=build_schedule("constant", 96,
                                                 beta_const=1.0))
        ladder = tempering.geometric_ladder(0.5, 3.0, 4)
        return tempering.run_tempered(seeds, spec, ladder, device=device,
                                      swap_seed=3), 3, 3, 1
    kernel, mcmc_type, shards = case
    spec = ChainSpec(N=5, n_steps=96, kernel=kernel, mcmc_type=mcmc_type,
                     history_stride=32,
                     Q=13 if mcmc_type == "full_3d" else None,
                     schedule=build_schedule("linear_annealing", 96,
                                             beta_start=0.5, beta_end=3.0))
    mesh = None if shards == 1 else ["cpu"] * shards
    res = runner.run_chains(seeds, spec, device=device, mesh=mesh,
                            min_segments=3)
    # Three segments of one chunk each: a launch a segment and shard.
    return res, 3 * shards, 3, shards


SEARCH_CASES = [("pallas_shared", "board", 1), ("pallas", "board", 1),
                ("tables", "board", 1), ("pallas_shared", "full_3d", 2),
                ("pallas", "full_3d", 1), ("tables", "full_3d", 2),
                "tempered"]


@pytest.mark.parametrize("case", SEARCH_CASES, ids=str)
def test_search_records_its_span_tree(case):
    want = _search(case)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got, launches, rounds, shards = _search(case)
    events = _span_events(prof)
    counts = collections.Counter(e.name() for e in events)
    assert counts["mcq.search"] == counts["mcq.init"] == 1
    assert counts["mcq.drain"] == counts["mcq.sync"] == 1
    assert counts["mcq.round"] == rounds
    assert counts["mcq.launch"] == counts["mcq.betas"] == launches
    assert counts["mcq.transpose"] == 2 * rounds * shards
    assert counts["mcq.exchange"] == (rounds - 1 if case == "tempered"
                                      else 0)
    assert counts["mcq.mesh.shard"] == (rounds * shards if shards > 1
                                        else 0)
    assert counts["mcq.read"] >= rounds + 2
    assert set(counts) <= set(PARENTS)
    for name, parent in _parents(events):
        assert parent in PARENTS[name], (name, parent)
    # Host operators on the calling thread, none a user annotation.
    assert len({e.start_thread_id() for e in events}) == 1
    for e in events:
        assert not e.is_user_annotation(), e.name()
        assert e.device_type() == torch.autograd.DeviceType.CPU
        if hasattr(e, "activity_type"):
            assert e.activity_type() == "cpu_op", e.name()
    # The wall time is the root span's: init, the rounds and the drain.
    by = {e.name(): e for e in events}
    wall = got["wall_time"] if case == "tempered" else got.wall_time
    inner = sum(e.duration_ns() for e in events
                if e.name() in ("mcq.init", "mcq.round", "mcq.drain"))
    assert inner * 1e-9 <= wall + 1e-3
    assert wall <= by["mcq.search"].duration_ns() * 1e-9 + 1e-3
    # Spans change no result.
    if case == "tempered":
        for key in want:
            if key != "wall_time":
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=key)
    else:
        for name in RESULT_ARRAYS:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)


def test_span_is_one_null_context_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    a, b = profiling.span("mcq.a"), profiling.span("mcq.b")
    assert a is b
    with a:
        with b:
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        c = profiling.span("mcq.c")
        assert c is not a
        with c:
            pass
    assert [e.name() for e in _span_events(prof)] == ["mcq.c"]
