"""``configs/pod_scale.yaml``'s deployment on the CPU: the experiments
driver with a one-shard mesh and a checkpoint after every segment, over the
per-chain board sampler's plain-torch twin.

At two small shapes, every chain of a search through
``drivers.run_single_n`` equals the benchmark's plain reference of the
per-chain family (``benchmark/reference/board_perchain.py``, loaded by its
file path) in history, final and best states and energies, best step and
bins.  The benchmark's configuration of the deployment
(``benchmark/configs/pod_n20.json``) holds the YAML's values.  The search
records its saves as spans (``mcq.checkpoint`` > ``mcq.checkpoint.write``,
one a file) and counts them (``checkpoint.SAVES``, and the chunks'
bytes); a second search of the same seed in a
fresh directory makes every launch again.  No JAX: the reference is plain
torch and numpy.  Tolerance: none.
"""

import collections
import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch
import yaml
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import chains as R
from mcqueens_torch.dist import mesh as mesh_mod
from mcqueens_torch.dist import runner
from mcqueens_torch.experiments import config, drivers
from mcqueens_torch.kernels import metropolis_pallas
from mcqueens_torch.utils import checkpoint
from tests.test_torch_profiling import PARENTS as SEARCH_PARENTS
from tests.test_torch_profiling import _parents

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRIDE = 16
# (N, chains, steps): 19 launches planned as the driver's verbose floor of
# 10 segments of 2, so the last launch lies past n_steps.
SHAPES = [(6, 64, 300), (7, 96, 290)]


def _reference():
    path = os.path.join(REPO, "benchmark", "reference", "board_perchain.py")
    spec = importlib.util.spec_from_file_location("ref_board_perchain", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pod_json():
    with open(os.path.join(REPO, "benchmark", "configs",
                           "pod_n20.json")) as f:
        return json.load(f)


def _cfg(N, chains, n_steps, ckdir, base=17):
    """``configs/pod_scale.yaml`` at a small shape, its checkpoints in
    ``ckdir``."""
    with open(os.path.join(REPO, "configs", "pod_scale.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["common"].update(n_steps=n_steps, n_runs=chains)
    raw["common"]["betta_scheduling"]["base_seed"] = base
    raw["single_N"]["N"] = N
    raw["tpu"].update(history_stride=STRIDE, checkpoint_dir=str(ckdir))
    return config.parse_config(raw)


def _search(cfg, capsys=None):
    res = drivers.run_single_n(cfg, device="cpu",
                               mesh=mesh_mod.mesh_for("cpu", 1),
                               plot=False)["result"]
    if capsys is not None:
        capsys.readouterr()
    return res


@pytest.mark.parametrize("N,chains,n_steps", SHAPES)
def test_every_chain_equals_the_reference(tmp_path, capsys, N, chains,
                                          n_steps):
    ref = _reference()
    cfg = _cfg(N, chains, n_steps, tmp_path)
    res = _search(cfg, capsys)
    assert res.devices == ("cpu",)
    spec = types.SimpleNamespace(config={"N": N}, n_steps=n_steps,
                                 stride=STRIDE, n_bins=cfg.tpu.n_bins)
    init = ref.initial_states(
        {"N": N}, 17 + torch.arange(chains, dtype=torch.int64)).numpy()
    betas = R.schedule_betas("linear_annealing", n_steps,
                             {"beta_start": 1.0, "beta_end": 5.0})
    for c in range(chains):
        want = {"energy_history": res.energy_history[c].tolist(),
                "final_energy": int(res.final_energy[c]),
                "final_state": res.final_state[c].reshape(-1).tolist(),
                "best_energy": int(res.best_energy[c]),
                "best_state": res.best_state[c].reshape(-1).tolist(),
                "best_step": int(res.steps_to_best[c]),
                "accept_bins": res.accept_bins[c].tolist(),
                "total_bins": res.total_bins[c].tolist()}
        got = ref.walk(spec, 17, c, init[c], betas)
        assert any(g == want for g in got), c


def test_benchmark_config_holds_the_yaml():
    with open(os.path.join(REPO, "configs", "pod_scale.yaml")) as f:
        raw = yaml.safe_load(f)
    common, sched, tpu = raw["common"], raw["common"]["betta_scheduling"], \
        raw["tpu"]
    yaml_values = {
        "experiment_type": raw["experiment_type"],
        "mcmc_type": common["mcmc_type"], "N": raw["single_N"]["N"],
        "chains": common["n_runs"], "kernel": tpu["kernel"],
        "init_mode": common["initialization"],
        "beta_start": sched["beta_start"], "beta_end": sched["beta_end"],
        "n_steps": common["n_steps"],
        "history_stride": tpu["history_stride"],
        "early_stop_patience": config.parse_config(raw).early_stop_patience,
        "verbose": common["verbose"], "mesh": tpu["mesh"]}
    assert sched["type"] == "linear_annealing"
    pod = _pod_json()
    assert {k: pod[k] for k in yaml_values} == yaml_values
    assert pod["Q"] is None and pod["reduced"] == []
    # What the YAML fixes and the benchmark does not copy is assumed.
    assert {"seeds", "n_bins", "checkpoint_dir"} <= set(pod["assumed"])
    assert "checkpoint_dir" in tpu and "checkpoint_dir" not in pod


# Where each span of a pod search may sit: a search's places, and the save's
# own spans inside its round.
PARENTS = {**SEARCH_PARENTS,
           "mcq.mesh.gather": {"mcq.round", "mcq.checkpoint"},
           "mcq.checkpoint": {"mcq.round"},
           "mcq.checkpoint.write": {"mcq.checkpoint"}}


def test_saves_are_spans_and_counts(tmp_path, capsys):
    N, chains, n_steps = SHAPES[0]
    cfg = _cfg(N, chains, n_steps, tmp_path)
    n_segs, seg_outer = runner.plan_segments(-(-n_steps // STRIDE), chains,
                                             STRIDE, min_segments=10)
    saves0, made = checkpoint.SAVES, []
    real = checkpoint.Checkpointer.__init__

    def init(self, *args, **kw):
        real(self, *args, **kw)
        made.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(checkpoint.Checkpointer, "__init__", init)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _search(cfg, capsys)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("mcq.")]
    counts = collections.Counter(e.name() for e in events)
    assert counts["mcq.round"] == counts["mcq.checkpoint"] == n_segs
    assert counts["mcq.launch"] == n_segs * seg_outer
    # Each save writes its segment's history chunk and the main npz.
    files = sorted(os.listdir(tmp_path))
    chunks = [f for f in files if ".hist" in f]
    assert len(chunks) == n_segs and len(files) == n_segs + 1
    assert counts["mcq.checkpoint.write"] == 2 * n_segs
    for name, parent in _parents(events):
        assert parent in PARENTS[name], (name, parent)
    assert checkpoint.SAVES - saves0 == n_segs
    (ck,) = made
    with np.load(ck.path) as d:
        assert int(d["segments_done"]) == n_segs
    history = sum(np.load(tmp_path / f).nbytes for f in chunks)
    assert ck.history_bytes_written == history


def test_fresh_directory_makes_every_launch(tmp_path, capsys, monkeypatch):
    """A search saves after every segment; the same search in a fresh
    directory launches all of its chunks again (on the CPU: the twin's
    calls), and equals the first; in the first directory it resumes from
    the last save and launches none."""
    N, chains, n_steps = SHAPES[1]
    n_segs, seg_outer = runner.plan_segments(-(-n_steps // STRIDE), chains,
                                             STRIDE, min_segments=10)
    calls = []
    real = metropolis_pallas.segment_reference

    def twin(st, step0, *args, **kw):
        calls.append(step0)
        return real(st, step0, *args, **kw)

    monkeypatch.setattr(metropolis_pallas, "segment_reference", twin)
    runs = {}
    for run, d in (("first", "a"), ("fresh", "b"), ("again", "a")):
        calls.clear()
        runs[run] = _search(_cfg(N, chains, n_steps, tmp_path / d), capsys)
        runs[run + "_calls"] = list(calls)
    every = [o * STRIDE for o in range(n_segs * seg_outer)]
    assert runs["first_calls"] == runs["fresh_calls"] == every
    assert runs["again_calls"] == []
    for name in ("energy_history", "final_state", "best_state",
                 "steps_to_best", "accept_bins", "total_bins"):
        want = getattr(runs["first"], name)
        np.testing.assert_array_equal(getattr(runs["fresh"], name), want)
        np.testing.assert_array_equal(getattr(runs["again"], name), want)
