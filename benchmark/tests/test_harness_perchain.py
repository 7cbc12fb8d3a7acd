"""The per-chain board family (``reference/board_perchain.py``,
``work/board_perchain.py``), the experiment kind (``kinds/experiment.py``)
and the durability readers (``metrics/checkpoint_*``) of cell
``pod_n20.perchain``, on the CPU: a small cell of the pod configuration
runs through the experiments driver and is judged correct; its reference
walks every chain as the program's twin does; a program whose site or
offset is drawn wrong, or a reference in bfloat16, fails the replay; saves
skipped or stale are not correct; the kind removes its directory; the
readers read made-up traces."""

import json
import math

import pytest

from benchmark import check, peaks, searches
from benchmark import run as run_mod
from benchmark.trace import Trace
from benchmark.tests import tiny

CELL = "tiny_perchain.perchain"
# 16 launches of 64 steps, planned as the driver's verbose floor of 10
# segments of 2: the last two segments' four launches lie past n_steps.
TINY = dict(N=6, chains=64, n_steps=1000, history_stride=64)


def _checkout(tmp):
    root = tiny.checkout(tmp)
    configs = root / "benchmark" / "configs"
    cfg = json.loads((configs / "pod_n20.json").read_text())
    cfg.update(name="tiny_perchain", **TINY)
    (configs / "tiny_perchain.json").write_text(json.dumps(cfg))
    workload = json.loads((root / "benchmark" / "workloads"
                           / "pod_n20.perchain.json").read_text())
    workload["warmup_segments"] = 1
    tiny.add_cell(root, CELL, "tiny_perchain", workload,
                  like="pod_n20.perchain")
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _checkout(tmp_path_factory.mktemp("perchain"))


def _run(root, seed=2 ** 31 + 11):
    manifest, cell = run_mod.load_cell(root, CELL)
    out = run_mod.run(root, manifest, cell, seed, 0.0, False, device="cpu")
    return out, cell


def test_sound_run_is_correct_and_its_directory_goes(root, capsys):
    from mcqueens_torch.utils import checkpoint

    saves = checkpoint.SAVES
    out, cell = _run(root)
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == {"energy", "proposals", "replay"}
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert set(out["metrics"]) == {"moves_per_s.board", "setup_s"}
    # The warm-up (one launch, one segment) and the window's one search (10
    # segments) saved after each segment, each search in a directory of its
    # own under build/, gone when it returned, with the driver's log.
    assert checkpoint.SAVES - saves == 1 + 10
    assert (root / "build").is_dir()
    assert list((root / "build").glob("bench_ckpt_*")) == []
    assert "[mcqueens]" not in capsys.readouterr().out


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 3])
def test_reference_walks_every_chain_as_the_twin(root, seed):
    _, cell = run_mod.load_cell(root, CELL)
    spec = cell.spec()
    base = searches.base_seed(seed, 0, spec.chains)
    result = searches.Searcher(cell, "cpu")(base)
    assert check.claims(spec, base, result, "cpu") == {"energy": 0,
                                                       "proposals": 0}
    chains = range(spec.chains)
    assert check.replay(spec, base, result, chains) == []
    assert len(check.replay(spec, base, result, chains,
                            precision="bfloat16")) >= 1


def _wrong_draws(monkeypatch, fault):
    import torch

    from mcqueens_torch.kernels import prng

    real = prng.step_words
    NN = TINY["N"] ** 2

    def step_words(g, step):
        w0, w1 = real(g, step)
        if fault == "site":
            w0 = w0 ^ 1  # i = w0 % N moves by one
        else:
            # the offset (w0 // N^2) % (N - 1) moves by one, the site stays
            w0 = torch.where(w0 >= NN, w0 - NN, w0 + NN)
        return w0, w1

    monkeypatch.setattr(prng, "step_words", step_words)


@pytest.mark.parametrize("fault", ["site", "offset"])
def test_wrong_draw_fails_the_replay(root, monkeypatch, fault):
    _wrong_draws(monkeypatch, fault)
    out, _ = _run(root)
    assert out["correct"] is False
    assert out["checks"]["replay"]["value"] >= 1, out["checks"]


def _faulty_saves(monkeypatch, fault):
    import dataclasses

    from mcqueens_torch.utils import checkpoint

    real = checkpoint.Checkpointer.save
    held = {}

    def save(self, carry, segments_done, *args, **kw):
        if fault == "skipped" and segments_done % 2:
            return  # every other save left out
        if fault == "stale":
            # every save of a search writes a copy of its first segment's
            # carry
            if segments_done == 1:
                held["carry"] = dataclasses.replace(carry, **{
                    f.name: getattr(carry, f.name).clone()
                    for f in dataclasses.fields(carry)})
            carry = held["carry"]
        real(self, carry, segments_done, *args, **kw)

    monkeypatch.setattr(checkpoint.Checkpointer, "save", save)


@pytest.mark.parametrize("fault", ["skipped", "stale"])
def test_faulty_save_is_not_correct(root, monkeypatch, fault):
    """Saves that skip a segment, or hold a stale carry, leave
    the search's chains and states right but break the deployment's
    durability, which the check holds the search to."""
    _faulty_saves(monkeypatch, fault)
    out, _ = _run(root)
    assert out["correct"] is False
    assert out["checks"]["replay"]["value"] == 0
    assert out["checks"]["energy"]["value"] == 0
    assert out["checks"]["proposals"]["value"] >= 1, out["checks"]


def test_pod_launch_count():
    work = searches.load_module(tiny.BENCH / "work" / "board_perchain.py")
    cfg = json.loads((tiny.BENCH / "configs" / "pod_n20.json").read_text())
    ops, nbytes = work.launch(cfg, 4096, 16384)
    # chip_smoke.metropolis_work's count: 5.3177e10 ops, bound 1.590 ms.
    assert math.isclose(ops, 4096 * 16384 * (12 * 62.7 + 40))
    assert math.isclose(peaks.least_seconds(ops, nbytes), 1.5896e-3,
                        rel_tol=1e-4)
    assert nbytes == 4 * (2 * 4096 * (2 * 400 + 6 + 200) + 16384)


def _read(name, tr):
    run = type("Run", (), {"trace": tr, "cards": (0,)})()
    return searches.load_module(
        tiny.BENCH / "metrics" / f"{name}.py").read(run)


def test_durability_readers():
    """Two searches, each with a save of two writes; the card idles
    [100, 150] under the first save and [600, 700] under the second, 20
    us of which under no save."""
    device = {0: [(0.0, 100.0, "k"), (150.0, 600.0, "k"),
                  (700.0, 1000.0, "k")]}
    host = [(0.0, 500.0, "mcq.search"), (90.0, 160.0, "mcq.checkpoint"),
            (100.0, 110.0, "mcq.checkpoint.write"),
            (120.0, 150.0, "mcq.checkpoint.write"),
            (500.0, 1000.0, "mcq.search"), (620.0, 700.0, "mcq.checkpoint"),
            (630.0, 640.0, "mcq.checkpoint.write"),
            (650.0, 690.0, "mcq.checkpoint.write")]
    tr = Trace(window=(0.0, 1000.0), searches=[], device=device,
               host=sorted(host), events=0)
    assert _read("checkpoint_idle_ms", tr) == pytest.approx(
        (50 + 80) / 2 * 1e-3)
    assert _read("checkpoint_write_ms", tr) == pytest.approx(
        (10 + 30 + 10 + 40) / 2 * 1e-3)
    # A program without the spans, or a run without a trace, reads nothing.
    bare = Trace(window=(0.0, 1000.0), searches=[], device=device,
                 host=[(0.0, 1000.0, "mcq.search")], events=0)
    for name in ("checkpoint_idle_ms", "checkpoint_write_ms"):
        assert _read(name, bare) is None
        assert _read(name, None) is None
