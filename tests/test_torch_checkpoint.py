"""Checkpoint and resume of the port (CPU), and its files against the JAX
package's.

Mirrors the JAX package's checkpoint tests (``tests/test_dist.py``,
``tests/test_tempering.py``, ``tests/test_experiments.py``) on the port's
six samplers and its tempering, with the kernels' plain-torch twins: a run
killed after some segments and rerun from its checkpoint equals an
uninterrupted run in every array, bitwise, and the rerun runs only the
segments that remained (each ``run_segment`` call is recorded; a refused
restore would rerun from segment 0 and still match, so the calls are what
show that a resume happened).  Stale checkpoints of every kind are ignored.
At N=5, 8 chains and 4 segments the JAX ``Checkpointer`` and the port's
write the same npz keys and, except ``fingerprint``, the same arrays.
Tolerance: none.
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from mcqueens.chain.spec import ChainSpec as JaxSpec
from mcqueens.core import schedules as jschedules
from mcqueens.dist import runner as jrunner
from mcqueens.utils import checkpoint as jcheckpoint
from mcqueens_torch.chain import board as board_chain
from mcqueens_torch.chain import full3d as full3d_chain
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.cli import competition
from mcqueens_torch.cli import experiments as exp_cli
from mcqueens_torch.core import schedules
from mcqueens_torch.dist import runner
from mcqueens_torch.kernels import (board_shared, full3d_pallas,
                                    full3d_shared, metropolis_pallas)
from mcqueens_torch.search import tempering
from mcqueens_torch.utils.checkpoint import (Checkpointer, extend_fingerprint,
                                             spec_fingerprint)
from tests.test_torch_foundations import release_jax_executables  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULT_FIELDS = ("energy_history", "history_steps", "history_len",
                 "final_energy", "final_state", "best_energy", "best_state",
                 "steps_to_best", "stop_step", "accept_bins", "total_bins")
LIN = dict(sched_type="linear_annealing", beta_start=0.5, beta_end=3.0)

# sampler -> (module whose run_segment the runner calls, ChainSpec kwargs)
SAMPLERS = {
    "pallas_shared-board": (board_shared, dict(
        N=5, kernel="pallas_shared", mcmc_type="board")),
    "pallas_shared-full_3d": (full3d_shared, dict(
        N=4, Q=12, kernel="pallas_shared", mcmc_type="full_3d")),
    "pallas-board": (metropolis_pallas, dict(
        N=5, kernel="pallas", mcmc_type="board")),
    "pallas-full_3d": (full3d_pallas, dict(
        N=4, Q=12, kernel="pallas", mcmc_type="full_3d")),
    "tables-board": (board_chain, dict(
        N=5, kernel="tables", mcmc_type="board", early_stop_patience=60)),
    "naive-board": (board_chain, dict(
        N=5, kernel="naive", mcmc_type="board", early_stop_patience=60)),
    "tables-full_3d": (full3d_chain, dict(
        N=3, Q=8, kernel="tables", mcmc_type="full_3d")),
    "naive-full_3d": (full3d_chain, dict(
        N=3, Q=8, kernel="naive", mcmc_type="full_3d")),
}
SEEDS = 5 + np.arange(4, dtype=np.uint32)


class Killed(Exception):
    pass


class KilledAfter(Checkpointer):
    """A checkpointer whose save raises once ``kill_at`` segments are in,
    after writing them: a process killed right after its checkpoint."""

    def __init__(self, *args, kill_at, **kw):
        super().__init__(*args, **kw)
        self.kill_at = kill_at

    def save(self, carry, segments_done, chunks, **kw):
        super().save(carry, segments_done, chunks, **kw)
        if segments_done == self.kill_at:
            raise Killed()


@contextlib.contextmanager
def segment_calls(monkeypatch, mod, name="run_segment"):
    """Record the start chunk of every ``mod.<name>`` call."""
    starts, real = [], getattr(mod, name)

    def record(carry, *args):
        start = args[1] if name == "run_segment_tempered" else args[0]
        starts.append(int(start))
        return real(carry, *args)

    monkeypatch.setattr(mod, name, record)
    try:
        yield starts
    finally:
        monkeypatch.setattr(mod, name, real)


def _spec(sampler, n_steps=200, stride=50, **over):
    kw = dict(n_steps=n_steps, history_stride=stride, init_mode="random",
              **SAMPLERS[sampler][1])
    kw.update(over)
    return ChainSpec(schedule=schedules.build_schedule(n_steps=n_steps, **LIN),
                     **kw)


def _assert_same_results(want, got):
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_resume_is_bitwise_and_runs_only_the_rest(sampler, tmp_path,
                                                  monkeypatch):
    mod = SAMPLERS[sampler][0]
    spec = _spec(sampler)
    plain = runner.run_chains(SEEDS, spec, device="cpu")
    crasher = KilledAfter(str(tmp_path), kill_at=2, min_segments=4)
    with pytest.raises(Killed):
        runner.run_chains(SEEDS, spec, device="cpu", checkpointer=crasher)
    ck = Checkpointer(str(tmp_path), min_segments=4)
    with segment_calls(monkeypatch, mod) as starts:
        resumed = runner.run_chains(SEEDS, spec, device="cpu",
                                    checkpointer=ck)
    assert starts == [2, 3]  # 4 segments of one chunk: only 2 and 3 ran
    _assert_same_results(plain, resumed)
    # A rerun after the end restores the last segment and runs nothing.
    with segment_calls(monkeypatch, mod) as starts:
        again = runner.run_chains(SEEDS, spec, device="cpu", checkpointer=ck)
    assert starts == []
    _assert_same_results(plain, again)


def test_min_segments_raised_before_planning(tmp_path, monkeypatch):
    """The checkpointer's min_segments reaches plan_segments: one segment
    without it, four with it, and seg_outer is saved as planned."""
    spec = _spec("pallas_shared-board", n_steps=400, stride=100)
    with segment_calls(monkeypatch, board_shared) as starts:
        runner.run_chains(SEEDS, spec, device="cpu")
    assert starts == [0]
    ck = Checkpointer(str(tmp_path), min_segments=4)
    with segment_calls(monkeypatch, board_shared) as starts:
        runner.run_chains(SEEDS, spec, device="cpu", checkpointer=ck)
    assert starts == [0, 1, 2, 3]
    with np.load(ck.path) as data:
        assert int(data["seg_outer"]) == 1
        assert int(data["segments_done"]) == 4


@pytest.mark.parametrize("mcmc_type", ["board", "full_3d"])
def test_tempered_resume_bitwise(mcmc_type, tmp_path, monkeypatch):
    """A killed tempering search resumes bit for bit (carry and betas; the
    swap stream needs no saved state), runs only the remaining rounds, and a
    full resume returns the whole beta history."""
    sampler = f"pallas_shared-{mcmc_type}"
    mod = SAMPLERS[sampler][0]
    seeds = np.arange(8, dtype=np.uint32)
    spec = _spec(sampler, n_steps=400, stride=50)
    ladder = tempering.geometric_ladder(0.3, 3.0, 4)
    kw = dict(device="cpu", swap_seed=7, record_betas=True)
    want = tempering.run_tempered(seeds, spec, ladder, **kw)

    ckpt = Checkpointer(str(tmp_path), tag="pt")
    real, calls = mod.run_segment_tempered, {"n": 0}

    def dying(*args, **kw):
        if calls["n"] >= 2:
            raise Killed("simulated preemption")
        calls["n"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(mod, "run_segment_tempered", dying)
    with pytest.raises(Killed):
        tempering.run_tempered(seeds, spec, ladder, checkpointer=ckpt, **kw)
    monkeypatch.setattr(mod, "run_segment_tempered", real)
    with segment_calls(monkeypatch, mod, "run_segment_tempered") as starts:
        got = tempering.run_tempered(seeds, spec, ladder, checkpointer=ckpt,
                                     **kw)
    assert starts == list(range(2, 8))
    with segment_calls(monkeypatch, mod, "run_segment_tempered") as starts:
        again = tempering.run_tempered(seeds, spec, ladder,
                                       checkpointer=ckpt, **kw)
    assert starts == []
    for key in want:
        if key != "wall_time":
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            np.testing.assert_array_equal(again[key], want[key], err_msg=key)

    # Another ladder is another run: its fingerprint refuses the file.
    other = tempering.geometric_ladder(0.2, 4.0, 4)
    with segment_calls(monkeypatch, mod, "run_segment_tempered") as starts:
        fresh = tempering.run_tempered(seeds, spec, other, device="cpu",
                                       swap_seed=7, checkpointer=ckpt)
    assert starts == list(range(8))
    plain = tempering.run_tempered(seeds, spec, other, device="cpu",
                                   swap_seed=7)
    np.testing.assert_array_equal(fresh["energy_history"],
                                  plain["energy_history"])


def test_tempered_save_precedes_the_stop_check(tmp_path):
    """As in the JAX package, the round that meets ``stop_at_energy`` is
    saved before the search stops."""
    spec = _spec("pallas_shared-full_3d", n_steps=400, stride=50, N=4, Q=4)
    ladder = tempering.geometric_ladder(0.5, 3.0, 4)
    ck = Checkpointer(str(tmp_path), tag="stop")
    out = tempering.run_tempered(np.arange(8, dtype=np.uint32), spec, ladder,
                                 device="cpu", stop_at_energy=1000,
                                 checkpointer=ck)
    assert out["energy_history"].shape[1] == 2  # the start and round 1
    with np.load(ck.path) as data:
        assert int(data["segments_done"]) == 1
        assert data["extra_0"].dtype == np.float32


@dataclasses.dataclass(frozen=True)
class FakeCarry:
    x: torch.Tensor
    table: torch.Tensor = None


def test_checkpoint_history_io_is_linear(tmp_path):
    """Each history chunk is written once (O(total) I/O), not with every
    save (O(segments^2)); a throttled checkpointer still resumes well."""
    carry = FakeCarry(x=torch.zeros((4, 4), dtype=torch.int32))
    ck = Checkpointer(str(tmp_path), tag="lin", every=1)
    chunks = []
    n_segs, chunk = 12, np.arange(64, dtype=np.int32).reshape(8, 8)
    for seg in range(1, n_segs + 1):
        chunks.append(chunk.copy())
        ck.save(carry, seg, chunks, fingerprint="fp")
    assert ck.history_bytes_written == n_segs * chunk.nbytes
    restored = ck.restore(carry, fingerprint="fp")
    assert restored is not None
    got_carry, segs_done, got_chunks = restored
    assert segs_done == n_segs and len(got_chunks) == n_segs
    assert got_carry.table is None  # a None field stays None
    for c in got_chunks:
        np.testing.assert_array_equal(c, chunk)

    ck2 = Checkpointer(str(tmp_path), tag="thr", every=1,
                       min_interval_s=3600.0)
    for seg in range(1, 5):
        ck2.save(carry, seg, [chunk] * seg, fingerprint="fp")
    r2 = ck2.restore(carry, fingerprint="fp")
    assert r2 is not None and r2[1] == 1  # only the first save landed
    # every: only multiples are saved
    ck3 = Checkpointer(str(tmp_path), tag="ev", every=3)
    for seg in range(1, 5):
        ck3.save(carry, seg, [chunk] * seg, fingerprint="fp")
    assert ck3.restore(carry, fingerprint="fp")[1] == 3


def test_restored_leaves_match_the_template(tmp_path):
    """Every field comes back contiguous, on the template's device, with its
    dtype: the scan carry's int64 key words (saved as uint32) and its bool
    ``done``; the naive carry's ``table`` stays None."""
    for sampler in ("tables-board", "naive-board"):
        spec = _spec(sampler)
        keys = runner.rng_mod.chain_keys_from_seeds(SEEDS, "cpu")
        carry = board_chain.init_carry_batch(keys, spec, device="cpu")
        ck = Checkpointer(str(tmp_path), tag=sampler)
        ck.save(carry, 1, [np.zeros((1, 4), np.int32)], fingerprint="f")
        with np.load(ck.path) as data:
            assert data["carry_step_base"].dtype == np.uint32
            assert data["carry_done"].dtype == np.bool_
            assert ("carry_table" in data) == (sampler == "tables-board")
        got = ck.restore(carry, fingerprint="f")[0]
        for f in dataclasses.fields(carry):
            a, b = getattr(carry, f.name), getattr(got, f.name)
            if a is None:
                assert b is None
                continue
            assert b.dtype == a.dtype and b.device == a.device, f.name
            assert b.is_contiguous() and torch.equal(a, b), f.name


STALE = ("fingerprint", "shape", "seg_outer", "lost_chunk", "missing_extras",
         "dtype")


@pytest.mark.parametrize("kind", STALE)
def test_stale_checkpoint_is_ignored(kind, tmp_path):
    """A checkpoint of another run, shape, segmentation or dtype, with a
    lost chunk or without its extras, restores as None."""
    carry = FakeCarry(x=torch.arange(16, dtype=torch.int32).reshape(4, 4))
    ck = Checkpointer(str(tmp_path), tag="s")
    ck.save(carry, 2, [np.zeros(3, np.int32)] * 2, seg_outer=5,
            fingerprint="fp", extras=(np.ones(4, np.float32),))
    assert ck.restore(carry, seg_outer=5, fingerprint="fp",
                      n_extras=1) is not None
    template, seg_outer, fp, n_extras = carry, 5, "fp", 1
    if kind == "fingerprint":
        fp = "other"
    elif kind == "shape":
        template = FakeCarry(x=torch.zeros((6, 4), dtype=torch.int32))
    elif kind == "seg_outer":
        seg_outer = 4
    elif kind == "lost_chunk":
        os.unlink(ck.chunk_path(1, "fp"))
    elif kind == "missing_extras":
        n_extras = 2
    elif kind == "dtype":
        template = FakeCarry(x=torch.zeros((4, 4), dtype=torch.int64))
    assert ck.restore(template, seg_outer=seg_outer, fingerprint=fp,
                      n_extras=n_extras) is None


@pytest.mark.parametrize("change", ["chains", "seeds", "segments"])
def test_stale_run_starts_from_segment_zero(change, tmp_path, monkeypatch):
    """Through the runner: a checkpoint of another run under the same tag
    is ignored, and the run starts from segment 0 and equals a plain run."""
    spec = _spec("pallas_shared-board")
    runner.run_chains(SEEDS, spec, device="cpu",
                      checkpointer=Checkpointer(str(tmp_path), tag="x",
                                                min_segments=4))
    seeds, min_segments = SEEDS, 4
    if change == "chains":
        seeds = np.arange(6, dtype=np.uint32)
    elif change == "seeds":
        seeds = SEEDS + 100
    else:
        min_segments = 2
    ck = Checkpointer(str(tmp_path), tag="x", min_segments=min_segments)
    with segment_calls(monkeypatch, board_shared) as starts:
        fresh = runner.run_chains(seeds, spec, device="cpu", checkpointer=ck)
    assert starts[0] == 0
    _assert_same_results(runner.run_chains(
        seeds, spec, device="cpu", min_segments=min_segments), fresh)


def test_fingerprint_is_stable_across_processes():
    spec = _spec("pallas_shared-full_3d", n_steps=8_000_000, stride=62_500)
    seeds = 31337 + np.arange(64, dtype=np.uint32)
    ladder = tempering.geometric_ladder(0.8, 9.0, 16)
    here = extend_fingerprint(spec_fingerprint(spec, seeds), ladder,
                              np.uint32(31337), np.int64(1), np.bool_(False))
    code = (
        "import numpy as np\n"
        "from mcqueens_torch.chain.spec import ChainSpec\n"
        "from mcqueens_torch.core.schedules import build_schedule\n"
        "from mcqueens_torch.search.tempering import geometric_ladder\n"
        "from mcqueens_torch.utils.checkpoint import (extend_fingerprint,\n"
        "                                             spec_fingerprint)\n"
        "spec = ChainSpec(N=4, Q=12, n_steps=8_000_000, history_stride=62500,"
        " init_mode='random', kernel='pallas_shared', mcmc_type='full_3d',"
        " schedule=build_schedule('linear_annealing', 8_000_000,"
        " beta_start=0.5, beta_end=3.0))\n"
        "seeds = 31337 + np.arange(64, dtype=np.uint32)\n"
        "print(extend_fingerprint(spec_fingerprint(spec, seeds),"
        " geometric_ladder(0.8, 9.0, 16), np.uint32(31337), np.int64(1),"
        " np.bool_(False)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    assert out.stdout.strip() == here
    assert spec_fingerprint(spec, seeds + 1) != spec_fingerprint(spec, seeds)
    assert spec_fingerprint(dataclasses.replace(spec, n_bins=50),
                            seeds) != spec_fingerprint(spec, seeds)


class JaxKilledAfter(jcheckpoint.Checkpointer):
    def save(self, carry, segments_done, chunks, **kw):
        super().save(carry, segments_done, chunks, **kw)
        if segments_done == 2:
            raise Killed()


@pytest.mark.parametrize("kernel", ["tables", "pallas_shared"])
def test_checkpoint_files_match_the_jax_package(kernel, tmp_path):
    """N=5, 8 chains, 4 segments, killed after segment 2 in both packages:
    the same npz keys, every array except ``fingerprint`` equal bitwise
    (the port's key words as uint32, as JAX saves ``key_data``)."""
    n, seeds = 200, np.arange(8, dtype=np.uint32) + 3
    kw = dict(N=5, n_steps=n, init_mode="random", mcmc_type="board",
              kernel=kernel, history_stride=50)
    jspec = JaxSpec(schedule=jschedules.build_schedule(n_steps=n, **LIN),
                    **kw)
    spec = ChainSpec(schedule=schedules.build_schedule(n_steps=n, **LIN),
                     **kw)
    jck = JaxKilledAfter(str(tmp_path / "jax"), min_segments=4)
    with pytest.raises(Killed), pltpu.force_tpu_interpret_mode():
        jrunner.run_chains(seeds, jspec, checkpointer=jck)
    ck = KilledAfter(str(tmp_path / "torch"), kill_at=2, min_segments=4)
    with pytest.raises(Killed):
        runner.run_chains(seeds, spec, device="cpu", checkpointer=ck)
    with np.load(jck.path) as want, np.load(ck.path) as got:
        assert sorted(want.files) == sorted(got.files)
        for key in want.files:
            if key == "fingerprint":
                continue
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert int(got["segments_done"]) == 2
    # The history chunks equal too, though their names carry each
    # package's own fingerprint.
    for i in range(2):
        np.testing.assert_array_equal(
            np.load(ck.chunk_path(i, str(np.load(ck.path)["fingerprint"]))),
            np.load(jck.chunk_path(i, str(np.load(jck.path)["fingerprint"]))))


def _export(d):
    (path,) = sorted((d / "competition_results").glob("*.txt"))
    return path.read_text()


def test_competition_checkpoint_resume(tmp_path, monkeypatch):
    """--checkpoint-dir: a rerun resumes and reproduces the export."""
    common = ["--n", "5", "--n-runs", "2", "--n-steps", "300",
              "--history-stride", "50", "--device", "cpu"]

    def cli(argv):
        with contextlib.redirect_stdout(io.StringIO()):
            assert competition.main(argv) == 0

    cli(common + ["--outdir", str(tmp_path / "plain")])
    cli(common + ["--outdir", str(tmp_path / "ck"),
                  "--checkpoint-dir", str(tmp_path / "ckpt")])
    (npz,) = (tmp_path / "ckpt").glob("*.npz")
    assert npz.name == ("competition_board_N5_r2_st300_b1-3_s42_tables"
                        ".npz")
    with segment_calls(monkeypatch, board_chain) as starts:
        cli(common + ["--outdir", str(tmp_path / "ck2"),
                      "--checkpoint-dir", str(tmp_path / "ckpt")])
    # The CLI saves at most every 30 s, so the file holds the first of its
    # six segments: the rerun resumes after it.
    assert starts == [1, 2, 3, 4, 5]
    assert _export(tmp_path / "plain") == _export(tmp_path / "ck")
    assert _export(tmp_path / "plain") == _export(tmp_path / "ck2")


def test_competition_tempered_checkpoint_resume(tmp_path, monkeypatch):
    """--checkpoint-dir with --tempering: killed after two rounds, the rerun
    resumes from its last save and exports the uninterrupted board."""
    common = ["--n", "4", "--mcmc-type", "full_3d", "--q", "10",
              "--n-runs", "8", "--n-steps", "200", "--history-stride", "50",
              "--kernel", "pallas_shared", "--tempering", "4",
              "--device", "cpu"]

    def cli(argv):
        with contextlib.redirect_stdout(io.StringIO()):
            assert competition.main(argv) == 0

    cli(common + ["--outdir", str(tmp_path / "plain")])
    real, calls = full3d_shared.run_segment_tempered, {"n": 0}

    def dying(*args, **kw):
        if calls["n"] >= 2:
            raise Killed()
        calls["n"] += 1
        return real(*args, **kw)

    ckpt = ["--checkpoint-dir", str(tmp_path / "ckpt")]
    monkeypatch.setattr(full3d_shared, "run_segment_tempered", dying)
    with pytest.raises(Killed):
        cli(common + ckpt + ["--outdir", str(tmp_path / "killed")])
    monkeypatch.setattr(full3d_shared, "run_segment_tempered", real)
    with segment_calls(monkeypatch, full3d_shared,
                       "run_segment_tempered") as starts:
        cli(common + ckpt + ["--outdir", str(tmp_path / "resumed")])
    assert starts == [1, 2, 3]  # the 30 s floor kept round 1's save only
    assert _export(tmp_path / "plain") == _export(tmp_path / "resumed")


def _single_n_config(tmp_path, **tpu):
    raw = {
        "experiment_type": "single_N",
        "common": {"n_steps": 200, "n_runs": 3, "verbose": False,
                   "initialization": "random", "mcmc_type": "board",
                   "early_stop_patience": 100000,
                   "betta_scheduling": {"type": "linear_annealing",
                                        "base_seed": 42,
                                        "beta_start": 1.0, "beta_end": 3.0},
                   "output_path": "figures/out.png"},
        "single_N": {"N": 5},
        "tpu": {"kernel": "pallas", "history_stride": 20, **tpu},
    }
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_experiment_with_checkpoint(tmp_path, monkeypatch):
    """tpu.checkpoint_dir: one checkpoint a sweep cell under the JAX
    package's tag; a rerun resumes from the completed checkpoint."""
    cfg = _single_n_config(tmp_path, checkpoint_dir=str(tmp_path / "ckpt"))
    argv = ["--config", cfg, "--outdir", str(tmp_path), "--device", "cpu"]
    assert exp_cli.main(argv) == 0
    assert (tmp_path / "figures" / "out.png").exists()
    ckpts = list((tmp_path / "ckpt").glob("*.npz"))
    assert [p.name for p in ckpts] == ["board_N5_random_linear_annealing_s42"
                                       ".npz"]
    with segment_calls(monkeypatch, metropolis_pallas) as starts:
        assert exp_cli.main(argv) == 0
    assert starts == []


def test_experiment_checkpoint_resumes_killed_cell(tmp_path, monkeypatch):
    """A sweep cell killed mid-run resumes through drivers.run_from_config
    and equals the uninterrupted cell."""
    from mcqueens_torch.experiments import drivers
    from mcqueens_torch.experiments.config import load_config

    plain = drivers.run_from_config(load_config(_single_n_config(tmp_path)),
                                    device="cpu", plot=False)["result"]
    cfg = load_config(_single_n_config(tmp_path,
                                       checkpoint_dir=str(tmp_path / "ck")))
    real = Checkpointer.save

    def save(self, carry, segments_done, chunks, **kw):
        real(self, carry, segments_done, chunks, **kw)
        if segments_done == 1:
            raise Killed()

    monkeypatch.setattr(Checkpointer, "save", save)
    with pytest.raises(Killed):
        drivers.run_from_config(cfg, device="cpu", plot=False)
    monkeypatch.setattr(Checkpointer, "save", real)
    with segment_calls(monkeypatch, metropolis_pallas) as starts:
        got = drivers.run_from_config(cfg, device="cpu", plot=False)["result"]
    assert starts == [5]  # 2 segments of five 20-step chunks
    _assert_same_results(plain, got)
