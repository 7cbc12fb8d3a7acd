"""Parity of the port's shared-site board path with the JAX package (CPU).

The JAX side runs its Pallas kernel in interpret mode, as
``tests/test_shared_kernel.py`` does; the port runs the kernel's plain-torch
twin (``segment_reference``), which ``chip_smoke.py`` holds against the CUDA
kernel on the card.  Tolerance: none.  Every array is compared bitwise; the
one allowed exception, an accept test landing within one float32 ulp of
``exp(-beta * dE)``, has not occurred in these runs (it would show as a
mismatch here and be logged in ROADMAP.md queue 3).
"""

import contextlib
import glob
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mcqueens.chain.spec import ChainSpec as JaxSpec
from mcqueens.cli import competition as jax_competition
from mcqueens.core import schedules as jschedules
from mcqueens.dist import runner as jrunner
from mcqueens.kernels import board_shared as jbs
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.cli import competition
from mcqueens_torch.core import schedules
from mcqueens_torch.dist import runner
from mcqueens_torch.kernels import board_shared, segment
from mcqueens_torch.kernels.carry import carry_from_numpy, carry_to_numpy
from tests import _oracle
from tests.test_torch_foundations import release_jax_executables  # noqa: F401

RESULT_FIELDS = ("energy_history", "history_steps", "history_len",
                 "final_energy", "final_state", "best_energy", "best_state",
                 "steps_to_best", "stop_step", "accept_bins", "total_bins")

# name -> (ChainSpec kwargs, schedule kwargs)
CASES = {
    "n5": (dict(N=5, n_steps=400),
           dict(sched_type="linear_annealing", beta_start=0.5, beta_end=3.0)),
    # 330 steps: the last 50-step chunk runs 20 steps past n_steps, which
    # must change nothing (bins included).
    "n16": (dict(N=16, n_steps=330),
            dict(sched_type="linear_annealing", beta_start=0.5,
                 beta_end=3.0)),
    "early_stop": (dict(N=5, n_steps=300, early_stop_patience=40),
                   dict(sched_type="constant", beta_const=50.0)),
}
SEEDS = 3 + np.arange(8, dtype=np.uint32)


def _specs(case, **over):
    case_kw, sched = CASES[case]
    kw = dict(init_mode="random", mcmc_type="board", kernel="pallas_shared",
              history_stride=50)
    kw.update(case_kw)
    kw.update(over)
    return (
        JaxSpec(schedule=jschedules.build_schedule(n_steps=kw["n_steps"],
                                                   **sched), **kw),
        ChainSpec(schedule=schedules.build_schedule(n_steps=kw["n_steps"],
                                                    **sched), **kw),
    )


def _jax_run(spec, **kw):
    with pltpu.force_tpu_interpret_mode():
        return jrunner.run_chains(SEEDS, spec, **kw)


def _assert_same_results(want, got):
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def _assert_same_carry(want, got):
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    got = carry_to_numpy(got)
    assert set(want) == set(got)
    for name in want:
        assert got[name].dtype == np.int32, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.fixture(scope="module")
def jax_n5():
    """The JAX N=5 run, shared by the tests that extend or resume it."""
    return _jax_run(_specs("n5")[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_chains_parity(case, jax_n5):
    jspec, spec = _specs(case)
    want = jax_n5 if case == "n5" else _jax_run(jspec)
    got = runner.run_chains(SEEDS, spec, device="cpu")
    _assert_same_results(want, got)
    assert got.device == "cpu"
    if case == "early_stop":
        assert (got.stop_step < spec.n_steps).any()
    for r in range(got.n_runs):
        assert got.best_energy[r] == _oracle.board_energy(got.best_state[r])
    assert (got.total_bins.sum(axis=1) <= spec.n_steps).all()


def test_run_chains_warm_start_parity():
    jspec, spec = _specs("n5")
    starts = np.random.default_rng(2).integers(0, 5, size=(8, 5, 5))
    want = _jax_run(jspec, initial_states=starts)
    got = runner.run_chains(SEEDS, spec, device="cpu", initial_states=starts)
    _assert_same_results(want, got)
    for r in range(8):
        assert got.energy_history[r, 0] == _oracle.board_energy(starts[r])


def test_multi_block_segment_and_carry_resume_parity():
    """Three 128-chain blocks (block seeds, per-block site streams), and a
    carry crossing over: 200 JAX steps, then 200 port steps == 400 JAX
    steps."""
    jspec, spec = _specs("n5", history_stride=200)
    seeds = np.arange(384, dtype=np.uint32) * 7
    with pltpu.force_tpu_interpret_mode():
        jcarry = jbs.init_carry_batch(seeds, jspec, block=128)
        jmid, jys1 = jbs.run_segment(jcarry, np.int32(0), jspec, 1)
        jend, jys2 = jbs.run_segment(jmid, np.int32(1), jspec, 1)
    jys = np.concatenate([np.asarray(jys1), np.asarray(jys2)])
    carry = board_shared.init_carry_batch(seeds, spec, block=128,
                                          device="cpu")
    assert carry.block_seeds.shape == (3, 1)
    _assert_same_carry(jcarry, carry)
    end, ys = board_shared.run_segment(carry, 0, spec, 2)
    _assert_same_carry(jend, end)
    np.testing.assert_array_equal(ys.numpy(), jys)

    mid = carry_from_numpy({k: np.asarray(v)
                            for k, v in jmid._asdict().items()}, "cpu")
    resumed, ys2 = board_shared.run_segment(mid, 1, spec, 1)
    _assert_same_carry(jend, resumed)
    np.testing.assert_array_equal(ys2.numpy(), np.asarray(jys2))
    # and back: the numpy round trip is lossless
    _assert_same_carry(jend, carry_from_numpy(carry_to_numpy(resumed),
                                              "cpu"))
    with pytest.raises(ValueError, match="lack fields"):
        carry_from_numpy({"heights": np.zeros((1, 1), np.int32)}, "cpu")


def test_padding_seeds_and_warm_starts_match():
    """10 runs pad to one 128-chain block: seeds seeds[-1]+1.. (uint32
    wrap), warm starts repeat the last board."""
    jspec, spec = _specs("n5")
    seeds = np.arange(2 ** 32 - 5, 2 ** 32 + 5, dtype=np.uint64).astype(
        np.uint32)
    starts = np.random.default_rng(5).integers(0, 5, size=(10, 5, 5))
    for kw in ({}, {"initial_states": starts}):
        want = jbs.init_carry_batch(seeds, jspec, **kw)
        got = board_shared.init_carry_batch(seeds, spec, device="cpu", **kw)
        _assert_same_carry(want, got)


def test_steps_past_n_steps_change_nothing():
    _, spec = _specs("n16")
    carry = board_shared.init_carry_batch(SEEDS, spec, device="cpu")
    carry, _ = board_shared.run_segment(carry, 0, spec, spec.n_outer)
    after, ys = board_shared.run_segment(carry, spec.n_outer, spec, 2)
    for name, want in carry_to_numpy(carry).items():
        np.testing.assert_array_equal(carry_to_numpy(after)[name], want)
    assert (ys.numpy() == carry.energy.numpy().reshape(-1)).all()


def test_klarner_stays_optimal():
    spec = ChainSpec(N=11, n_steps=60, init_mode="klarner",
                     schedule=schedules.build_schedule("constant", 60,
                                                       beta_const=100.0),
                     kernel="pallas_shared", history_stride=60)
    res = runner.run_chains(np.arange(2, dtype=np.uint32), spec,
                            device="cpu")
    assert (res.energy_history == 0).all() and (res.best_energy == 0).all()


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _exported(outdir):
    (path,) = glob.glob(os.path.join(outdir, "competition_results",
                                     "best_heights_6_*.txt"))
    with open(path) as f:
        return f.read()


def test_competition_cli_parity(tmp_path):
    """The whole slice: both CLIs export the same board.  A 50-step
    history stride keeps the JAX interpret-mode run short."""
    argv = ["--kernel", "pallas_shared", "--n", "6", "--n-runs", "8",
            "--n-steps", "400", "--history-stride", "50"]
    with pltpu.force_tpu_interpret_mode():
        jout = _cli(jax_competition.main, argv + ["--outdir",
                                                  str(tmp_path / "jax")])
    out = _cli(competition.main, argv + ["--device", "cpu", "--outdir",
                                         str(tmp_path / "torch")])
    board = _exported(tmp_path / "torch")
    assert board == _exported(tmp_path / "jax")

    def best_line(text):
        return next(ln for ln in text.splitlines()
                    if ln.startswith("Best energies"))

    assert best_line(out) == best_line(jout)
    best = np.zeros((6, 6), np.int64)
    for line in board.splitlines():
        i, j, k = map(int, line.split(","))
        best[i, j] = k
    best_e = _oracle.board_energy(best)
    assert f"Best energies: [{best_e}," in out
    # warm start from the exported board
    resume = str(tmp_path / "torch" / "competition_results" / "start.txt")
    with open(resume, "w") as f:
        f.write(board)
    out2 = _cli(competition.main, argv + [
        "--device", "cpu", "--resume-from", resume, "--outdir",
        str(tmp_path / "resume")])
    assert int(best_line(out2).split("[")[1].split(",")[0]) <= best_e


@pytest.mark.parametrize("flags", [
    ["--tempering", "4", "--mesh"], ["--mesh"],
    # --checkpoint-dir runs (tests/test_torch_checkpoint.py), and so does
    # the mesh beside it (tests/test_torch_mesh.py)
    ["--checkpoint-dir", "ck", "--mesh"],
    ["--mcmc-type", "full_3d", "--checkpoint-dir", "ck", "--mesh"],
    ["--q", "5"],
    # the scan kernels run (the default is tables); tempering still needs
    # pallas_shared
    ["--kernel", "tables", "--tempering", "4"],
    ["--exchange-interval", "3", "--kernel", "naive", "--mesh"],
])
def test_cli_refuses_unported_flags(flags, tmp_path, monkeypatch):
    """Tempering without pallas_shared and --q on a board are refused, as in
    the JAX CLI; every other case runs, small, and --mesh (one CPU shard)
    prints and exports what the same run without it does."""
    argv = ["--n", "5", "--device", "cpu"] + flags
    if "--tempering" in flags or "--q" in flags:
        with pytest.raises(SystemExit) as exc:
            competition.main(argv)
        assert exc.value.code == 2
        return
    monkeypatch.chdir(tmp_path)
    small = ["--n-runs", "3", "--n-steps", "60"]
    # the plain run keeps its own checkpoint directory, or the mesh run
    # would resume from its last save
    plain = ["ck0" if f == "ck" else f for f in argv if f != "--mesh"]
    want = _cli(competition.main, plain + small + ["--outdir", "a"])
    got = _cli(competition.main, argv + small + ["--outdir", "b"])

    def steady(text):  # the lines that hold no wall time or path
        return [line for line in text.splitlines()
                if "proposals in" not in line and "wrote" not in line]

    assert steady(want) == steady(got) and "Best energies" in got
    (a,) = (tmp_path / "a" / "competition_results").glob("*.txt")
    (b,) = (tmp_path / "b" / "competition_results").glob("*.txt")
    assert a.read_text() == b.read_text()


def test_runner_refuses_unported_paths():
    _, spec = _specs("n5")
    # checkpointer= and profile_dir= run now (tests/test_torch_checkpoint.py,
    # tests/test_torch_profiling.py).
    # mesh= runs (tests/test_torch_mesh.py); a mesh of another device type
    # than the run's is refused.
    with pytest.raises(ValueError, match="disagree"):
        runner.run_chains(SEEDS, spec, device="cpu", mesh=["cuda:0"])
    # Every sampler is ported: the per-chain kernel="pallas" and the scan
    # kernels "tables" and "naive" run, for boards and full-3D placements.
    for other in (dict(kernel="pallas"),
                  dict(kernel="pallas", mcmc_type="full_3d"),
                  dict(kernel="tables"), dict(kernel="naive"),
                  dict(kernel="tables", mcmc_type="full_3d"),
                  dict(kernel="naive", mcmc_type="full_3d")):
        n = 400 if other["kernel"] == "pallas" else 100
        res = runner.run_chains(SEEDS, _specs("n5", n_steps=n, **other)[1],
                                device="cpu")
        assert res.energy_history.shape == (8, n // 50 + 1)
        assert (res.total_bins.sum(1) == n).all()


def test_cuda_request_without_gpu_raises():
    """No fallback: asking for CUDA where there is none is an error."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; chip_smoke.py covers the CUDA path")
    _, spec = _specs("n5")
    with pytest.raises(RuntimeError, match="cuda"):
        runner.run_chains(SEEDS, spec, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        competition.main(["--n", "5", "--n-runs", "2", "--n-steps", "10"])
    st = board_shared.segment_state(
        board_shared.init_carry_batch(SEEDS, spec, device="cpu"))
    st = board_shared.SegmentState(**{
        k: v.to("meta") for k, v in vars(st).items()})
    with pytest.raises(ValueError, match="cpu or cuda"):
        segment.call(board_shared, st, 0, 50, spec)


# -- freeze mode: track_best=False and recover_best_heights ---------------


@pytest.mark.parametrize("case", ["n5", "early_stop"])
def test_frozen_segment_parity(case):
    """Per-chain horizons at 0, inside the run, at and past n_steps (and
    with patience): the freeze mode equals JAX's on every field."""
    jspec, spec = _specs(case)
    carry = board_shared.init_carry_batch(SEEDS, spec, device="cpu")
    C = carry.energy.shape[0]
    freeze = np.random.default_rng(9).integers(
        0, spec.n_steps + 60, C).astype(np.int32)
    freeze[:4] = [0, 1, spec.n_steps, 2 ** 31 - 1]
    with pltpu.force_tpu_interpret_mode():
        want = jbs._run_segment_frozen(
            jbs.init_carry_batch(SEEDS, jspec), jnp.asarray(freeze[None]),
            np.int32(0), jspec, jspec.n_outer)
    got = board_shared._run_segment_frozen(carry, freeze, 0, spec,
                                           spec.n_outer)
    _assert_same_carry(want, got)
    assert int(got.total_bins[0].sum()) == 0
    if case == "early_stop":
        assert (got.stop_step < spec.n_steps).any()


def test_untracked_run_and_recover_best_heights(jax_n5):
    """track_best=False equals JAX's untracked run (best boards left as
    initialised, everything else exact); the replay recovers JAX's boards,
    which are the tracked run's best boards."""
    jspec, spec = _specs("n5")
    with pltpu.force_tpu_interpret_mode():
        ju, jys = jbs.run_segment(jbs.init_carry_batch(SEEDS, jspec),
                                  np.int32(0), jspec, jspec.n_outer,
                                  track_best=False)
        jrec = jbs.recover_best_heights(ju, jspec)
    u, ys = board_shared.run_segment(
        board_shared.init_carry_batch(SEEDS, spec, device="cpu"), 0, spec,
        spec.n_outer, track_best=False)
    _assert_same_carry(ju, u)
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    rec = board_shared.recover_best_heights(u, spec)
    assert rec.dtype == torch.int32 and rec.shape == (128, 5, 5)
    np.testing.assert_array_equal(rec.numpy(), jrec)
    np.testing.assert_array_equal(rec[:8].numpy(), jax_n5.best_state)
    for r in range(8):
        assert _oracle.board_energy(rec[r].numpy()) == jax_n5.best_energy[r]


def test_recover_best_heights_warm_start_and_verify():
    """The replay needs the run's warm starts: with them it equals the
    tracked boards (and JAX's replay); without them it raises."""
    jspec, spec = _specs("n5", n_steps=200)
    starts = np.random.default_rng(11).integers(0, 5, size=(8, 5, 5))
    tracked, _ = board_shared.run_segment(
        board_shared.init_carry_batch(SEEDS, spec, initial_states=starts,
                                      device="cpu"), 0, spec, spec.n_outer)
    rec = board_shared.recover_best_heights(tracked, spec,
                                            initial_states=starts)
    assert torch.equal(rec, tracked.best_heights.reshape(-1, 5, 5))
    with pltpu.force_tpu_interpret_mode():
        jtracked, _ = jbs.run_segment(
            jbs.init_carry_batch(SEEDS, jspec, initial_states=starts),
            np.int32(0), jspec, jspec.n_outer)
        jrec = jbs.recover_best_heights(jtracked, jspec,
                                        initial_states=starts)
    np.testing.assert_array_equal(rec.numpy(), jrec)
    with pytest.raises(AssertionError, match="replay mismatch"):
        board_shared.recover_best_heights(tracked, spec)
    # verify=False skips the check and returns the (wrong) replay
    assert board_shared.recover_best_heights(
        tracked, spec, verify=False).shape == rec.shape


# -- the CUDA kernel's layout rule (kernels/board_shared.py:layout) --------


@pytest.mark.parametrize("track_best", [True, False])
@pytest.mark.parametrize("C, lanes, cpb", [(256, 8, 4), (4096, 8, 32),
                                           (32768, 4, 128)])
def test_layout_rule_n16(C, lanes, cpb, track_best):
    """N=16 on 132 SMs: large teams when chains are few, small ones when
    they are many, every chain resident in one wave, boards in a CTA's
    shared memory, and CTAs that never straddle a semantic block."""
    from mcqueens_torch.kernels import _build

    lay = board_shared.layout(16, C, 132, track_best)
    assert (lay.lanes, lay.chains_per_cta) == (lanes, cpb)
    assert lay.in_shared
    assert lay.smem_bytes == board_shared.cta_smem_bytes(16, cpb, track_best)
    assert lay.smem_bytes <= _build.SMEM_PER_BLOCK
    assert 132 * board_shared._resident(lanes, cpb, lay.smem_bytes) >= C
    assert (lanes * cpb) % 32 == 0 and lanes * cpb <= 1024
    _, spec = _specs("n16")
    assert board_shared.block_size(C, spec) % cpb == 0


def test_layout_slot_bytes():
    """A row is N rounded up to an odd number of words, a slot an odd
    number of words (bank spread); freeze-mode slots hold no best board."""
    assert board_shared.row_pitch(16) == 20
    assert board_shared.row_pitch(5) == 12
    assert board_shared.slot_bytes(16, True) == 4 * 161
    assert board_shared.slot_bytes(16, False) == 4 * 81
    for N in (2, 5, 11, 16, 33, 127):
        for track in (True, False):
            assert board_shared.slot_bytes(N, track) // 4 % 2 == 1


@pytest.mark.parametrize("C", [16, 256, 4096, 32768])
def test_layout_device_instance_above_n127(C):
    """N=128 does not fit a byte: the device-memory instance, no shared
    memory; N=127 still keeps its boards in shared memory."""
    for track in (True, False):
        lay = board_shared.layout(128, C, 132, track)
        assert not lay.in_shared and lay.smem_bytes == 0
        assert 132 * board_shared._resident(lay.lanes, lay.chains_per_cta,
                                            0) >= min(C, 132 * 128)
        assert board_shared.layout(127, C, 132, track).in_shared
