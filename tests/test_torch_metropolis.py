"""Parity of the port's per-chain board sampler with the JAX package (CPU).

The JAX side runs its Pallas kernel (``metropolis_pallas._kernel``) in
interpret mode, as ``tests/test_pallas.py`` does; the port runs the kernel's
plain-torch twin (``segment_reference``), which ``chip_smoke.py`` holds
against the CUDA kernel on the card.  Inputs are made from numpy seeds.
Tolerance: none; every carry field, ``ys`` row and ``ChainResult`` field is
compared bitwise.  The transcendental schedules' beta may differ from XLA's
by up to 2 ulp (ROADMAP.md queue 3); their runs here are compared bitwise
all the same, and a divergence would be logged there.
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
from mcqueens.kernels import delta_e as jdelta_e
from mcqueens.kernels import metropolis_pallas as jmp
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.cli import competition
from mcqueens_torch.core import schedules
from mcqueens_torch.dist import runner
from mcqueens_torch.kernels import delta_e, metropolis_pallas, segment
from mcqueens_torch.kernels.carry import (FIELDS, carry_from_numpy,
                                          carry_to_numpy)
from tests import _oracle
from tests.test_torch_foundations import release_jax_executables  # noqa: F401

RESULT_FIELDS = ("energy_history", "history_steps", "history_len",
                 "final_energy", "final_state", "best_energy", "best_state",
                 "steps_to_best", "stop_step", "accept_bins", "total_bins")
LINEAR = dict(sched_type="linear_annealing", beta_start=0.5, beta_end=3.0)

# name -> (ChainSpec kwargs, schedule kwargs, chains)
CASES = {
    "n5_linear": (dict(N=5, n_steps=400), LINEAR, 8),
    "n2": (dict(N=2, n_steps=300), LINEAR, 8),
    "patience": (dict(N=5, n_steps=400, early_stop_patience=40),
                 dict(sched_type="constant", beta_const=50.0), 8),
    "klarner_beta100": (dict(N=11, n_steps=150, init_mode="klarner"),
                        dict(sched_type="constant", beta_const=100.0), 4),
    # 20 runs pad to one 128-chain block.
    "padded_20": (dict(N=6, n_steps=200),
                  dict(sched_type="exponential_annealing", beta_start=0.5,
                       beta_end=3.0), 20),
    # 7 bins over 350 steps: bins narrower than the JAX kernel's 8-step
    # unroll group take its exact per-step path.
    "narrow_bins": (dict(N=4, n_steps=350, n_bins=70),
                    dict(sched_type="sinusoidal_annealing", beta_start=0.5,
                         beta_end=3.0), 8),
    # A 1024-step chunk: the JAX kernel's 32-step unroll with split bins.
    "chunk_1024": (dict(N=4, n_steps=2100, history_stride=1024),
                   dict(sched_type="logarithmic_annealing", beta_start=0.5,
                        beta_end=3.0), 8),
}


def _specs(case, **over):
    case_kw, sched, _ = CASES[case]
    kw = dict(init_mode="random", mcmc_type="board", kernel="pallas",
              history_stride=50)
    kw.update(case_kw)
    kw.update(over)
    return (
        JaxSpec(schedule=jschedules.build_schedule(n_steps=kw["n_steps"],
                                                   **sched), **kw),
        ChainSpec(schedule=schedules.build_schedule(n_steps=kw["n_steps"],
                                                    **sched), **kw),
    )


def _seeds(case):
    return 3 + np.arange(CASES[case][2], dtype=np.uint32)


def _assert_same_carry(want, got):
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    got = carry_to_numpy(got)
    assert tuple(got) == FIELDS == tuple(want)
    for name in want:
        assert got[name].dtype == np.int32, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _assert_same_results(want, got):
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


# -- the dense delta-E identity -------------------------------------------


@pytest.mark.parametrize("N", [3, 4, 5])
def test_dense_delta_e_matches_jax_exhaustively(N):
    """Every site and every move of a random board, as one batch."""
    h = np.random.default_rng(N).integers(0, N, size=N * N).astype(np.int32)
    rows = [(i, j, int(h[i * N + j]), k) for i in range(N)
            for j in range(N) for k in range(N) if k != h[i * N + j]]
    i, j, old, new = (np.array(c, np.int32)[:, None] for c in zip(*rows))
    hs = np.repeat(h[None], len(rows), axis=0)
    cell = np.arange(N * N, dtype=np.int32)
    want = np.asarray(jdelta_e.board_delta_e_dense(
        jnp.asarray(hs), jnp.asarray(cell // N), jnp.asarray(cell % N),
        *map(jnp.asarray, (i, j, old, new))))
    t = torch.from_numpy
    got = delta_e.board_delta_e_dense(t(hs), t(cell // N), t(cell % N),
                                      t(i), t(j), t(old), t(new))
    assert got.dtype == torch.int32 and got.shape == (len(rows), 1)
    np.testing.assert_array_equal(got.numpy(), want)
    for r in range(0, len(rows), 7):
        moved = h.reshape(N, N).copy()
        moved[i[r, 0], j[r, 0]] = new[r, 0]
        assert int(got[r, 0]) == (_oracle.board_energy(moved)
                                  - _oracle.board_energy(h.reshape(N, N)))


# -- partition and carry --------------------------------------------------


@pytest.mark.parametrize("N,n", [(5, 8), (16, 32768), (20, 4096),
                                 (32, 128), (32, 5000), (2, 1), (90, 3000)])
def test_block_sizes_match(N, n):
    jspec, spec = _specs("n5_linear", N=N)
    assert metropolis_pallas.block_size(n, spec) == jmp.block_size(n, jspec)
    assert metropolis_pallas.padded_chains(n, spec) == jmp.padded_chains(
        n, jspec)
    assert metropolis_pallas.block_size(n) == jmp.block_size(n)


@pytest.mark.parametrize("N,n,block", [(5, 10, None), (16, 300, None),
                                       (3, 384, 128), (2, 1, None)])
def test_init_carry_batch_matches_jax(N, n, block):
    """Padding seeds ``seeds[-1] + 1..`` (uint32 wrap), block seeds, warm
    starts repeating the last board."""
    jspec, spec = _specs("n5_linear", N=N)
    seeds = (np.arange(n, dtype=np.uint64) + 2 ** 32 - 5).astype(np.uint32)
    starts = np.random.default_rng(N).integers(0, N, size=(n, N, N))
    for kw in ({}, {"initial_states": starts}):
        want = jmp.init_carry_batch(seeds, jspec, block=block, **kw)
        got = metropolis_pallas.init_carry_batch(seeds, spec, block=block,
                                                 device="cpu", **kw)
        _assert_same_carry(want, got)


# -- the sampler ----------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_segment_parity(case):
    """Carry after every chunk and the ys rows, bitwise."""
    jspec, spec = _specs(case)
    seeds = _seeds(case)
    with pltpu.force_tpu_interpret_mode():
        jcarry = jmp.init_carry_batch(seeds, jspec)
        jend, jys = jmp.run_segment(jcarry, np.int32(0), jspec,
                                    jspec.n_outer)
    carry = metropolis_pallas.init_carry_batch(seeds, spec, device="cpu")
    _assert_same_carry(jcarry, carry)
    end, ys = metropolis_pallas.run_segment(carry, 0, spec, spec.n_outer)
    _assert_same_carry(jend, end)
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    # the input carry is left as it was
    _assert_same_carry(jcarry, carry)
    C = end.energy.shape[0]
    assert C == metropolis_pallas.padded_chains(len(seeds), spec)
    if case == "patience":
        assert (end.stop_step < spec.n_steps).any()
    if case == "klarner_beta100":
        assert not end.energy.any() and not end.best_energy.any()
    for r in range(C):
        assert int(end.best_energy[r]) == _oracle.board_energy(
            end.best_heights[r].numpy().reshape(spec.N, spec.N))
    assert (end.total_bins.sum(1) <= spec.n_steps).all()


def test_run_chains_parity_with_warm_start():
    """The runner's ``ChainResult`` fields, cold and warm-started."""
    jspec, spec = _specs("n5_linear")
    seeds = _seeds("n5_linear")
    starts = np.random.default_rng(2).integers(0, 5, size=(8, 5, 5))
    for kw in ({}, {"initial_states": starts}):
        with pltpu.force_tpu_interpret_mode():
            want = jrunner.run_chains(seeds, jspec, **kw)
        got = runner.run_chains(seeds, spec, device="cpu", **kw)
        _assert_same_results(want, got)
        assert got.device == "cpu"
        for r in range(got.n_runs):
            assert got.best_energy[r] == _oracle.board_energy(
                got.best_state[r])
            assert got.final_energy[r] == _oracle.board_energy(
                got.final_state[r])
    np.testing.assert_array_equal(
        got.energy_history[:, 0], [_oracle.board_energy(s) for s in starts])


def test_block_partition_does_not_change_trajectories():
    """Per-chain streams: 256 chains as two blocks of 128 or one of 256 run
    the same chains; only the block seeds differ."""
    _, spec = _specs("n5_linear", history_stride=100)
    seeds = np.arange(256, dtype=np.uint32) * 11
    ends = []
    for block in (128, 256):
        carry = metropolis_pallas.init_carry_batch(seeds, spec, block=block,
                                                   device="cpu")
        ends.append(metropolis_pallas.run_segment(carry, 0, spec, 4))
    (a, ys_a), (b, ys_b) = ends
    assert a.block_seeds.shape == (2, 1) and b.block_seeds.shape == (1, 1)
    for name in FIELDS[1:]:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(ys_a, ys_b)


def test_jax_carry_resumes_in_port():
    """Two JAX chunks == one JAX chunk, its carry crossing into the port,
    and one port chunk; and back through numpy."""
    jspec, spec = _specs("n5_linear", history_stride=200)
    seeds = np.arange(20, dtype=np.uint32) * 7
    with pltpu.force_tpu_interpret_mode():
        jcarry = jmp.init_carry_batch(seeds, jspec)
        jmid, _ = jmp.run_segment(jcarry, np.int32(0), jspec, 1)
        jend, jys2 = jmp.run_segment(jmid, np.int32(1), jspec, 1)
    resumed, ys = metropolis_pallas.run_segment(carry_from_numpy(jmid, "cpu"),
                                                1, spec, 1)
    _assert_same_carry(jend, resumed)
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys2))
    _assert_same_carry(jend, carry_from_numpy(carry_to_numpy(resumed), "cpu"))


def test_steps_past_n_steps_change_nothing():
    _, spec = _specs("n2")
    carry = metropolis_pallas.init_carry_batch(_seeds("n2"), spec,
                                               device="cpu")
    carry, _ = metropolis_pallas.run_segment(carry, 0, spec, spec.n_outer)
    after, ys = metropolis_pallas.run_segment(carry, spec.n_outer, spec, 2)
    for name, want in carry_to_numpy(carry).items():
        np.testing.assert_array_equal(carry_to_numpy(after)[name], want)
    assert (ys.numpy() == carry.energy.numpy().reshape(-1)).all()


def test_segment_call_refuses_other_devices_and_cuda_guards():
    _, spec = _specs("n2")
    st = metropolis_pallas.segment_state(metropolis_pallas.init_carry_batch(
        _seeds("n2"), spec, device="cpu"))
    meta = metropolis_pallas.SegmentState(**{
        k: v.to("meta") for k, v in vars(st).items()})
    with pytest.raises(ValueError, match="cpu or cuda"):
        segment.call(metropolis_pallas, meta, 0, 50, spec)
    # The CUDA wrapper checks its arguments before it builds anything.
    beta = torch.zeros(50)
    with pytest.raises(ValueError, match="beta"):
        metropolis_pallas.segment_cuda(st, 0, 40, spec, beta)
    # The kernel keeps boards as bytes in shared memory and takes the
    # parent's N <= 170: N=171 is refused, N=170 fits a block.
    with pytest.raises(ValueError, match="N <= 170"):
        metropolis_pallas.layout(171, 8, 132)
    assert metropolis_pallas.layout(170, 8, 132).smem_bytes <= 232448


# -- the competition CLI ----------------------------------------------------


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


def test_competition_cli_pallas_parity(tmp_path):
    """``--kernel pallas``: both CLIs export the same board, whose oracle
    energy is the reported best."""
    argv = ["--kernel", "pallas", "--n", "6", "--n-runs", "8", "--n-steps",
            "400", "--history-stride", "50"]
    with pltpu.force_tpu_interpret_mode():
        jout = _cli(jax_competition.main, argv + ["--outdir",
                                                  str(tmp_path / "jax")])
    out = _cli(competition.main, argv + ["--device", "cpu", "--outdir",
                                         str(tmp_path / "torch")])
    board = _exported(tmp_path / "torch", 6)
    assert board == _exported(tmp_path / "jax", 6)

    def best_line(text):
        return next(ln for ln in text.splitlines()
                    if ln.startswith("Best energies"))

    assert best_line(out) == best_line(jout)
    best = np.zeros((6, 6), np.int64)
    for line in board.splitlines():
        i, j, k = map(int, line.split(","))
        best[i, j] = k
    assert f"Best energies: [{_oracle.board_energy(best)}," in out
    with pytest.raises(SystemExit) as exc:
        competition.main(argv + ["--device", "cpu", "--tempering", "4"])
    assert exc.value.code == 2
