"""Parity of the port's parallel tempering with the JAX package (CPU).

``exchange`` and ``round_key`` are held against their JAX counterparts
directly; the tempered segments of both shared-site samplers and
``run_tempered`` against the JAX package run in Pallas interpret mode.
Inputs are made from numpy seeds.  Tolerance: none.  The swap test compares
``log(u)`` in float32, where torch's and XLA's ``log`` may round one ulp
apart; that would flip a swap only when ``log(u)`` lands within one ulp of
``log_a``, and it has not happened in these runs (ROADMAP.md queue 3).
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
from mcqueens.kernels import board_shared as jbs
from mcqueens.kernels import full3d_shared as jf3s
from mcqueens.search import tempering as jtempering
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.cli import competition
from mcqueens_torch.core import schedules
from mcqueens_torch.kernels import board_shared, full3d_shared
from mcqueens_torch.kernels.carry import carry_to_numpy
from mcqueens_torch.search import tempering
from tests import _oracle
from tests.test_torch_foundations import release_jax_executables  # noqa: F401

LADDER = tempering.geometric_ladder(0.5, 3.0, 4)
SEEDS = np.arange(8, dtype=np.uint32) + 11


def _specs(mcmc_type, **over):
    kw = dict(N=5, n_steps=176, init_mode="random", mcmc_type=mcmc_type,
              kernel="pallas_shared", history_stride=44)
    kw.update(over)
    n = kw["n_steps"]
    return (
        JaxSpec(schedule=jschedules.build_schedule("constant", n,
                                                   beta_const=1.0), **kw),
        ChainSpec(schedule=schedules.build_schedule("constant", n,
                                                    beta_const=1.0), **kw),
    )


def _assert_same_out(want, got):
    assert set(want) == set(got)
    for key in want:
        if key == "wall_time":
            continue
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


def test_geometric_ladder_matches_and_guards():
    for args in ((0.5, 3.0, 4), (0.8, 7.0, 16), (1.0, 2.0, 2)):
        got = tempering.geometric_ladder(*args)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jtempering.geometric_ladder(*args))
    with pytest.raises(ValueError, match="2 ladder levels"):
        tempering.geometric_ladder(0.5, 3.0, 1)
    with pytest.raises(ValueError, match="beta_min"):
        tempering.geometric_ladder(3.0, 0.5, 4)


@pytest.mark.parametrize("swap_seed", [0, 1, 42, 31337, 2 ** 32 - 1])
def test_round_key_matches(swap_seed):
    for r in (0, 1, 2, 1000, 2 ** 31 - 1):
        got = tempering.round_key(swap_seed, r)
        assert got.dtype == np.int32
        assert got == jtempering.round_key(swap_seed, r)


@pytest.mark.parametrize("n_levels,phase", [(2, 0), (2, 1), (4, 0), (4, 1),
                                            (5, 0), (16, 1)])
def test_exchange_matches(n_levels, phase):
    """Random betas and energies, with tail chains beyond the last full
    group; several round keys."""
    rng = np.random.default_rng(n_levels * 10 + phase)
    C = 48 * n_levels + 3
    betas = rng.uniform(0.2, 5.0, C).astype(np.float32)
    energies = rng.integers(0, 60, C).astype(np.int32)
    betas_in, swapped = betas, 0
    for r in range(6):
        rkey = jtempering.round_key(7, r)
        want = np.asarray(jtempering.exchange(
            jnp.asarray(betas), jnp.asarray(energies), rkey, n_levels,
            phase))
        got = tempering.exchange(torch.from_numpy(betas.copy()),
                                 torch.from_numpy(energies), rkey, n_levels,
                                 phase)
        np.testing.assert_array_equal(got.numpy(), want)
        swapped += int((want != betas).sum())
        betas = want
    # n_levels=2 has no odd pair: phase 1 leaves every beta in place.
    assert (swapped > 0) == (phase < n_levels - 1)
    np.testing.assert_array_equal(betas[-3:], betas_in[-3:])


@pytest.mark.parametrize("mcmc_type", ["board", "full_3d"])
def test_tempered_segments_multi_block_parity(mcmc_type):
    """The kernels' tempered mode over three 128-chain blocks, with a
    per-chain beta scale from numpy."""
    jspec, spec = _specs(mcmc_type, Q=13 if mcmc_type == "full_3d" else None)
    jmod, mod = ((jbs, board_shared) if mcmc_type == "board"
                 else (jf3s, full3d_shared))
    seeds = np.arange(384, dtype=np.uint32) * 5
    scale = np.random.default_rng(3).uniform(0.3, 4.0, 384).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        jcarry = jmod.init_carry_batch(seeds, jspec, block=128)
        jend, jys = jmod.run_segment_tempered(jcarry, jnp.asarray(scale),
                                              np.int32(1), jspec, 2)
    carry = mod.init_carry_batch(seeds, spec, block=128, device="cpu")
    end, ys = mod.run_segment_tempered(carry, torch.from_numpy(scale), 1,
                                       spec, 2)
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    want = {k: np.asarray(v) for k, v in jend._asdict().items()}
    for name, got in carry_to_numpy(end).items():
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    # a scale of 1 is the plain mode
    plain, _ = mod.run_segment(carry, 1, spec, 1)
    ones, _ = mod.run_segment_tempered(carry, np.ones(384, np.float32), 1,
                                       spec, 1)
    for name, got in carry_to_numpy(ones).items():
        np.testing.assert_array_equal(got, carry_to_numpy(plain)[name])


@pytest.mark.parametrize("mcmc_type,interval", [
    ("board", 1), ("board", 2), ("full_3d", 1), ("full_3d", 2)])
def test_run_tempered_parity(mcmc_type, interval):
    jspec, spec = _specs(mcmc_type)
    kw = dict(swap_seed=5, record_betas=True, exchange_interval=interval)
    with pltpu.force_tpu_interpret_mode():
        want = jtempering.run_tempered(SEEDS, jspec, LADDER, **kw)
    got = tempering.run_tempered(SEEDS, spec, LADDER, device="cpu", **kw)
    _assert_same_out(want, got)
    assert got["betas_history"].shape == (-(-spec.n_outer // interval), 8)
    assert got["proposals"] == 128 * spec.n_steps  # one padded block
    oracle = (_oracle.board_energy if mcmc_type == "board"
              else _oracle.full3d_energy)
    for r in range(8):
        assert got["best_energy"][r] == oracle(got["best_state"][r])
        assert got["final_energy"][r] == oracle(got["final_state"][r])
    # every group keeps its ladder
    for g in range(2):
        np.testing.assert_array_equal(np.sort(got["betas"][4 * g:4 * g + 4]),
                                      np.sort(LADDER))


def test_run_tempered_stop_at_energy_and_warm_start():
    """Q=6 at N=4 has attack-free placements: the search stops after the
    first round that banks one (the second of ten), exactly where the JAX
    search stops."""
    jspec, spec = _specs("full_3d", N=4, Q=6, n_steps=440)
    rng = np.random.default_rng(9)
    starts = np.stack([_oracle.random_full3d(rng, 4, 6) for _ in range(8)])
    kw = dict(swap_seed=3, stop_at_energy=0, initial_states=starts)
    with pltpu.force_tpu_interpret_mode():
        want = jtempering.run_tempered(SEEDS, jspec, LADDER, **kw)
    got = tempering.run_tempered(SEEDS, spec, LADDER, device="cpu", **kw)
    _assert_same_out(want, got)
    assert got["best_energy"].min() == 0
    assert got["energy_history"].shape[1] == 3  # the start and 2 rounds
    for r in range(8):
        assert got["energy_history"][r, 0] == _oracle.full3d_energy(
            starts[r])


def test_run_tempered_refuses():
    _, spec = _specs("board")
    # checkpointer= and mesh= run (tests/test_torch_checkpoint.py,
    # tests/test_torch_mesh.py); a mesh that is no sequence of devices, or
    # of another device type than the run's, is refused.
    for kw, err in ((dict(mesh=object()), TypeError),
                    (dict(mesh=["cuda:0"]), ValueError),
                    (dict(exchange_interval=0), ValueError)):
        with pytest.raises(err):
            tempering.run_tempered(SEEDS, spec, LADDER, device="cpu", **kw)
    _, tables_spec = _specs("board", kernel="tables")
    with pytest.raises(ValueError, match="pallas_shared"):
        tempering.run_tempered(SEEDS, tables_spec, LADDER, device="cpu")


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _exported(outdir):
    (path,) = glob.glob(os.path.join(outdir, "competition_results",
                                     "best_heights_5_*.txt"))
    with open(path) as f:
        return f.read()


def _best_line(text):
    return next(ln for ln in text.splitlines()
                if ln.startswith("Best energies"))


@pytest.mark.parametrize("extra", [
    ["--mcmc-type", "full_3d", "--q", "13"],
    ["--exchange-interval", "2"],
])
def test_competition_cli_tempering_parity(tmp_path, extra):
    """``--tempering 4``: both CLIs export the same state, whose oracle
    energy is the reported best."""
    argv = ["--kernel", "pallas_shared", "--n", "5", "--n-runs", "8",
            "--n-steps", "176", "--history-stride", "44", "--tempering", "4",
            "--beta-start", "0.5", "--beta-end", "3"] + extra
    with pltpu.force_tpu_interpret_mode():
        jout = _cli(jax_competition.main,
                    argv + ["--outdir", str(tmp_path / "jax")])
    out = _cli(competition.main, argv + ["--device", "cpu", "--outdir",
                                         str(tmp_path / "torch")])
    text = _exported(tmp_path / "torch")
    assert text == _exported(tmp_path / "jax")
    assert _best_line(out) == _best_line(jout)
    rows = np.array([[int(x) for x in ln.split(",")]
                     for ln in text.splitlines()])
    if "full_3d" in extra:
        assert rows.shape == (13, 3)
        best = _oracle.full3d_energy(rows)
    else:
        board = np.zeros((5, 5), np.int64)
        board[rows[:, 0], rows[:, 1]] = rows[:, 2]
        best = _oracle.board_energy(board)
    assert f"Best energies: [{best}," in out
