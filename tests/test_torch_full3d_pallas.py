"""Parity of the port's per-chain full-3D sampler with the JAX package (CPU).

The JAX side runs its Pallas kernel (``full3d_pallas._kernel``) in interpret
mode, as ``tests/test_pallas.py`` does; the port runs the kernel's
plain-torch twin (``segment_reference``), which ``chip_smoke.py`` holds
against the CUDA kernel on the card.  Inputs are made from numpy seeds.
Tolerance: none; every carry field (the occupancy bitfield included), ``ys``
row and ``ChainResult`` field is compared bitwise.
"""

import contextlib
import glob
import io
import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mcqueens.chain.spec import ChainSpec as JaxSpec
from mcqueens.cli import competition as jax_competition
from mcqueens.core import schedules as jschedules
from mcqueens.dist import runner as jrunner
from mcqueens.kernels import full3d_pallas as jf3p
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.cli import competition
from mcqueens_torch.core import schedules
from mcqueens_torch.dist import runner
from mcqueens_torch.kernels import full3d_pallas, segment
from mcqueens_torch.kernels.carry import (FULL3D_FIELDS, carry_from_numpy,
                                          carry_to_numpy)
from tests import _oracle
from tests.test_torch_foundations import release_jax_executables  # noqa: F401

RESULT_FIELDS = ("energy_history", "history_steps", "history_len",
                 "final_energy", "final_state", "best_energy", "best_state",
                 "steps_to_best", "stop_step", "accept_bins", "total_bins")
LINEAR = dict(sched_type="linear_annealing", beta_start=0.5, beta_end=3.0)

# name -> (ChainSpec kwargs, schedule kwargs, chains).  The JAX side runs
# one history chunk per call, so each case compiles its kernel once, and
# "n4_q7" is also the spec of the runner and CLI tests below.
CASES = {
    # 1 free cell in 27: attempt runs far longer than one round of 32.
    "n3_q26": (dict(N=3, Q=26, n_steps=200), LINEAR, 8),
    # 1 free cell in 8; 70 bins over 350 steps are narrower than the JAX
    # kernel's 8-step unroll group (its exact per-step bin path).
    "n2_q7_narrow_bins": (dict(N=2, Q=7, n_steps=350, n_bins=70), LINEAR, 8),
    "n4_q7": (dict(N=4, Q=7, n_steps=300), LINEAR, 8),
    # Q = N^2 with 20 runs padded to 128, cold enough for patience to stop
    # chains; N=4 puts cell 31 on bit 31, the word's sign bit.
    "n4_q16_patience": (dict(N=4, n_steps=300, early_stop_patience=40),
                        dict(sched_type="exponential_annealing",
                             beta_start=5.0, beta_end=50.0), 20),
}


def _specs(case, **over):
    case_kw, sched, _ = CASES[case]
    kw = dict(init_mode="random", mcmc_type="full_3d", kernel="pallas",
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
    assert tuple(got) == FULL3D_FIELDS == tuple(want)
    for name in want:
        assert got[name].dtype == np.int32, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _distinct(queens):
    return len({tuple(q) for q in np.asarray(queens).tolist()})


def _check_occupancy(carry, N):
    """The bitfield marks exactly the queens' cells."""
    queens = torch.stack([carry.qi, carry.qj, carry.qk], -1)
    assert torch.equal(carry.occ, full3d_pallas.occupancy(queens, N))


def _jax_chunks(case, seeds):
    """JAX carries before and after each chunk, and the ys rows."""
    jspec = _specs(case)[0]
    with pltpu.force_tpu_interpret_mode():
        carries = [jf3p.init_carry_batch(seeds, jspec)]
        ys = []
        for o in range(jspec.n_outer):
            c, y = jf3p.run_segment(carries[-1], np.int32(o), jspec, 1)
            carries.append(c)
            ys.append(np.asarray(y))
    return carries, np.concatenate(ys)


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_segment_parity(case):
    """Carry and ys rows after the whole run, bitwise."""
    _, spec = _specs(case)
    seeds = _seeds(case)
    jcarries, jys = _jax_chunks(case, seeds)
    carry = full3d_pallas.init_carry_batch(seeds, spec, device="cpu")
    _assert_same_carry(jcarries[0], carry)
    end, ys = full3d_pallas.run_segment(carry, 0, spec, spec.n_outer)
    _assert_same_carry(jcarries[-1], end)
    np.testing.assert_array_equal(ys.numpy(), jys)
    _assert_same_carry(jcarries[0], carry)  # the input carry is unchanged
    _check_occupancy(end, spec.N)
    if case == "n4_q16_patience":
        assert (end.stop_step < spec.n_steps).any()
    best = torch.stack([end.best_qi, end.best_qj, end.best_qk], -1).numpy()
    for r in range(best.shape[0]):
        assert _distinct(best[r]) == spec.q_eff
        assert int(end.best_energy[r]) == _oracle.full3d_energy(best[r])


def test_run_chains_parity_with_warm_start():
    """The runner's ``ChainResult`` fields, cold and warm-started (one
    chunk per segment, as the CLI runs it)."""
    jspec, spec = _specs("n4_q7")
    seeds = _seeds("n4_q7")
    rng = np.random.default_rng(7)
    starts = np.stack([_oracle.random_full3d(rng, 4, 7) for _ in range(8)])
    for kw in ({}, {"initial_states": starts}):
        kw["min_segments"] = spec.n_outer
        with pltpu.force_tpu_interpret_mode():
            want = jrunner.run_chains(seeds, jspec, **kw)
        got = runner.run_chains(seeds, spec, device="cpu", **kw)
        for name in RESULT_FIELDS:
            np.testing.assert_array_equal(getattr(got, name),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        for r in range(got.n_runs):
            assert got.best_energy[r] == _oracle.full3d_energy(
                got.best_state[r])
            assert got.final_energy[r] == _oracle.full3d_energy(
                got.final_state[r])
            assert _distinct(got.final_state[r]) == 7
    np.testing.assert_array_equal(
        got.energy_history[:, 0], [_oracle.full3d_energy(s) for s in starts])


def test_klarner_stays_optimal():
    """gcd(11, 210) = 1: the Klarner placement has energy 0 and keeps it
    at beta = 100."""
    spec = ChainSpec(N=11, n_steps=60, init_mode="klarner",
                     schedule=schedules.build_schedule("constant", 60,
                                                       beta_const=100.0),
                     mcmc_type="full_3d", kernel="pallas", history_stride=30)
    res = runner.run_chains(np.arange(4, dtype=np.uint32), spec,
                            device="cpu")
    assert (res.energy_history == 0).all() and (res.best_energy == 0).all()
    assert (res.total_bins.sum(1) == 60).all()


def test_block_partition_does_not_change_trajectories():
    _, spec = _specs("n4_q16_patience", history_stride=100)
    seeds = np.arange(256, dtype=np.uint32) * 11
    ends = []
    for block in (128, 256):
        carry = full3d_pallas.init_carry_batch(seeds, spec, block=block,
                                               device="cpu")
        ends.append(full3d_pallas.run_segment(carry, 0, spec, 3))
    (a, ys_a), (b, ys_b) = ends
    assert a.block_seeds.shape == (2, 1) and b.block_seeds.shape == (1, 1)
    for name in FULL3D_FIELDS[1:]:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(ys_a, ys_b)


def test_jax_carry_resumes_in_port():
    """A JAX mid-run carry crosses into the port, which continues it
    exactly; and back through numpy."""
    _, spec = _specs("n3_q26")
    seeds = np.arange(20, dtype=np.uint32) * 7
    jcarries, jys = _jax_chunks("n3_q26", seeds)
    resumed, ys = full3d_pallas.run_segment(
        carry_from_numpy(jcarries[2], "cpu"), 2, spec, 2)
    _assert_same_carry(jcarries[4], resumed)
    np.testing.assert_array_equal(ys.numpy(), jys[2:])
    _assert_same_carry(jcarries[4],
                       carry_from_numpy(carry_to_numpy(resumed), "cpu"))


def test_free_cell_is_the_first_free_attempt():
    """The twin's batched draw equals attempts taken one at a time."""
    _, spec = _specs("n3_q26")
    carry = full3d_pallas.init_carry_batch(np.arange(64, dtype=np.uint32),
                                           spec, device="cpu")
    base = torch.arange(64, dtype=torch.int32) * 977 - 5000
    got = full3d_pallas._free_cell(carry.occ, base, 27)
    for c in range(64):
        a = 0
        while True:
            w = full3d_pallas.prng.word_from_base(
                base[c:c + 1], full3d_pallas._A_SALT + a)
            cell = int(w % 27)
            if not (int(carry.occ[c, cell // 32]) >> (cell % 32)) & 1:
                break
            a += 1
        assert int(got[c]) == cell


def test_steps_past_n_steps_change_nothing():
    _, spec = _specs("n4_q7")
    carry = full3d_pallas.init_carry_batch(_seeds("n4_q7"), spec,
                                           device="cpu")
    carry, _ = full3d_pallas.run_segment(carry, 0, spec, spec.n_outer)
    after, ys = full3d_pallas.run_segment(carry, spec.n_outer, spec, 2)
    for name, want in carry_to_numpy(carry).items():
        np.testing.assert_array_equal(carry_to_numpy(after)[name], want)
    assert (ys.numpy() == carry.energy.numpy().reshape(-1)).all()


def test_segment_call_refuses_other_devices_and_cuda_guards():
    _, spec = _specs("n4_q7")
    st = full3d_pallas.segment_state(full3d_pallas.init_carry_batch(
        _seeds("n4_q7"), spec, device="cpu"))
    meta = full3d_pallas.SegmentState(**{
        k: v.to("meta") for k, v in vars(st).items()})
    with pytest.raises(ValueError, match="cpu or cuda"):
        segment.call(full3d_pallas, meta, 0, 50, spec)
    with pytest.raises(ValueError, match="occ"):
        full3d_pallas.segment_cuda(
            full3d_pallas.SegmentState(**{**vars(st), "occ": st.occ[:, :0]}),
            0, 50, spec, torch.zeros(50))
    assert full3d_pallas.smem_bytes(_specs("n4_q7", N=104, Q=None)[1]) \
        <= 232448 < full3d_pallas.smem_bytes(_specs("n4_q7", N=105,
                                                    Q=None)[1])


def test_competition_cli_pallas_full3d_parity(tmp_path):
    """``--kernel pallas --mcmc-type full_3d``: both CLIs export the same
    placement, whose oracle energy is the reported best (the "n4_q7"
    spec, one chunk per segment)."""
    argv = ["--kernel", "pallas", "--mcmc-type", "full_3d", "--n", "4",
            "--q", "7", "--n-runs", "8", "--n-steps", "300",
            "--history-stride", "50", "--beta-start", "0.5"]
    outs = []
    for main, sub, extra in ((jax_competition.main, "jax", []),
                             (competition.main, "torch",
                              ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                pltpu.force_tpu_interpret_mode():
            assert main(argv + extra + ["--outdir",
                                        str(tmp_path / sub)]) == 0
        (path,) = glob.glob(os.path.join(tmp_path, sub, "competition_results",
                                         "best_heights_4_*.txt"))
        with open(path) as f:
            outs.append((buf.getvalue(), f.read()))
    (jout, jtext), (out, text) = outs
    assert text == jtext
    best_line = [ln for ln in out.splitlines() if ln.startswith("Best")]
    assert best_line == [ln for ln in jout.splitlines()
                         if ln.startswith("Best")]
    queens = np.array([[int(x) for x in ln.split(",")]
                       for ln in text.splitlines()])
    assert queens.shape == (7, 3) and _distinct(queens) == 7
    assert f"Best energies: [{_oracle.full3d_energy(queens)}," in out
