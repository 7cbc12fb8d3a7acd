"""Parity of the port's shared-site full-3D path with the JAX package (CPU).

The JAX side runs its Pallas kernel in interpret mode, as
``tests/test_full3d_shared.py`` does; the port runs the kernel's plain-torch
twin (``segment_reference``), which ``chip_smoke.py`` holds against the CUDA
kernel on the card.  Inputs are made from numpy seeds.  Tolerance: none;
every carry field and ``ChainResult`` field is compared bitwise.  The
history stride (44) is not a multiple of the 8-step mover chunk, so every
launch ends on a 4-step chunk, and the runs end mid-launch.
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
from mcqueens.core import energy as jenergy
from mcqueens.core import fastinit as jfastinit
from mcqueens.core import schedules as jschedules
from mcqueens.core import tables as jtables
from mcqueens.dist import runner as jrunner
from mcqueens.kernels import full3d_pallas as jf3p
from mcqueens.kernels import full3d_shared as jf3s
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.cli import competition
from mcqueens_torch.core import energy, fastinit, schedules, tables
from mcqueens_torch.dist import runner
from mcqueens_torch.kernels import (_build, full3d_pallas, full3d_shared,
                                    segment)
from mcqueens_torch.kernels.carry import (FULL3D_FIELDS, carry_from_numpy,
                                          carry_to_numpy)
from tests import _oracle
from tests.test_torch_foundations import release_jax_executables  # noqa: F401

RESULT_FIELDS = ("energy_history", "history_steps", "history_len",
                 "final_energy", "final_state", "best_energy", "best_state",
                 "steps_to_best", "stop_step", "accept_bins", "total_bins")
LINEAR = dict(sched_type="linear_annealing", beta_start=0.5, beta_end=3.0)

# name -> (ChainSpec kwargs, schedule kwargs)
CASES = {
    # 190 steps: the last launch stops 6 steps into its third chunk.
    "n5": (dict(N=5, n_steps=190), LINEAR),
    "n5_q13": (dict(N=5, Q=13, n_steps=190), LINEAR),
    "n4_q7": (dict(N=4, Q=7, n_steps=300), LINEAR),
    # 26 of 27 cells occupied: nearly every step is lazy.
    "n3_q26": (dict(N=3, Q=26, n_steps=190), LINEAR),
    "early_stop": (dict(N=5, Q=13, n_steps=400, early_stop_patience=40),
                   dict(sched_type="constant", beta_const=50.0)),
}
SEEDS = 3 + np.arange(8, dtype=np.uint32)


def _specs(case, **over):
    case_kw, sched = CASES[case]
    kw = dict(init_mode="random", mcmc_type="full_3d", kernel="pallas_shared",
              history_stride=44)
    kw.update(case_kw)
    kw.update(over)
    return (
        JaxSpec(schedule=jschedules.build_schedule(n_steps=kw["n_steps"],
                                                   **sched), **kw),
        ChainSpec(schedule=schedules.build_schedule(n_steps=kw["n_steps"],
                                                    **sched), **kw),
    )


def _jax_run(spec, seeds=SEEDS, **kw):
    with pltpu.force_tpu_interpret_mode():
        return jrunner.run_chains(seeds, spec, **kw)


def _assert_same_results(want, got):
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def _assert_same_carry(want, got):
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    got = carry_to_numpy(got)
    assert tuple(got) == FULL3D_FIELDS == tuple(want)
    for name in want:
        assert got[name].dtype == np.int32, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _distinct(queens):
    return len({tuple(q) for q in np.asarray(queens).tolist()})


# -- foundations: oracles, tables, init ----------------------------------


def test_energy_oracles_match_jax():
    rng = np.random.default_rng(11)
    for N, Q in ((4, 7), (5, 25), (6, 21)):
        q = _oracle.random_full3d(rng, N, Q).astype(np.int32)
        want = int(jenergy.full3d_energy(jnp.asarray(q)))
        assert int(energy.full3d_energy(torch.from_numpy(q))) == want
        assert want == _oracle.full3d_energy(q)
        for q_idx in (0, Q - 1):
            pos = tuple(int(x) for x in rng.integers(0, N, 3))
            want = int(jenergy.full3d_conflicts(jnp.asarray(q), q_idx, pos))
            assert int(energy.full3d_conflicts(
                torch.from_numpy(q), q_idx, pos)) == want
            assert want == _oracle.full3d_conflicts(q, q_idx, pos)
        h = rng.integers(0, N, size=(N, N)).astype(np.int32)
        i, j, k = (int(x) for x in rng.integers(0, N, 3))
        want = int(jenergy.board_conflicts(jnp.asarray(h), i, j, k))
        assert int(energy.board_conflicts(torch.from_numpy(h), i, j,
                                          k)) == want
        assert want == _oracle.board_conflicts(h, i, j, k)
    # batched states score one by one
    qs = np.stack([_oracle.random_full3d(rng, 4, 9) for _ in range(3)])
    np.testing.assert_array_equal(
        energy.full3d_energy(torch.from_numpy(qs)).numpy(),
        [_oracle.full3d_energy(q) for q in qs])


@pytest.mark.parametrize("N,mode,Q", [
    (5, "random", None), (5, "random", 13), (3, "random", 26),
    (5, "latin", None), (11, "klarner", None), (6, "klarner", None),
])
def test_full3d_init_batch_and_table_energies_bitwise(N, mode, Q):
    seeds = np.array([0, 1, 7, 2 ** 31, 2 ** 32 - 1, 12345, 99, 3],
                     dtype=np.uint32)
    want = np.asarray(jfastinit.full3d_init_batch(jnp.asarray(seeds), N, mode,
                                                  Q))
    got = fastinit.full3d_init_batch(
        torch.from_numpy(seeds.view(np.int32)), N, mode, Q)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    q_eff = N * N if Q is None else Q
    assert all(_distinct(q) == q_eff for q in want)
    want_e = np.asarray(jtables.batch_energies(
        jnp.asarray(want), lambda q: jtables.table_energy(
            jtables.build_full3d_table(q, N))))
    got_e = tables.table_energy(tables.build_full3d_table(got, N))
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    assert int(got_e[0]) == _oracle.full3d_energy(want[0])
    np.testing.assert_array_equal(
        tables.build_full3d_table(got[0], N).numpy(),
        np.asarray(jtables.build_full3d_table(jnp.asarray(want[0]), N)))


def test_rank_cells_ties_and_slicing(monkeypatch):
    """Blocked cells all score 0xFFFFFFFF: the stable order keeps them by
    cell id, as jnp.argsort does; ranking in slices of chains changes
    nothing."""
    N3 = 216
    seeds = np.arange(40, dtype=np.uint32) * 977
    blocked = np.zeros(N3, bool)
    blocked[::3] = True
    want = np.asarray(jfastinit._rank_cells(jnp.asarray(seeds), N3,
                                            jnp.asarray(blocked)))
    st = torch.from_numpy(seeds.view(np.int32))
    got = fastinit._rank_cells(st, N3, torch.from_numpy(blocked))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, -72:] % 3 == 0).all()
    monkeypatch.setattr(fastinit, "_RANK_ELEMS", 3 * N3)
    np.testing.assert_array_equal(
        fastinit._first_ranked(st, N3, 50, torch.from_numpy(blocked)).numpy(),
        want[:, :50])


def test_full3d_init_guards():
    seeds = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="assumes Q = N"):
        fastinit.full3d_init_batch(seeds, 5, "latin", 13)
    with pytest.raises(ValueError, match="cannot exceed"):
        fastinit.full3d_init_batch(seeds, 3, "random", 28)
    with pytest.raises(ValueError, match="Unknown init_mode"):
        fastinit.full3d_init_batch(seeds, 3, "nope")


@pytest.mark.parametrize("N,Q,n", [(5, None, 8), (15, None, 65536),
                                   (8, 48, 4096), (16, None, 3000),
                                   (3, 26, 1)])
def test_block_sizes_match(N, Q, n):
    jspec, spec = _specs("n5", N=N, Q=Q)
    assert full3d_shared.block_size(n, spec) == jf3s.block_size(n, jspec)
    assert full3d_shared.padded_chains(n, spec) == jf3s.padded_chains(
        n, jspec)
    assert full3d_pallas.block_size(n, spec) == jf3p.block_size(n, jspec)
    assert full3d_pallas.padded_chains(n, spec) == jf3p.padded_chains(
        n, jspec)
    assert full3d_pallas._qs(spec.q_eff) == jf3p._qs(spec.q_eff)
    assert full3d_pallas._occ_words(N) == jf3p._occ_words(N)


def test_init_carry_matches_padding_and_warm_starts():
    """10 runs pad to one 128-chain block (seeds wrap in uint32, warm starts
    repeat the last placement); both modules' carries, occ included."""
    jspec, spec = _specs("n4_q7")
    seeds = np.arange(2 ** 32 - 5, 2 ** 32 + 5, dtype=np.uint64).astype(
        np.uint32)
    rng = np.random.default_rng(5)
    starts = np.stack([_oracle.random_full3d(rng, 4, 7) for _ in range(10)])
    for kw in ({}, {"initial_states": starts}):
        for jmod, mod in ((jf3s, full3d_shared), (jf3p, full3d_pallas)):
            want = jmod.init_carry_batch(seeds, jspec, **kw)
            got = mod.init_carry_batch(seeds, spec, device="cpu", **kw)
            _assert_same_carry(want, got)


def test_occupancy_sets_the_sign_bit():
    # N=4: cell 31 is bit 31 of word 0, which makes the int32 word negative.
    q = torch.tensor([[[1, 3, 3], [0, 0, 0]]], dtype=torch.int32)
    assert full3d_pallas.occupancy(q, 4).tolist() == [[-2 ** 31 + 1, 0]]


# -- the sampler ----------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_chains_parity(case):
    jspec, spec = _specs(case)
    want = _jax_run(jspec)
    got = runner.run_chains(SEEDS, spec, device="cpu")
    _assert_same_results(want, got)
    assert got.device == "cpu"
    if case == "early_stop":
        assert (got.stop_step < spec.n_steps).any()
    for r in range(got.n_runs):
        assert got.best_energy[r] == _oracle.full3d_energy(got.best_state[r])
        assert got.final_energy[r] == _oracle.full3d_energy(
            got.final_state[r])
        assert _distinct(got.best_state[r]) == spec.q_eff
        assert _distinct(got.final_state[r]) == spec.q_eff
    assert (got.total_bins.sum(axis=1) <= spec.n_steps).all()


def test_warm_start_parity():
    jspec, spec = _specs("n4_q7")
    rng = np.random.default_rng(7)
    starts = np.stack([_oracle.random_full3d(rng, 4, 7) for _ in range(8)])
    want = _jax_run(jspec, initial_states=starts)
    got = runner.run_chains(SEEDS, spec, device="cpu", initial_states=starts)
    _assert_same_results(want, got)
    for r in range(8):
        assert got.energy_history[r, 0] == _oracle.full3d_energy(starts[r])
    with pytest.raises(ValueError, match="same"):
        bad = starts.copy()
        bad[0, 1] = bad[0, 0]
        runner.run_chains(SEEDS, spec, device="cpu", initial_states=bad)
    with pytest.raises(ValueError, match="shape"):
        runner.run_chains(SEEDS, spec, device="cpu",
                          initial_states=starts[:, :6])


def test_multi_block_segment_and_carry_resume_parity():
    """Three 128-chain blocks (re-keyed block seeds, per-block candidate and
    mover streams), and a carry crossing over from a JAX mid-run state:
    one JAX launch, then one port launch == two JAX launches."""
    jspec, spec = _specs("n5_q13")
    seeds = np.arange(384, dtype=np.uint32) * 7
    with pltpu.force_tpu_interpret_mode():
        jcarry = jf3s.init_carry_batch(seeds, jspec, block=128)
        jmid, jys1 = jf3s.run_segment(jcarry, np.int32(0), jspec, 1)
        jend, jys2 = jf3s.run_segment(jmid, np.int32(1), jspec, 1)
    carry = full3d_shared.init_carry_batch(seeds, spec, block=128,
                                           device="cpu")
    assert carry.block_seeds.shape == (3, 1)
    _assert_same_carry(jcarry, carry)
    end, ys = full3d_shared.run_segment(carry, 0, spec, 2)
    _assert_same_carry(jend, end)
    np.testing.assert_array_equal(
        ys.numpy(), np.concatenate([np.asarray(jys1), np.asarray(jys2)]))

    mid = carry_from_numpy(jmid, "cpu")
    resumed, ys2 = full3d_shared.run_segment(mid, 1, spec, 1)
    _assert_same_carry(jend, resumed)
    np.testing.assert_array_equal(ys2.numpy(), np.asarray(jys2))
    # and back: the numpy round trip is lossless
    _assert_same_carry(jend, carry_from_numpy(carry_to_numpy(resumed),
                                              "cpu"))
    with pytest.raises(ValueError, match="lack fields"):
        carry_from_numpy({"qi": np.zeros((1, 1), np.int32)}, "cpu")


def test_steps_past_n_steps_change_nothing():
    _, spec = _specs("n4_q7")
    carry = full3d_shared.init_carry_batch(SEEDS, spec, device="cpu")
    carry, _ = full3d_shared.run_segment(carry, 0, spec, spec.n_outer)
    after, ys = full3d_shared.run_segment(carry, spec.n_outer, spec, 2)
    for name, want in carry_to_numpy(carry).items():
        np.testing.assert_array_equal(carry_to_numpy(after)[name], want)
    assert (ys.numpy() == carry.energy.numpy().reshape(-1)).all()


def test_n_range_guard_matches_jax():
    """N >= 94 is refused as the JAX kernel refuses it (its pad sentinels'
    int32 products stop being exact there); the port has no pads but keeps
    the same range."""
    full3d_shared.check_n(93)
    assert jf3s._pads(93) == (101, 202, 303)
    for fn in (full3d_shared.check_n, jf3s._pads):
        with pytest.raises(ValueError, match="N <= 93"):
            fn(94)
    _, spec = _specs("n5", N=94, Q=2)
    with pytest.raises(ValueError, match="N <= 93"):
        full3d_shared.run_segment(None, 0, spec, 1)


def test_segment_call_refuses_other_devices():
    _, spec = _specs("n4_q7")
    st = full3d_shared.segment_state(
        full3d_shared.init_carry_batch(SEEDS, spec, device="cpu"))
    st = full3d_shared.SegmentState(**{
        k: v.to("meta") for k, v in vars(st).items()})
    with pytest.raises(ValueError, match="cpu or cuda"):
        segment.call(full3d_shared, st, 0, 44, spec)


# -- the CLI --------------------------------------------------------------


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


def _best_line(text):
    return next(ln for ln in text.splitlines()
                if ln.startswith("Best energies"))


def test_competition_cli_full3d_parity(tmp_path):
    """``--mcmc-type full_3d --q``: both CLIs export the same placement,
    whose oracle energy is the reported best; the port warm-starts from
    it."""
    argv = ["--kernel", "pallas_shared", "--mcmc-type", "full_3d", "--n",
            "4", "--q", "7", "--n-runs", "8", "--n-steps", "300",
            "--history-stride", "44", "--beta-start", "0.5"]
    with pltpu.force_tpu_interpret_mode():
        jout = _cli(jax_competition.main,
                    argv + ["--outdir", str(tmp_path / "jax")])
    out = _cli(competition.main, argv + ["--device", "cpu", "--outdir",
                                         str(tmp_path / "torch")])
    text = _exported(tmp_path / "torch", 4)
    assert text == _exported(tmp_path / "jax", 4)
    assert _best_line(out) == _best_line(jout)
    queens = np.array([[int(x) for x in ln.split(",")]
                       for ln in text.splitlines()])
    assert queens.shape == (7, 3) and _distinct(queens) == 7
    assert f"Best energies: [{_oracle.full3d_energy(queens)}," in out
    resume = tmp_path / "start.txt"
    resume.write_text(text)
    out2 = _cli(competition.main, argv + [
        "--device", "cpu", "--resume-from", str(resume), "--outdir",
        str(tmp_path / "resume")])
    assert (int(_best_line(out2).split("[")[1].split(",")[0])
            <= _oracle.full3d_energy(queens))


@pytest.mark.parametrize("flags", [
    ["--mcmc-type", "full_3d", "--q", "64"],
    ["--mcmc-type", "full_3d", "--q", "0"],
    ["--q", "5"],
])
def test_cli_q_guards(flags):
    with pytest.raises(SystemExit) as exc:
        competition.main(["--n", "4", "--device", "cpu"] + flags)
    assert exc.value.code == 2


# -- the CUDA kernel's layout rule (no card needed) --------------------------

H100_SMS = 132


@pytest.mark.parametrize("N,Q,C,want", [
    # the floors campaign's launch and chunk: four lanes, 128 chains a CTA
    # in 231936 B, 3.88 waves of 128 chains an SM
    (15, 225, 65536, (4, 128, True)),
    # the campaign at 4096 chains: 8 lanes, one wave on 128 SMs
    (15, 225, 4096, (8, 32, True)),
    # tools/qmax.py's first budget: 8 lanes, one wave on 128 SMs
    (8, 48, 4096, (8, 32, True)),
])
def test_layout_picks(N, Q, C, want):
    c_blk = full3d_shared.block_size(C)
    lay = full3d_shared.layout(N, Q, C, c_blk, H100_SMS)
    assert (lay.lanes, lay.chains_per_cta, lay.in_shared) == want
    assert lay.smem_bytes == full3d_shared.cta_smem_bytes(
        Q, lay.lanes, lay.chains_per_cta)


@pytest.mark.parametrize("N,Q,C", [
    (15, 225, 65536), (15, 225, 4096), (8, 48, 4096), (16, 32, 32768),
    (16, 128, 32768), (16, 256, 32768), (16, 384, 32768), (16, 384, 16384),
    (5, 13, 1024), (3, 26, 256), (12, 144, 4096), (93, 8649, 128)])
def test_layout_invariants(N, Q, C):
    """Shared bytes within a block's limit, threads and chains a CTA within
    the kernel's, chains a CTA dividing the block (a CTA holds one semantic
    block), and a launch of more than one wave has its last wave at least
    half full."""
    c_blk = full3d_shared.block_size(C)
    lay = full3d_shared.layout(N, Q, C, c_blk, H100_SMS)
    assert lay.in_shared
    assert lay.smem_bytes <= _build.SMEM_PER_BLOCK
    assert lay.lanes in full3d_shared.LANES
    assert 32 <= lay.lanes * lay.chains_per_cta <= 512
    assert (lay.lanes * lay.chains_per_cta) % 32 == 0
    assert c_blk % lay.chains_per_cta == 0 and C % lay.chains_per_cta == 0
    slot = full3d_shared.slot_words(Q, lay.lanes)
    assert slot >= 2 * Q
    if lay.lanes < 32:  # a warp's reads of its teams' words: 32 banks
        teams = 32 // lay.lanes
        banks = {(t * slot + r) % 32 for t in range(teams)
                 for r in range(lay.lanes)}
        assert len(banks) == 32
    else:
        assert slot % 2
    waves = full3d_shared.waves(lay, C, H100_SMS)
    assert waves <= 1 or waves % 1 == 0 or waves % 1 >= 0.5, waves


def test_layout_device_memory_where_no_cta_fits():
    """A CTA of one chain at 32 lanes holds 2Q + 1 words of slot: past Q =
    29055 no CTA fits, and the rule walks the device planes."""
    assert full3d_shared.layout(31, 29055, 128, 128, H100_SMS).in_shared
    lay = full3d_shared.layout(31, 29056, 128, 128, H100_SMS)
    assert not lay.in_shared and lay.smem_bytes == 0
    assert 128 % lay.chains_per_cta == 0


def test_layout_blocks_of_odd_sizes():
    """Blocks of 100 chains allow CTAs of at most 4 chains (8 lanes or
    more); a block of one chain takes CTAs of one chain at 32 lanes."""
    lay = full3d_shared.layout(6, 36, 300, 100, H100_SMS)
    assert lay.chains_per_cta <= 4 and 100 % lay.chains_per_cta == 0
    lay = full3d_shared.layout(6, 36, 7, 1, H100_SMS)
    assert (lay.lanes, lay.chains_per_cta) == (32, 1)


def test_q_past_the_packed_reduce_is_refused():
    """The team's reduce packs two 16-bit counts a word, so the CUDA kernel
    (and its host emulation) refuses Q > 65536 with ValueError before it
    touches any tensor; the twin has no such limit."""
    assert full3d_shared.MAX_Q == 65536
    full3d_shared.layout(41, 65536, 128, 128, H100_SMS)
    _, spec = _specs("n5", N=41, Q=65537)
    with pytest.raises(ValueError, match="Q must"):
        full3d_shared.layout(41, 65537, 128, 128, H100_SMS)
    with pytest.raises(ValueError, match="Q must be at most 65536"):
        full3d_shared.launch_segment(None, None, 0, 44, spec, None,
                                     n_sm=H100_SMS)
