"""Parity of the port's tables/naive scan samplers with the JAX package (CPU).

The JAX side is ``mcqueens.chain.board`` / ``mcqueens.chain.full3d``
(``run_segment``, one compiled XLA scan); the port runs the plain-torch
twins of ``kernels/csrc/board_scan.cu`` and ``full3d_scan.cu``, which
``chip_smoke.py`` holds against the CUDA kernels on the card.  Keys, states,
schedules and warm starts come from numpy seeds.  Tolerance: none; every
carry field and every ``ys`` row is compared bitwise (the runner and CLIs
on these samplers: ``tests/test_torch_scan_runner.py``).  The one allowed exception,
an accept test within one float32 ulp of ``exp(-beta * dE)``, has not
occurred here (it would show as a mismatch and be logged in ROADMAP.md
queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcqueens.chain import board as jboard
from mcqueens.chain import full3d as jfull3d
from mcqueens.chain.spec import ChainSpec as JaxSpec
from mcqueens.core import rng as jrng
from mcqueens.core import schedules as jschedules
from mcqueens_torch.chain import board, full3d
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import rng, schedules
from mcqueens_torch.dist import runner
from mcqueens_torch.kernels import segment
from tests import _oracle
from tests.test_torch_foundations import release_jax_executables  # noqa: F401

LIN = dict(sched_type="linear_annealing", beta_start=0.5, beta_end=3.0)
COLD = dict(sched_type="constant", beta_const=50.0)
EXP = dict(sched_type="exponential_annealing", beta_start=1.0, beta_end=3.0)

# name -> (ChainSpec kwargs, schedule kwargs, warm start[, the n_outer of
# each run_segment call in turn, the whole run in one call if absent]).  The
# CUDA kernels draw 32 steps at a time from each segment's first step, so
# the cases below "n5_warm_klarner" here and below "n6_warm_latin" in
# FULL3D_CASES reach their batches' edges: a stop inside a batch, segments
# of 31 and 33 steps, a segment from start_outer > 0.
BOARD_CASES = {
    # stride 7 over 100 steps: the 15th chunk runs 5 steps past n_steps
    "n2_tail": (dict(N=2, n_steps=100, history_stride=7), LIN, False),
    "n3_stride1": (dict(N=3, n_steps=120, history_stride=1), EXP, False),
    "n5_tail": (dict(N=5, n_steps=180, history_stride=50), LIN, False),
    "n6_patience": (dict(N=6, n_steps=200, history_stride=50,
                         early_stop_patience=30), COLD, False),
    "n5_warm_klarner": (dict(N=5, n_steps=200, history_stride=50,
                             init_mode="klarner"), LIN, True),
    "n4_patience_in_batch": (dict(N=4, n_steps=300, history_stride=64,
                                  early_stop_patience=13), COLD, False),
    "n2_segments_31_33": (dict(N=2, n_steps=64, history_stride=1), LIN,
                          False, (31, 33)),
    # a 33-step chunk, then two more from start_outer 1, 9 steps past n_steps
    "n2_stride33_tail": (dict(N=2, n_steps=90, history_stride=33), LIN,
                         False, (1, 2)),
    "n5_start_outer_stride7": (dict(N=5, n_steps=150, history_stride=7,
                                    n_bins=9), LIN, False, (5, 17)),
}
FULL3D_CASES = {
    # one free cell in 8 (long rejection runs) and a tail chunk
    "n2_q7_tail": (dict(N=2, Q=7, n_steps=24, history_stride=5), LIN, False),
    "n3_stride1": (dict(N=3, n_steps=80, history_stride=1), EXP, False),
    "n5_q13_tail": (dict(N=5, Q=13, n_steps=130, history_stride=50), LIN,
                    False),
    "n5_q13_patience": (dict(N=5, Q=13, n_steps=150, history_stride=50,
                             early_stop_patience=30), COLD, False),
    "n6_warm_latin": (dict(N=6, n_steps=100, history_stride=50,
                           init_mode="latin"), LIN, True),
    "n4_q16_patience_in_batch": (dict(N=4, Q=16, n_steps=300,
                                      history_stride=64,
                                      early_stop_patience=13), COLD, False),
    "n3_q13_segments_31_33": (dict(N=3, Q=13, n_steps=64, history_stride=1),
                              LIN, False, (31, 33)),
    "n5_q13_start_outer_stride7": (dict(N=5, Q=13, n_steps=150,
                                        history_stride=7, n_bins=9), LIN,
                                   False, (5, 17)),
    # every accepted move frees the cell the next proposals may draw
    "n2_q7_stride1": (dict(N=2, Q=7, n_steps=70, history_stride=1), LIN,
                      False),
}
SEEDS = 3 + np.arange(6, dtype=np.uint32)
RESULT_FIELDS = ("energy_history", "history_steps", "history_len",
                 "final_energy", "final_state", "best_energy", "best_state",
                 "steps_to_best", "stop_step", "accept_bins", "total_bins")


def _specs(case_kw, sched, **over):
    kw = dict(init_mode="random", kernel="tables")
    kw.update(case_kw)
    kw.update(over)
    return (
        JaxSpec(schedule=jschedules.build_schedule(n_steps=kw["n_steps"],
                                                   **sched), **kw),
        ChainSpec(schedule=schedules.build_schedule(n_steps=kw["n_steps"],
                                                    **sched), **kw),
    )


def _warm(spec, seed, C=len(SEEDS)):
    rs = np.random.default_rng(seed)
    N = spec.N
    if spec.mcmc_type == "board":
        return rs.integers(0, N, size=(C, N, N)).astype(np.int32)
    cells = np.stack([rs.permutation(N ** 3)[:spec.q_eff] for _ in range(C)])
    return np.stack([cells // (N * N), cells // N % N, cells % N],
                    axis=-1).astype(np.int32)


def _assert_same_carry(want, got):
    for name, w in want._asdict().items():
        g = getattr(got, name)
        if w is None:
            assert g is None, name
            continue
        if name == "step_base":
            w = jax.random.key_data(w)
        g = g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype),
                                      err_msg=name)


def _scan_parity(jmod, mod, jspec, spec, starts, segments=None):
    jkeys = jrng.chain_keys_from_seeds(SEEDS)
    keys = rng.chain_keys_from_seeds(SEEDS)
    jc = jmod.init_carry_batch(
        jkeys, jspec, None if starts is None else jnp.asarray(starts))
    c = mod.init_carry_batch(keys, spec, starts, device="cpu")
    _assert_same_carry(jc, c)
    start = 0
    for n_outer in segments or (spec.n_outer,):
        jc, jys = jmod.run_segment(jc, np.int32(start), jspec, n_outer)
        c, ys = mod.run_segment(c, start, spec, n_outer)
        _assert_same_carry(jc, c)
        np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
        start += n_outer
    return c


@pytest.mark.parametrize("kernel", ["tables", "naive"])
@pytest.mark.parametrize("case", sorted(BOARD_CASES))
def test_board_scan_parity(case, kernel):
    case_kw, sched, warm, *segments = BOARD_CASES[case]
    jspec, spec = _specs(case_kw, sched, kernel=kernel)
    starts = _warm(spec, 1) if warm else None
    end = _scan_parity(jboard, board, jspec, spec, starts, *segments)
    assert (end.table is None) == (kernel == "naive")
    for c in range(len(SEEDS)):
        h = end.best_heights[c].reshape(spec.N, spec.N).numpy()
        assert int(end.best_energy[c]) == _oracle.board_energy(h)
        h = end.heights[c].reshape(spec.N, spec.N).numpy()
        assert int(end.energy[c]) == _oracle.board_energy(h)
    if "patience" in case:
        assert bool(end.done.any())
        assert torch.equal(end.done, end.stop_step < spec.n_steps)
    if "in_batch" in case:
        # a stop at a step other than the last of a 32-step batch
        assert bool((end.stop_step[end.done] % 32 != 31).any())


@pytest.mark.parametrize("kernel", ["tables", "naive"])
@pytest.mark.parametrize("case", sorted(FULL3D_CASES))
def test_full3d_scan_parity(case, kernel):
    case_kw, sched, warm, *segments = FULL3D_CASES[case]
    jspec, spec = _specs(case_kw, sched, kernel=kernel, mcmc_type="full_3d")
    starts = _warm(spec, 2) if warm else None
    end = _scan_parity(jfull3d, full3d, jspec, spec, starts, *segments)
    for c in range(len(SEEDS)):
        assert int(end.best_energy[c]) == _oracle.full3d_energy(
            end.best_queens[c].numpy())
        cells = full3d.init_mod.queens_to_cells(end.queens[c], spec.N)
        assert int(end.occ[c].sum()) == spec.q_eff
        assert bool(end.occ[c, cells].all())
    if "patience" in case:
        assert bool(end.done.any())
        assert torch.equal(end.done, end.stop_step < spec.n_steps)
    if "in_batch" in case:
        # a stop at a step other than the last of a 32-step batch
        assert bool((end.stop_step[end.done] % 32 != 31).any())


# (N, kernel, chains) -> (chains per block, shared-memory bytes a block) of
# the CUDA board scan on a 132-SM card.  A chain's slot is 2 N^2 words plus
# T(N) for "tables" (T = 4060, 7332, 52000 at N = 12, 16, 42); 0 bytes:
# the slots do not fit a block (232448 bytes) and stay in device memory.
LAYOUTS = {
    "n12_tables_config_yaml": ((12, "tables", 10), (1, 4 * 4348)),
    "n12_tables_4096": ((12, "tables", 4096), (6, 6 * 4 * 4348)),
    "n12_tables_500_spread": ((12, "tables", 500), (4, 4 * 4 * 4348)),
    "n16_tables_4096": ((16, "tables", 4096), (7, 7 * 4 * 7844)),
    "n16_naive_4096": ((16, "naive", 4096), (8, 8 * 4 * 512)),
    "n42_tables_shared": ((42, "tables", 64), (1, 4 * 55528)),
    "n43_tables_device": ((43, "tables", 64), (1, 0)),
    "n48_tables_device": ((48, "tables", 8), (1, 0)),
    "n48_naive_shared": ((48, "naive", 8), (1, 4 * 4608)),
    "n171_naive_device": ((171, "naive", 4096), (8, 0)),
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_scan_layout(case):
    """The rule that picks the CUDA board scan's shared-memory or
    device-memory variant, its chains per block and its shared memory."""
    (N, kernel, C), (cpb, smem) = LAYOUTS[case]
    layout = board.scan_layout(N, kernel, C, 132)
    assert (layout.chains_per_block, layout.smem_bytes) == (cpb, smem)
    assert layout.in_shared == (smem > 0)
    assert 1 <= cpb <= min(board.MAX_CHAINS_PER_BLOCK, -(-C // 132))
    assert layout.smem_bytes <= 232448


# (N, Q, kernel, chains) -> (chains per block, shared-memory bytes a block)
# of the CUDA full-3D scan on a 132-SM card.  A chain's slot is 6Q words of
# queens and best queens, ceil(N^3 / 4) words of occupancy bytes and, for
# "tables", T13(N) words (4204, 9652, 37209, 39388 at N = 12, 18, 35, 36):
# 22000 B at N=12, 221112 B at N=35, 235312 B at N=36, over the 232448 B a
# block may have, so 0 bytes: device memory.
FULL3D_LAYOUTS = {
    "n12_tables_config_yaml": ((12, 144, "tables", 10), (1, 22000)),
    "n12_tables_4096": ((12, 144, "tables", 4096), (5, 5 * 22000)),
    "n12_naive_4096": ((12, 144, "naive", 4096), (7, 7 * 4 * 1296)),
    "n18_tables_config_yaml": ((18, 324, "tables", 10), (1, 52216)),
    "n35_tables_shared": ((35, 1225, "tables", 64), (1, 221112)),
    "n36_tables_device": ((36, 1296, "tables", 8), (1, 0)),
    "n36_naive_shared": ((36, 1296, "naive", 8), (1, 77760)),
    "n4_q63_tables_4096": ((4, 63, "tables", 4096), (8, 8 * 4 * 806)),
}


@pytest.mark.parametrize("case", sorted(FULL3D_LAYOUTS))
def test_full3d_scan_layout(case):
    """The rule that picks the CUDA full-3D scan's shared-memory or
    device-memory variant, its chains per block and its shared memory."""
    (N, Q, kernel, C), (cpb, smem) = FULL3D_LAYOUTS[case]
    layout = full3d.scan_layout(N, Q, kernel, C, 132)
    assert (layout.chains_per_block, layout.smem_bytes) == (cpb, smem)
    assert layout.in_shared == (smem > 0)
    assert 1 <= cpb <= min(board.MAX_CHAINS_PER_BLOCK, -(-C // 132))
    assert layout.smem_bytes <= 232448


def test_segments_resume_and_steps_past_n_steps():
    """Two segments equal one; a carry crossing from JAX resumes exactly;
    chunks past n_steps change nothing."""
    jspec, spec = _specs(dict(N=5, n_steps=100, history_stride=25), LIN)
    keys = rng.chain_keys_from_seeds(SEEDS)
    c0 = board.init_carry_batch(keys, spec, device="cpu")
    whole, ys = board.run_segment(c0, 0, spec, 4)
    mid, ys1 = board.run_segment(c0, 0, spec, 2)
    end, ys2 = board.run_segment(mid, 2, spec, 2)
    for name in ("heights", "table", "energy", "best_heights", "best_step",
                 "accept_bins", "total_bins"):
        assert torch.equal(getattr(end, name), getattr(whole, name)), name
    assert torch.equal(torch.cat([ys1, ys2]), ys)
    jc = jboard.init_carry_batch(jrng.chain_keys_from_seeds(SEEDS), jspec)
    jmid, _ = jboard.run_segment(jc, np.int32(0), jspec, 2)
    crossed = board.BoardCarry(**{
        name: (None if v is None else torch.from_numpy(np.asarray(
            jax.random.key_data(v) if name == "step_base" else v).astype(
            np.int64 if name == "step_base" else np.asarray(v).dtype)))
        for name, v in jmid._asdict().items()})
    resumed, ys3 = board.run_segment(crossed, 2, spec, 2)
    assert torch.equal(resumed.heights, whole.heights)
    assert torch.equal(ys3, ys2)
    after, ys4 = board.run_segment(whole, 4, spec, 3)
    for name in ("heights", "energy", "total_bins", "best_step"):
        assert torch.equal(getattr(after, name), getattr(whole, name))
    assert (ys4 == whole.energy).all()


@pytest.mark.parametrize("mcmc_type", ["board", "full_3d"])
def test_init_carry_single_chain(mcmc_type):
    """The single-chain init equals JAX's, fresh and warm-started."""
    jmod, mod = ((jboard, board) if mcmc_type == "board"
                 else (jfull3d, full3d))
    jspec, spec = _specs(dict(N=4, n_steps=50), LIN, mcmc_type=mcmc_type)
    start = _warm(spec, 3)[0]
    for warm in (None, start):
        want = jmod.init_carry(jrng.chain_keys_from_seeds(SEEDS)[2], jspec,
                               None if warm is None else jnp.asarray(warm))
        got = mod.init_carry(rng.chain_keys_from_seeds(SEEDS)[2], spec,
                             warm, device="cpu")
        _assert_same_carry(want, got)


def test_draw_unoccupied_is_uniform_over_free_cells():
    """The rejection loop only returns free cells, and every free cell of a
    nearly full cube (one free cell in 8, two in 27) is reached."""
    for N, Q in ((2, 7), (3, 25)):
        keys = rng.chain_keys_from_seeds(np.arange(400))
        q, occ = full3d.init_mod.full3d_init(rng.split(keys, 2)[:, 0], N,
                                             "random", Q=Q)
        cell = full3d._draw_unoccupied(keys, occ, N ** 3)
        assert not bool(occ.gather(1, cell[:, None].long()).any())
    single = occ[:1].expand(400, -1)
    cells = full3d._draw_unoccupied(keys, single, 27)
    assert len(set(cells.tolist())) == 2


def test_scan_wrappers_refuse_other_devices():
    """The wrappers take the twin only for CPU state and the kernel only for
    CUDA state; a CUDA request without a GPU raises."""
    _, spec = _specs(dict(N=4, n_steps=20), LIN)
    keys = rng.chain_keys_from_seeds(SEEDS)
    for mod, sp in ((board, spec), (full3d, _specs(
            dict(N=3, n_steps=20), LIN, mcmc_type="full_3d")[1])):
        st = mod.segment_state(mod.init_carry_batch(keys, sp, device="cpu"))
        meta = mod.SegmentState(**{
            k: None if v is None else v.to("meta")
            for k, v in vars(st).items()})
        with pytest.raises(ValueError, match="cpu or cuda"):
            segment.call_scan(mod, meta, 0, 1, sp)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            runner.run_chains(SEEDS, spec, device="cuda")
