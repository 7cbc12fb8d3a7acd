"""The per-chain full-3D kernel, run as host C++, against its twin.

``kernels/csrc/full3d_pallas.cu`` is CUDA only; on a machine without a card
:mod:`mcqueens_torch.kernels.host_emulation` builds it with g++ against
``kernels/emu/cuda_runtime.h`` (a fiber per CUDA thread released in a
seeded pseudo-random order, the warp intrinsics and ``__syncthreads`` over
barriers, shared memory filled with 0xA5 so that a slot read before it is
written shows) and ``full3d_pallas.launch_segment`` runs it on CPU tensors,
through the same argument checks and layout rule as a launch on the card.
Each case runs chunk by chunk through the emulated kernel and through the
plain-torch twin (``segment_reference``) from one state; all 15 state fields
must be equal after every chunk (tolerance none).  The cases marked
``memory`` run in both of the emulator's shared-memory models: ``ordered``
(a store is seen at once) and ``delayed`` (only ``__syncwarp`` and
``__syncthreads`` make one thread's stores visible to another, and racing
stores fail the launch).  Skips only when g++ is absent.  No JAX: the twin
is held to the JAX kernel by ``tests/test_torch_full3d_pallas.py``.
"""

import numpy as np
import pytest
import torch

from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import fastinit, schedules
from mcqueens_torch.core.schedules import chunk_betas
from mcqueens_torch.kernels import _build, full3d_pallas, host_emulation, prng

N_SM = 2
Layout = full3d_pallas.Layout


@pytest.fixture(scope="module")
def lib():
    if host_emulation.compiler() is None:
        pytest.skip("no g++ to build the host emulation of the kernels")
    return host_emulation.load()


@pytest.fixture(params=["ordered", "delayed"])
def memory(request, monkeypatch):
    """The emulator's shared-memory model for the test's launches."""
    monkeypatch.setenv("MCQ_EMU_MEMORY", request.param)
    return request.param


def _spec(N, Q, n_steps, stride, sched_type="linear_annealing", **kw):
    sched = dict(constant=dict(beta_const=kw.pop("beta", 50.0)),
                 linear_annealing=dict(beta_start=0.5, beta_end=3.0))
    return ChainSpec(N=N, Q=Q, n_steps=n_steps, history_stride=stride,
                     kernel="pallas", mcmc_type="full_3d",
                     schedule=schedules.build_schedule(
                         sched_type, n_steps, **sched[sched_type]), **kw)


def _state(spec, n_chains, seed0=0, **kw):
    """The first ``n_chains`` chains of an ``init_carry_batch`` carry (so C
    need not be whole blocks)."""
    seeds = seed0 + np.arange(n_chains, dtype=np.uint32)
    st = full3d_pallas.segment_state(full3d_pallas.init_carry_batch(
        seeds, spec, device="cpu", **kw))
    return full3d_pallas.SegmentState(**{
        k: v[:n_chains].contiguous() for k, v in vars(st).items()})


def _forced(spec, lanes, cpb=None):
    cpb = cpb or max(1, 32 // lanes)
    return Layout(lanes, cpb, full3d_pallas.cta_smem_bytes(
        spec.q_eff, spec.N, lanes, cpb))


def _copy(st):
    return full3d_pallas.SegmentState(**{k: v.clone()
                                         for k, v in vars(st).items()})


def _emulated_equals_twin(lib, spec, st, steps, step0=0, forced=None):
    """Run chunks of ``steps`` (a list of chunk lengths) from global step
    ``step0`` through the twin and the emulated kernel (laid out by the
    rule for ``N_SM`` SMs, or ``forced``), every field equal after each;
    returns (the twin's state, the layout)."""
    twin, kern = _copy(st), _copy(st)
    for n in steps:
        beta = chunk_betas(spec.schedule, step0, n, "cpu")
        full3d_pallas.segment_reference(twin, step0, n, spec, beta)
        lay = full3d_pallas.launch_segment(
            lib, kern, step0, n, spec, beta, n_sm=N_SM, forced=forced)
        for field, want in vars(twin).items():
            got = getattr(kern, field)
            assert torch.equal(got, want), (
                f"{field} differs in {int((got != want).sum())} entries "
                f"(chunk from {step0}, {n} steps, {lay})")
        step0 += n
    return twin, lay


def _occupied_first_attempts(st, spec, step0):
    """Chains whose first two rejection attempts at ``step0`` both hit an
    occupied cell of their starting bitfield."""
    base = prng.step_base(prng.chain_streams(st.chain_seeds), step0)
    cells = torch.stack([
        prng.word_from_base(base, full3d_pallas._A_SALT + a) % spec.N ** 3
        for a in range(2)], 1)
    return int(full3d_pallas._bit(st.occ, cells).all(1).sum())


@pytest.mark.parametrize("lanes", full3d_pallas.LANES)
def test_every_team_size_forced(lib, lanes, memory):
    """N=6, Q=36 from step 0 (many improvements, so many best copies), 64
    chains, each team size in CTAs of two warps' chains; 36 queens are no
    multiple of 8, 16 or 32, so the last pass leaves lanes without a row,
    and a 24-step chunk ends inside a batch."""
    spec = _spec(6, 36, 50000, 40)
    cpb = max(2, 64 // lanes)
    end, _ = _emulated_equals_twin(lib, spec, _state(spec, 64, seed0=42),
                                   [24, 40], forced=_forced(spec, lanes, cpb))
    assert int((end.best_step > 0).sum()) > 40


@pytest.mark.parametrize("N, Q", [(3, 26), (2, 7)])
@pytest.mark.parametrize("lanes", [1, 4, 32])
def test_long_attempt_runs(lib, N, Q, lanes):
    """One free cell in 27 (N=3, Q=26) or in 8 (N=2, Q=7): nearly every
    step walks past the two attempts drawn ahead, over rounds of L
    attempts, until every team of the warp has its cell."""
    spec = _spec(N, Q, 200, 40)
    end, _ = _emulated_equals_twin(lib, spec, _state(spec, 32, seed0=N),
                                   [40, 40], forced=_forced(spec, lanes))
    assert int(end.accept_bins.sum()) > 0


def test_first_attempts_occupied_past_the_batch(lib, memory):
    """N=4, Q=48 (three cells in four occupied): both attempts drawn ahead
    are taken at most steps, and the rounds of further attempts pick the
    first free one, by the rule and at a whole warp."""
    spec = _spec(4, 48, 1000, 30)
    st = _state(spec, 64, seed0=11)
    assert _occupied_first_attempts(st, spec, 0) > 16
    _emulated_equals_twin(lib, spec, st, [30, 30])
    _emulated_equals_twin(lib, spec, st, [30], forced=_forced(spec, 32))


@pytest.mark.parametrize("lanes", [4, 32])
def test_patience_and_bin_edges_inside_batches(lib, lanes, memory):
    """N=4, Q=16 at beta=50 with patience 13 and 30 bins of 10 steps: stops
    and bin edges fall inside a team's batch of L draws, and a chain stops
    at different steps from its warp's other teams."""
    spec = _spec(4, 16, 300, 50, "constant", early_stop_patience=13,
                 n_bins=30)
    end, lay = _emulated_equals_twin(
        lib, spec, _state(spec, 64, seed0=3), [50, 50, 50],
        forced=_forced(spec, lanes, max(2, 64 // lanes)))
    stopped = end.stop_step[end.stop_step < spec.n_steps]
    assert len(stopped) > 16
    assert len(set((stopped % lay.lanes).tolist())) > 1
    assert int((end.total_bins > 0).sum(1).min()) > 1


@pytest.mark.parametrize("lanes", [8, 32])
def test_segments_of_one_and_either_side_of_a_batch(lib, lanes):
    """Chunks of 1, L - 1 and L + 1 steps (1, 31 and 33 at a whole warp),
    the first from past step 2^24 (float32 steps round), 20 bins."""
    spec = _spec(6, 36, 2 ** 25, 64, n_bins=20)
    _emulated_equals_twin(lib, spec, _state(spec, 32, seed0=9),
                          [1, lanes - 1, lanes + 1], step0=2 ** 24 + 3,
                          forced=_forced(spec, lanes))


def test_ragged_last_cta(lib, memory):
    """100 chains: by the rule for 2 SMs, and forced to 3 chains a CTA of
    whole warps, whose last CTA holds one chain and two teams that do not
    exist (they walk the warp's steps and change nothing)."""
    spec = _spec(5, 25, 100_000, 24)
    st = _state(spec, 100, seed0=7)
    _emulated_equals_twin(lib, spec, st, [24, 24], step0=480)
    _, lay = _emulated_equals_twin(lib, spec, st, [24],
                                   forced=_forced(spec, 32, 3))
    assert 100 % lay.chains_per_cta == 1


def test_klarner_no_improvement(lib, memory):
    """N=11 Klarner placements (energy 0, the least there is) at a cold and
    a warm beta: no chain can improve, so no best queen may be written
    (shared memory holds 0xA5 where best queens were never copied)."""
    for beta in (100.0, 0.5):
        spec = _spec(11, 121, 256, 64, "constant", beta=beta)
        warm = fastinit.full3d_init_batch(torch.zeros(32, dtype=torch.int32),
                                          11, "klarner").numpy()
        st = _state(spec, 32, initial_states=warm)
        end, _ = _emulated_equals_twin(lib, spec, st, [64, 64])
        assert int(end.best_energy.abs().max()) == 0
        assert int(end.best_step.max()) == 0
        for name in ("best_qi", "best_qj", "best_qk"):
            assert torch.equal(getattr(end, name), getattr(st, name))
        if beta == 0.5:
            assert int(end.accept_bins.sum()) > 0


def test_entry_point_refuses_a_wrong_layout(lib):
    """A CTA's shared memory that is not its slots', or a team size that is
    not a power of two, is refused before anything runs."""
    spec = _spec(5, 13, 100, 10)
    st = _state(spec, 32)
    beta = chunk_betas(spec.schedule, 0, 10, "cpu")
    before = _copy(st)
    for bad in (Layout(8, 4, 4 * 4 * 30), Layout(3, 32, 0)):
        with pytest.raises(RuntimeError, match="cudaError 1"):
            full3d_pallas.launch_segment(lib, st, 0, 10, spec, beta,
                                         n_sm=N_SM, forced=bad)
    for field, want in vars(before).items():
        assert torch.equal(getattr(st, field), want)


@pytest.mark.parametrize("C", [1, 128, 4096, 65536])
def test_layout_every_shape_the_kernel_takes_fits_a_block(C):
    """Every N with Q = N^2 up to 104, and every N up to 122 at the largest
    Q whose slot fits, gets a layout: whole warps, at most
    ``MAX_THREADS_PER_CTA`` threads and the CTA's slots within a block's
    shared memory."""
    shapes = [(N, N * N) for N in range(2, 105)]
    for N in range(2, 123):
        q = (_build.SMEM_PER_BLOCK // 4 - full3d_pallas._occ_words(N)) // 2
        shapes.append((N, min(q, N ** 3 - 1)))
    for N, Q in shapes:
        lay = full3d_pallas.layout(N, Q, C, 132)
        threads = lay.lanes * lay.chains_per_cta
        assert lay.lanes in full3d_pallas.LANES
        assert threads % 32 == 0
        assert threads <= full3d_pallas.MAX_THREADS_PER_CTA
        assert lay.smem_bytes == full3d_pallas.cta_smem_bytes(
            Q, N, lay.lanes, lay.chains_per_cta) <= _build.SMEM_PER_BLOCK
        assert full3d_pallas.slot_words(Q, N, lay.lanes) >= 2 * Q + (
            full3d_pallas._occ_words(N))


def test_layout_limits():
    """A chain's 4 * (2Q + ceil(N^3/32)) bytes beyond a block's shared
    memory (N=105 at Q = N^2, N=123 at Q=1), Q >= N^3 and Q < 1 are refused
    by the rule; a team size whose warp of slots does not fit is refused
    when forced."""
    for N, Q in ((105, 105 ** 2), (123, 1)):
        with pytest.raises(ValueError, match="232448 bytes a block"):
            full3d_pallas.layout(N, Q, 128, 132)
    for N, Q in ((3, 27), (4, 0)):
        with pytest.raises(ValueError, match="1 <= Q < N"):
            full3d_pallas.layout(N, Q, 128, 132)
    with pytest.raises(ValueError, match=r"no layout of \(1,\) lanes"):
        full3d_pallas.layout(100, 10000, 128, 132, lanes=1)


def test_layout_slots_fall_in_distinct_banks():
    """Below 32 lanes a slot is an odd multiple of the team size (mod 2L),
    so the 32 / L teams of a warp load their queens from 32 banks."""
    for lanes in full3d_pallas.LANES[:-1]:
        for N, Q in ((12, 144), (15, 225), (5, 13), (3, 26)):
            s = full3d_pallas.slot_words(Q, N, lanes)
            banks = {(t * s + r) % 32 for t in range(32 // lanes)
                     for r in range(lanes)}
            assert len(banks) == 32
