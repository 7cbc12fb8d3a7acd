"""The per-chain board kernel, run as host C++, against its twin.

``kernels/csrc/metropolis.cu`` is CUDA only; on a machine without a card
:mod:`mcqueens_torch.kernels.host_emulation` builds it with g++ against
``kernels/emu/cuda_runtime.h`` (a fiber per CUDA thread released in a
seeded pseudo-random order, the warp intrinsics and ``__syncthreads`` over
barriers, shared memory filled with 0xA5 so that a slot read before it is
written shows) and ``metropolis_pallas.launch_segment`` runs it on CPU
tensors, through the same argument checks and layout rule as a launch on
the card.  Each case runs chunk by chunk through the emulated kernel and
through the plain-torch twin (``segment_reference``) from one state; all 10
state fields must be equal after every chunk (tolerance none).  The cases
marked ``memory`` run in both of the emulator's shared-memory models:
``ordered`` (a store is seen at once) and ``delayed`` (only ``__syncwarp``
and ``__syncthreads`` make one thread's stores visible to another, and
racing stores fail the launch).  Skips only when g++ is absent.  No JAX:
the twin is held to the JAX kernel by ``tests/test_torch_metropolis.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import schedules
from mcqueens_torch.core.schedules import chunk_betas
from mcqueens_torch.kernels import _build, host_emulation, metropolis_pallas

N_SM = 2
Layout = metropolis_pallas.Layout


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


def _spec(N, n_steps, stride, sched_type="linear_annealing", **kw):
    sched = dict(constant=dict(beta_const=kw.pop("beta", 50.0)),
                 linear_annealing=dict(beta_start=1.0, beta_end=3.0))
    return ChainSpec(N=N, n_steps=n_steps, history_stride=stride,
                     kernel="pallas", schedule=schedules.build_schedule(
                         sched_type, n_steps, **sched[sched_type]), **kw)


def _carry(spec, n_chains, seed0=0, **kw):
    seeds = seed0 + np.arange(n_chains, dtype=np.uint32)
    return metropolis_pallas.init_carry_batch(seeds, spec, device="cpu",
                                              **kw)


def _forced(N, lanes, cpb=None):
    cpb = cpb or max(1, 32 // lanes)
    return Layout(lanes, cpb, metropolis_pallas.cta_smem_bytes(N, cpb))


def _emulated_equals_twin(lib, spec, carry, steps, step0=0, forced=None):
    """Run chunks of ``steps`` (a list of chunk lengths) from global step
    ``step0`` through the twin and the emulated kernel (laid out by the
    rule for ``N_SM`` SMs, or ``forced``), every field equal after each;
    returns (the twin's state, the layout)."""
    twin = metropolis_pallas.segment_state(carry)
    kern = metropolis_pallas.segment_state(carry)
    for n in steps:
        beta = chunk_betas(spec.schedule, step0, n, "cpu")
        metropolis_pallas.segment_reference(twin, step0, n, spec, beta)
        lay = metropolis_pallas.launch_segment(
            lib, kern, step0, n, spec, beta, n_sm=N_SM, forced=forced)
        for field, want in vars(twin).items():
            got = getattr(kern, field)
            assert torch.equal(got, want), (
                f"{field} differs in {int((got != want).sum())} entries "
                f"(chunk from {step0}, {n} steps, {lay})")
        step0 += n
    return twin, lay


@pytest.mark.parametrize("lanes", metropolis_pallas.LANES)
def test_every_team_size_forced(lib, lanes, memory):
    """N=16 from step 0 (many improvements), 64 chains, each team size in
    CTAs of two warps' chains; at L < 16 a lane scores more than one row
    offset, and a 40-step chunk ends inside a batch."""
    spec = _spec(16, 50000, 40)
    end, _ = _emulated_equals_twin(lib, spec, _carry(spec, 64, seed0=42),
                                   [40, 40], forced=_forced(
                                       16, lanes, max(2, 64 // lanes)))
    assert int((end.best_step > 0).sum()) > 40


def test_lines_over_several_passes_of_a_whole_warp(lib):
    """N=37 at L=32: lanes 0-4 score two row offsets, the rest one."""
    spec = _spec(37, 10_000, 34)
    _emulated_equals_twin(lib, spec, _carry(spec, 8, seed0=5), [34],
                          forced=_forced(37, 32, 2))


@pytest.mark.parametrize("lanes", [4, 32])
def test_patience_and_bin_edges_inside_batches(lib, lanes, memory):
    """N=5 at beta=50 with patience 13 and 30 bins of 10 steps: stops and
    bin edges fall inside a team's batch of L draws, and a chain stops at
    different steps from its warp's other teams."""
    spec = _spec(5, 300, 50, "constant", early_stop_patience=13, n_bins=30)
    end, lay = _emulated_equals_twin(
        lib, spec, _carry(spec, 64, seed0=3), [50, 50, 50],
        forced=_forced(5, lanes, max(2, 64 // lanes)))
    stopped = end.stop_step[end.stop_step < spec.n_steps]
    assert len(stopped) > 16
    assert len(set((stopped % lay.lanes).tolist())) > 1
    assert int((end.total_bins > 0).sum(1).min()) > 1


@pytest.mark.parametrize("lanes", [8, 32])
def test_segments_of_one_and_either_side_of_a_batch(lib, lanes):
    """Chunks of 1, L - 1 and L + 1 steps, the first from past step 2^24
    (float32 steps round), 20 bins."""
    spec = _spec(9, 2 ** 25, 64, n_bins=20)
    step0 = 2 ** 24 + 3
    _emulated_equals_twin(lib, spec, _carry(spec, 32, seed0=9),
                          [1, lanes - 1, lanes + 1], step0=step0,
                          forced=_forced(9, lanes, max(1, 32 // lanes)))


@pytest.mark.parametrize("N", [2, 5])
def test_smallest_boards(lib, N):
    """N=2 (kr is always 0: every move flips the height) and N=5, by the
    rule, over more than a batch, past n_steps on the last chunk."""
    spec = _spec(N, 120, 50)
    carry = _carry(spec, 64)
    _, lay = _emulated_equals_twin(lib, spec, carry, [50, 50, 50])
    assert lay == metropolis_pallas.layout(N, carry.energy.shape[0], N_SM)


def test_padded_chains_across_ctas(lib, memory):
    """200 chains padded to 256 in blocks of 128, by the rule for 2 SMs, a
    forced layout whose last CTA is ragged (3 chains a CTA), and warm
    starts anywhere in [0, N)."""
    spec = _spec(12, 100_000, 24)
    starts = np.random.default_rng(5).integers(0, 12, size=(200, 12, 12))
    carry = _carry(spec, 200, seed0=7, initial_states=starts)
    assert carry.energy.shape[0] == 256
    _emulated_equals_twin(lib, spec, carry, [24, 24], step0=480)
    _, lay = _emulated_equals_twin(lib, spec, carry, [24],
                                   forced=_forced(12, 32, 3))
    assert 256 % lay.chains_per_cta


def test_klarner_no_improvement(lib, memory):
    """N=11 Klarner boards (energy 0, the least there is) at a cold and a
    warm beta: no chain can improve, so no best board may be written
    (shared memory holds 0xA5 where a best board was never copied)."""
    for beta in (100.0, 0.5):
        spec = _spec(11, 256, 64, "constant", beta=beta,
                     init_mode="klarner")
        carry = _carry(spec, 64)
        end, _ = _emulated_equals_twin(lib, spec, carry, [64, 64])
        assert int(end.best_energy.abs().max()) == 0
        assert int(end.best_step.max()) == 0
        assert torch.equal(end.best_heights, carry.best_heights)
        if beta == 0.5:
            assert int(end.accept_bins.sum()) > 0


def test_heights_outside_range_refused():
    """A board keeps its heights as bytes: a height outside [0, N) is
    refused, not truncated, both as a warm start and in a carry handed to
    the segment layer."""
    spec = _spec(6, 100, 10)
    seeds = np.arange(128, dtype=np.uint32)
    starts = np.random.default_rng(0).integers(0, 6, size=(128, 6, 6))
    carry = metropolis_pallas.init_carry_batch(seeds, spec, device="cpu",
                                               initial_states=starts)
    metropolis_pallas.segment_state(carry)
    match = r"heights must lie in \[0, 6\)"
    for bad in (6, -1, 256):
        s = starts.copy()
        s[3, 2, 1] = bad
        with pytest.raises(ValueError, match=match):
            metropolis_pallas.init_carry_batch(seeds, spec, device="cpu",
                                               initial_states=s)
        h = carry.heights.clone()
        h[3, 13] = bad
        with pytest.raises(ValueError, match=match):
            metropolis_pallas.segment_state(
                dataclasses.replace(carry, heights=h))


@pytest.mark.parametrize("C", [1, 128, 1000, 4096, 32768])
def test_layout_every_n_fits_a_block(C):
    """Every N the kernel takes gets a layout: whole warps, at most 1024
    threads and the CTA's slots within a block's shared memory."""
    for N in range(2, metropolis_pallas.MAX_N + 1):
        lay = metropolis_pallas.layout(N, C, 132)
        threads = lay.lanes * lay.chains_per_cta
        assert lay.lanes in metropolis_pallas.LANES
        assert threads % 32 == 0 and threads <= 1024
        assert lay.smem_bytes == metropolis_pallas.cta_smem_bytes(
            N, lay.chains_per_cta) <= _build.SMEM_PER_BLOCK
        assert metropolis_pallas.slot_bytes(N) >= 2 * N * N


def test_layout_rule_and_limits():
    """Few chains take larger teams than many; N outside [2, 170] is
    refused by the rule and by the launcher."""
    few = metropolis_pallas.layout(16, 128, 132)
    many = metropolis_pallas.layout(16, 32768, 132)
    assert few.lanes > many.lanes
    for N in (1, 171):
        with pytest.raises(ValueError, match="2 <= N <= 170"):
            metropolis_pallas.layout(N, 128, 132)
