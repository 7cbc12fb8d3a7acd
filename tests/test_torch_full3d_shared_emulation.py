"""The shared-site full-3D kernel, run as host C++, against its twin.

``kernels/csrc/full3d_shared.cu`` is CUDA only; on a machine without a card
:mod:`mcqueens_torch.kernels.host_emulation` builds it with g++ against
``kernels/emu/cuda_runtime.h`` (a fiber per CUDA thread, the warp
intrinsics and ``__syncthreads`` over barriers, shared memory filled with
0xA5 so that a slot read before it is written shows) and
``full3d_shared.launch_segment`` runs it on CPU tensors, through the same
argument checks and layout rule as a launch on the card.  Each case runs
launch by launch through the emulated kernel and through the plain-torch
twin (``segment_reference``) from one state; all 15 state fields must be
equal after every launch (tolerance none), plain and tempered.  Skips only
when g++ is absent.  No JAX: the twin is held to the JAX kernel by
``tests/test_torch_full3d_shared.py``.
"""

import numpy as np
import pytest
import torch

from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import schedules
from mcqueens_torch.core.schedules import chunk_betas
from mcqueens_torch.kernels import full3d_shared, host_emulation
from mcqueens_torch.search.tempering import geometric_ladder

N_SM = 2
MODES = ("plain", "tempered")


@pytest.fixture(scope="module")
def lib():
    if host_emulation.compiler() is None:
        pytest.skip("no g++ to build the host emulation of the kernels")
    return host_emulation.load()


def _spec(N, Q, n_steps, stride, sched_type="linear_annealing", **kw):
    sched = dict(constant=dict(beta_const=kw.pop("beta", 50.0)),
                 linear_annealing=dict(beta_start=0.5, beta_end=3.0))
    return ChainSpec(N=N, Q=Q, n_steps=n_steps, history_stride=stride,
                     kernel="pallas_shared", mcmc_type="full_3d",
                     schedule=schedules.build_schedule(
                         sched_type, n_steps, **sched[sched_type]), **kw)


def _carry(spec, n_chains, block=None, seed0=0, **kw):
    seeds = seed0 + np.arange(n_chains, dtype=np.uint32)
    return full3d_shared.init_carry_batch(seeds, spec, block, device="cpu",
                                          **kw)


def _emulated_equals_twin(lib, spec, carry, launches, mode="plain",
                          forced=None, start_outer=0, n_sm=N_SM):
    """Run ``launches`` launches of ``history_stride`` steps from launch
    ``start_outer`` through the twin and the emulated kernel (laid out by
    the rule for ``n_sm`` SMs, or ``forced``), every field equal after
    each; returns (the twin's state, the layout)."""
    twin = full3d_shared.segment_state(carry)
    kern = full3d_shared.segment_state(carry)
    C = twin.energy.shape[0]
    stride = spec.history_stride
    scale = None
    if mode == "tempered":
        ladder = geometric_ladder(0.8, 7.0, 16)
        scale = torch.from_numpy(np.tile(ladder, -(-C // 16))[:C].copy())
    for o in range(start_outer, start_outer + launches):
        beta = chunk_betas(spec.schedule, o * stride, stride, "cpu")
        full3d_shared.segment_reference(twin, o * stride, stride, spec, beta,
                                        scale)
        lay = full3d_shared.launch_segment(
            lib, kern, o * stride, stride, spec, beta, scale, n_sm=n_sm,
            forced=forced)
        for field, want in vars(twin).items():
            got = getattr(kern, field)
            assert torch.equal(got, want), (
                f"{field} differs in {int((got != want).sum())} entries "
                f"(launch {o}, {mode}, {lay})")
    return twin, lay


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "device"])
@pytest.mark.parametrize("lanes", full3d_shared.LANES)
def test_every_layout_forced(lib, lanes, shared, mode):
    """N=6, Q=36 from step 0 (most chains improve in most chunks), 128
    chains in CTAs of 32 / L chains (at least 1), each team size in both
    instances; 44 steps end on a 4-step chunk."""
    spec = _spec(6, 36, 5000, 44)
    cpb = max(1, 32 // lanes)
    smem = full3d_shared.cta_smem_bytes(36, lanes, cpb)
    forced = full3d_shared.Layout(lanes, cpb, smem if shared else 0)
    end, _ = _emulated_equals_twin(lib, spec, _carry(spec, 128), 1, mode,
                                   forced)
    assert int((end.best_step > 0).sum()) > 100


@pytest.mark.parametrize("mode", MODES)
def test_patience_stops(lib, mode):
    """N=5, Q=13 at beta=50 with patience 13: chains stop at different
    steps inside one warp and inside a chunk."""
    spec = _spec(5, 13, 300, 32, "constant", early_stop_patience=13)
    end, lay = _emulated_equals_twin(lib, spec, _carry(spec, 256, seed0=3),
                                     3, mode)
    stopped = end.stop_step[end.stop_step < spec.n_steps]
    teams = 32 // lay.lanes
    assert lay.lanes > 1 and len(stopped) > 16
    assert len(set((stopped % 8).tolist())) > 1
    warps = {}
    for c in torch.nonzero(end.stop_step < spec.n_steps).flatten().tolist():
        warps.setdefault(c // teams, set()).add(int(end.stop_step[c]))
    assert any(len(v) > 1 for v in warps.values())


@pytest.mark.parametrize("mode", MODES)
def test_nearly_full_cube(lib, mode):
    """N=3, Q=26: 26 of 27 cells occupied, so nearly every candidate is
    lazy, and a candidate equal to the mover's chunk-start cell is free once
    the mover has left it."""
    spec = _spec(3, 26, 190, 44)
    end, _ = _emulated_equals_twin(lib, spec, _carry(spec, 256), 2, mode)
    assert 0 < int(end.accept_bins.sum()) < int(end.total_bins.sum()) // 4


@pytest.mark.parametrize("mode", MODES)
def test_short_tail_chunks(lib, mode):
    """A stride of 13 ends every launch on a 5-step chunk, and n_steps =
    60 stops the last launch 8 steps into it (steps past n_steps change
    nothing)."""
    spec = _spec(5, 13, 60, 13)
    _emulated_equals_twin(lib, spec, _carry(spec, 128, seed0=9), 5, mode)


@pytest.mark.parametrize("mode", MODES)
def test_several_blocks(lib, mode):
    """300 chains in three semantic blocks of 100: CTAs of at most 4 chains
    (a CTA holds one block), each block its own candidate and mover
    streams; two launches from launch 5."""
    spec = _spec(6, 36, 100_000, 40)
    carry = _carry(spec, 300, block=100, seed0=7)
    assert carry.block_seeds.shape[0] == 3
    _, lay = _emulated_equals_twin(lib, spec, carry, 2, mode, start_outer=5)
    assert 100 % lay.chains_per_cta == 0 and lay.chains_per_cta <= 4


@pytest.mark.parametrize("mode", MODES)
def test_many_ctas_by_rule(lib, mode):
    """512 chains in blocks of 256, laid out by the rule for the H100's 132
    SMs: many CTAs of a few chains, large teams."""
    spec = _spec(5, 13, 5000, 44)
    carry = _carry(spec, 512, block=256, seed0=42)
    _, lay = _emulated_equals_twin(lib, spec, carry, 1, mode, n_sm=132)
    assert 512 // lay.chains_per_cta >= 32 and lay.lanes >= 8


@pytest.mark.parametrize("mode", MODES)
def test_best_planes_far_behind(lib, mode):
    """One 96-step launch at a warm beta from a cold start: chains improve
    early and then move for many chunks, so their best planes are many
    moves behind the live ones; some improve on the launch's last step."""
    spec = _spec(6, 36, 96, 96, "constant", beta=0.3)
    end, _ = _emulated_equals_twin(lib, spec, _carry(spec, 256, seed0=5), 1,
                                   mode)
    moved_after = (end.best_step < 64) & (end.best_step > 0)
    assert int(moved_after.sum()) > 10
    assert int((end.best_step == spec.history_stride).sum()) > 0
    assert not torch.equal(end.best_qi, end.qi)


@pytest.mark.parametrize("mode", MODES)
def test_warm_start_at_least_energy(lib, mode):
    """N=11 Klarner placements (energy 0, the least there is) at a warm
    beta: moves are accepted but no chain can improve, so no best plane may
    be written (shared memory holds 0xA5 where one was never copied)."""
    spec = _spec(11, None, 96, 48, "constant", beta=0.5,
                 init_mode="klarner")
    carry = _carry(spec, 128)
    end, _ = _emulated_equals_twin(lib, spec, carry, 2, mode)
    assert int(end.best_energy.abs().max()) == 0
    assert int(end.best_step.max()) == 0
    assert torch.equal(end.best_qi, carry.best_qi.t())
    assert int(end.accept_bins.sum()) > 0


def test_warm_starts(lib):
    """Random warm starts, both modes, by the rule's layout."""
    spec = _spec(5, 20, 400, 33)
    rs = np.random.default_rng(5)
    starts = np.stack([np.stack(np.unravel_index(
        rs.choice(125, 20, replace=False), (5, 5, 5)), 1)
        for _ in range(128)])
    carry = _carry(spec, 128, initial_states=starts)
    for mode in MODES:
        _emulated_equals_twin(lib, spec, carry, 2, mode)


@pytest.mark.parametrize("lanes", full3d_shared.LANES)
def test_every_team_size_delayed_memory(lib, lanes, monkeypatch):
    """Each team size in shared memory under the emulator's delayed memory
    model (only __syncwarp and __syncthreads make one thread's stores
    visible to another): a lane that read a row another lane stored after
    their last common barrier, such as the mover's start cell read by every
    lane instead of handed over by its owner's shuffle, sees the old cell
    and fails the compare."""
    monkeypatch.setenv("MCQ_EMU_MEMORY", "delayed")
    spec = _spec(6, 36, 4000, 200)  # 25 chunks: movers recur in a launch
    cpb = max(1, 32 // lanes)
    forced = full3d_shared.Layout(
        lanes, cpb, full3d_shared.cta_smem_bytes(spec.q_eff, lanes, cpb))
    _emulated_equals_twin(lib, spec, _carry(spec, 64, seed0=11), 1,
                          forced=forced)


@pytest.mark.parametrize("memory", ["ordered", "delayed"])
@pytest.mark.parametrize("hold", [16, 32])
@pytest.mark.parametrize("lanes,shared,mode", [
    (1, True, "plain"), (4, True, "tempered"), (32, True, "plain"),
    (8, False, "tempered")], ids=["1-shared", "4-shared", "32-shared",
                                  "8-device"])
def test_long_holds(lib, lanes, shared, mode, hold, memory, monkeypatch):
    """The kernel's hold-16 and hold-32 instances (``_HOLD`` patched, as
    the probe of the hold does) in both memory models: N=5, Q=13, 32
    chains in one block, two 1100-step launches (each ends on a 12-step
    chunk) with 20-step bins turning inside chunks and patience stopping
    chains mid-chunk."""
    monkeypatch.setenv("MCQ_EMU_MEMORY", memory)
    monkeypatch.setattr(full3d_shared, "_HOLD", hold)
    spec = _spec(5, 13, 2000, 1100, early_stop_patience=900)
    cpb = max(1, 32 // lanes)
    smem = full3d_shared.cta_smem_bytes(13, lanes, cpb)
    forced = full3d_shared.Layout(lanes, cpb, smem if shared else 0)
    carry = _carry(spec, 32, block=32, seed0=hold)
    end, _ = _emulated_equals_twin(lib, spec, carry, 2, mode, forced)
    stopped = int((end.stop_step < spec.n_steps).sum())
    assert 0 < stopped < end.energy.shape[0]
