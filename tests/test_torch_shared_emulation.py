"""The shared-site board kernel, run as host C++, against its twin.

``kernels/csrc/board_shared.cu`` is CUDA only; on a machine without a card
:mod:`mcqueens_torch.kernels.host_emulation` builds it with g++ against
``kernels/emu/cuda_runtime.h`` (a fiber per CUDA thread, the warp
intrinsics and ``__syncthreads`` over barriers, shared memory filled with
0xA5 so that a slot read before it is written shows) and
``board_shared.launch_segment`` runs it on CPU tensors, through the same
argument checks and layout rule as a launch on the card.  Each case runs
chunk by chunk through the emulated kernel and through the plain-torch twin
(``segment_reference``) from one state; all 11 state fields must be equal
after every chunk (tolerance none), in the main, tempered and freeze modes.
Skips only when g++ is absent.  No JAX: the twin is held to the JAX kernel
by ``tests/test_torch_board_shared.py``.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import schedules
from mcqueens_torch.core.schedules import chunk_betas
from mcqueens_torch.kernels import board_shared, host_emulation
from mcqueens_torch.search.tempering import geometric_ladder

N_SM = 2
MODES = ("main", "tempered", "freeze")


@pytest.fixture(scope="module")
def lib():
    if host_emulation.compiler() is None:
        pytest.skip("no g++ to build the host emulation of the kernels")
    return host_emulation.load()


def _spec(N, n_steps, stride, sched_type="linear_annealing", **kw):
    sched = dict(constant=dict(beta_const=kw.pop("beta", 50.0)),
                 linear_annealing=dict(beta_start=1.0, beta_end=3.0))
    return ChainSpec(N=N, n_steps=n_steps, history_stride=stride,
                     kernel="pallas_shared", schedule=schedules.build_schedule(
                         sched_type, n_steps, **sched[sched_type]), **kw)


def _mode_args(mode, C, lo, hi, seed=0):
    """(beta_scale, freeze, track_best) of a mode for C chains: a 16-rung
    ladder, or horizons at 0 for half the chains and in [lo, hi) for the
    rest."""
    if mode == "tempered":
        ladder = geometric_ladder(1.0, 3.0, 16)
        return (torch.from_numpy(np.tile(ladder, -(-C // 16))[:C].copy()),
                None, True)
    if mode == "freeze":
        rs = np.random.default_rng(seed)
        freeze = rs.integers(lo, hi, C).astype(np.int32)
        freeze[::2] = 0
        return None, torch.from_numpy(freeze), False
    return None, None, True


def _emulated_equals_twin(lib, spec, carry, chunks, mode="main", forced=None,
                          start_outer=0, seed=0):
    """Run ``chunks`` chunks of ``history_stride`` steps from chunk
    ``start_outer`` through the twin and the emulated kernel (laid out by
    the rule for ``N_SM`` SMs, or ``forced``), every field equal after
    each; returns (the twin's state, the layout)."""
    twin = board_shared.segment_state(carry)
    kern = board_shared.segment_state(carry)
    C = twin.energy.shape[0]
    stride = spec.history_stride
    scale, freeze, track = _mode_args(
        mode, C, start_outer * stride,
        (start_outer + chunks) * stride + stride // 2, seed)
    for o in range(start_outer, start_outer + chunks):
        beta = chunk_betas(spec.schedule, o * stride, stride, "cpu")
        board_shared.segment_reference(twin, o * stride, stride, spec, beta,
                                       scale, freeze=freeze,
                                       track_best=track)
        lay = board_shared.launch_segment(
            lib, kern, o * stride, stride, spec, beta, scale, freeze=freeze,
            track_best=track, n_sm=N_SM, forced=forced)
        for field, want in vars(twin).items():
            got = getattr(kern, field)
            assert torch.equal(got, want), (
                f"{field} differs in {int((got != want).sum())} entries "
                f"(chunk {o}, {mode}, {lay})")
    return twin, lay


def _carry(spec, n_chains, block=None, seed0=0, **kw):
    seeds = seed0 + np.arange(n_chains, dtype=np.uint32)
    return board_shared.init_carry_batch(seeds, spec, block, device="cpu",
                                         **kw)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "device"])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_every_layout_forced(lib, lanes, shared, mode):
    """N=16 from step 0 (many improvements), 128 chains in CTAs of
    max(32 / L, 16) chains, each team size in both instances (the freeze
    mode holds half the chains at step 0)."""
    spec = _spec(16, 50000, 48)
    cpb = max(32 // lanes, 16)
    smem = board_shared.cta_smem_bytes(16, cpb, mode != "freeze")
    forced = board_shared.Layout(lanes, cpb, smem if shared else 0)
    end, _ = _emulated_equals_twin(lib, spec, _carry(spec, 128), 1, mode,
                                   forced)
    assert int((end.best_step > 0).sum()) > 40


@pytest.mark.parametrize("mode", MODES)
def test_patience_stops(lib, mode):
    """N=5 at beta=50 with patience 13: chains stop at different steps
    inside one warp and inside a team's batch of draws."""
    spec = _spec(5, 300, 32, "constant", early_stop_patience=13)
    end, lay = _emulated_equals_twin(lib, spec, _carry(spec, 256, seed0=3),
                                     3, mode)
    stopped = end.stop_step[end.stop_step < spec.n_steps]
    assert lay.lanes > 1 and len(stopped) > 16
    assert len(set((stopped % lay.lanes).tolist())) > 1


@pytest.mark.parametrize("mode", MODES)
def test_klarner_no_improvement(lib, mode):
    """N=11 Klarner boards (energy 0, the least there is) at a cold and a
    warm beta: no chain can improve, so no best board may be written
    (shared memory holds 0xA5 where a best board was never copied)."""
    for beta in (100.0, 0.5):
        spec = _spec(11, 256, 64, "constant", beta=beta,
                     init_mode="klarner")
        carry = _carry(spec, 128)
        end, _ = _emulated_equals_twin(lib, spec, carry, 2, mode)
        assert int(end.best_energy.abs().max()) == 0
        assert int(end.best_step.max()) == 0
        assert torch.equal(end.best_heights, carry.best_heights.t())
        if beta == 0.5 and mode != "freeze":
            assert int(end.accept_bins.sum()) > 0


@pytest.mark.parametrize("mode", MODES)
def test_several_blocks_ragged_ctas(lib, mode):
    """300 chains in three semantic blocks of 100: blocks straddle CTAs and
    the last CTA is ragged; two chunks from chunk 5."""
    spec = _spec(12, 100_000, 40)
    carry = _carry(spec, 300, block=100, seed0=7)
    assert carry.block_seeds.shape[0] == 3
    _, lay = _emulated_equals_twin(lib, spec, carry, 2, mode, start_outer=5)
    assert 300 % lay.chains_per_cta


@pytest.mark.parametrize("mode", MODES)
def test_padded_blocks_across_ctas(lib, mode):
    """1000 chains padded to 1024 in blocks of 512 (the rule's layout
    spans many CTAs), N=16 from step 0."""
    spec = _spec(16, 50000, 48)
    carry = _carry(spec, 1000, block=512, seed0=42)
    assert carry.energy.shape[0] == 1024
    _emulated_equals_twin(lib, spec, carry, 1, mode)


@pytest.mark.parametrize("mode", MODES)
def test_device_instance_by_rule(lib, mode):
    """N=128 has no shared-memory instance: the rule walks device memory."""
    spec = _spec(128, 1 << 20, 8)
    _, lay = _emulated_equals_twin(lib, spec, _carry(spec, 16), 1, mode)
    assert not lay.in_shared


def test_freeze_horizons_inside_chunk(lib):
    """The recover replay's launch: horizons inside the chunk (half at 0),
    chunks that end before, at and after them, and a tail past n_steps."""
    spec = _spec(16, 200, 48)
    _emulated_equals_twin(lib, spec, _carry(spec, 256), 5, "freeze",
                          seed=11)


def test_warm_start_heights_outside_range_refused():
    """A board keeps its heights as bytes: a height outside [0, N) is
    refused, not truncated, both as a warm start and in a carry handed to
    the segment layer."""
    spec = _spec(6, 100, 10)
    seeds = np.arange(128, dtype=np.uint32)
    starts = np.random.default_rng(0).integers(0, 6, size=(128, 6, 6))
    carry = board_shared.init_carry_batch(seeds, spec, device="cpu",
                                          initial_states=starts)
    board_shared.segment_state(carry)
    match = r"heights must lie in \[0, 6\)"
    for bad in (6, -1, 256):
        s = starts.copy()
        s[3, 2, 1] = bad
        with pytest.raises(ValueError, match=match):
            board_shared.init_carry_batch(seeds, spec, device="cpu",
                                          initial_states=s)
        h = carry.heights.clone()
        h[3, 13] = bad
        with pytest.raises(ValueError, match=match):
            board_shared.segment_state(dataclasses.replace(carry, heights=h))


def test_warm_start_bitwise(lib):
    """Random warm starts (heights anywhere in [0, N)) in all three modes."""
    spec = _spec(9, 400, 33)
    starts = np.random.default_rng(5).integers(0, 9, size=(200, 9, 9))
    carry = _carry(spec, 200, initial_states=starts)
    for mode in MODES:
        _emulated_equals_twin(lib, spec, carry, 2, mode)


# -- the packed walk's intrinsics, divider and edges -------------------------


def _words(seed):
    """Random words and words of edge bytes (0x00, 0x01, 0x7F, 0x80, 0xFF
    in every position)."""
    edge = np.array([0x00, 0x01, 0x7F, 0x80, 0xFF], np.uint64)
    b = np.stack(np.meshgrid(edge, edge, edge, edge), -1).reshape(-1, 4)
    grid = (b << np.array([0, 8, 16, 24], np.uint64)).sum(1).astype(np.uint32)
    rs = np.random.default_rng(seed)
    rand = rs.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    a = np.concatenate([np.repeat(grid, grid.size), rand])
    c = np.concatenate([np.tile(grid, grid.size), rs.permutation(rand)])
    return a, c


def _vabsdiffu4(a, b):
    out = 0
    for k in range(0, 32, 8):
        out |= abs((a >> k & 0xFF) - (b >> k & 0xFF)) << k
    return out


@pytest.mark.parametrize("op, model", [
    (0, _vabsdiffu4), (1, lambda a, b: a * b >> 32)],
    ids=["vabsdiffu4", "umulhi"])
def test_intrinsic_matches_bytewise_model(lib, op, model):
    """The emulation header's integer intrinsics the packed walk uses
    (``__vabsdiffu4``: each byte's unsigned |a - b|; ``__umulhi``: the high
    word of the 64-bit product) against a plain-Python model, over every
    pair of words of edge bytes and random words."""
    a, b = _words(op)
    out = np.empty_like(a)
    p = lambda x: x.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    lib.mcq_emu_intrinsic.restype = ctypes.c_int
    assert lib.mcq_emu_intrinsic(ctypes.c_int(op), p(a), p(b), p(out),
                                 ctypes.c_int64(a.size)) == 0
    want = [model(int(x), int(y)) for x, y in zip(a, b)]
    assert out.tolist() == want


@pytest.mark.parametrize("N", [2, 5, 9, 11, 12, 14, 16, 24, 32, 127, 128])
def test_exact_division_whole_range(lib, N):
    """The divisors of the kernels' draws (N^3, N^2, N and N - 1) at every
    N of the parity cases: the multiply-high quotient equals n // d for
    every n in [0, 2^31) (by residue class, ``emu/checks.cpp``)."""
    lib.mcq_emu_quot_mismatches.restype = ctypes.c_int64
    lib.mcq_emu_quot_mismatches.argtypes = [ctypes.c_uint32]
    for d in (N ** 3, N * N, N, N - 1):
        assert lib.mcq_emu_quot_mismatches(d) == 0, d


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("N", [5, 14, 24, 32])
def test_packed_edges(lib, N, lanes, mode):
    """Ragged last words (N=5: two words, one cell in the second; N=14),
    more words than lanes and one lane a chain (N=24, 32), each team size
    forced, with patience 9 so that chains stop inside a batch of draws:
    64 chains, two 24-step chunks from step 0."""
    spec = _spec(N, 2000, 24, early_stop_patience=9)
    cpb = max(32 // lanes, 16)
    forced = board_shared.Layout(lanes, cpb, board_shared.cta_smem_bytes(
        N, cpb, mode != "freeze"))
    end, _ = _emulated_equals_twin(lib, spec, _carry(spec, 64, seed0=N), 2,
                                   mode, forced)
    assert int((end.stop_step < spec.n_steps).sum()) > 0


def test_packed_by_rule_n24_n32(lib):
    """N=24 and N=32 at 512 chains, laid out by the rule (for ``N_SM``
    SMs), in all three modes."""
    for N in (24, 32):
        spec = _spec(N, 2000, 16)
        for mode in MODES:
            _emulated_equals_twin(lib, spec, _carry(spec, 512), 1, mode)
