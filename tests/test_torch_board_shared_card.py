"""The shared-site board kernel on the card, against its twin.

Every test needs an NVIDIA card (marker ``cuda``) and skips without one.
On the card, run the file with::

    python -m pytest tests/test_torch_board_shared_card.py -m cuda --noconftest

(the conftest imports JAX, which the card's machine lacks; this file
imports none).  Each case runs chunk by chunk through the CUDA kernel
(``segment_cuda``, laid out by the rule or forced) and through the
plain-torch twin (``segment_reference``) on the card from one state; all 11
state fields must be equal after every chunk (tolerance none), in the main,
tempered and freeze modes.  The same checks run on the CPU against the
host emulation in ``tests/test_torch_shared_emulation.py``.
"""

import numpy as np
import pytest
import torch

from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import schedules
from mcqueens_torch.core.schedules import chunk_betas
from mcqueens_torch.dist import runner
from mcqueens_torch.kernels import board_shared
from mcqueens_torch.search import tempering

MODES = ("main", "tempered", "freeze")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _spec(N, n_steps, stride, **kw):
    return ChainSpec(N=N, n_steps=n_steps, history_stride=stride,
                     kernel="pallas_shared", schedule=schedules.build_schedule(
                         "linear_annealing", n_steps, beta_start=1.0,
                         beta_end=5.0), **kw)


def _mode_args(mode, C, lo, hi, dev):
    """(beta_scale, freeze, track_best) of a mode for C chains: a 16-rung
    ladder, or horizons at 0 for half the chains and in [lo, hi) for the
    rest."""
    if mode == "tempered":
        ladder = tempering.geometric_ladder(1.0, 3.0, 16)
        return (torch.from_numpy(np.tile(ladder, -(-C // 16))[:C].copy())
                .to(dev), None, True)
    if mode == "freeze":
        freeze = np.random.default_rng(C).integers(lo, hi, C).astype(np.int32)
        freeze[::2] = 0
        return None, torch.from_numpy(freeze).to(dev), False
    return None, None, True


def _card_equals_twin(spec, n_chains, chunks, mode, dev, start_outer=0,
                      forced=None):
    carry = board_shared.init_carry_batch(
        np.arange(n_chains, dtype=np.uint32), spec, device=dev)
    if start_outer:
        carry, _ = board_shared.run_segment(carry, 0, spec, start_outer)
    twin = board_shared.segment_state(carry)
    kern = board_shared.segment_state(carry)
    C, stride = twin.energy.shape[0], spec.history_stride
    scale, freeze, track = _mode_args(
        mode, C, start_outer * stride,
        (start_outer + chunks) * stride + stride // 2, dev)
    packed = board_shared.PACKED_LAUNCHES
    for o in range(start_outer, start_outer + chunks):
        beta = chunk_betas(spec.schedule, o * stride, stride, dev)
        board_shared.segment_reference(twin, o * stride, stride, spec, beta,
                                       scale, freeze=freeze,
                                       track_best=track)
        board_shared.segment_cuda(kern, o * stride, stride, spec, beta, scale,
                                  freeze=freeze, track_best=track,
                                  forced=forced)
        torch.cuda.synchronize()
        for field, want in vars(twin).items():
            got = getattr(kern, field)
            assert torch.equal(got, want), (
                f"{field} differs in {int((got != want).sum())} entries "
                f"(chunk {o}, {mode})")
    assert board_shared.PACKED_LAUNCHES - packed == chunks
    return twin


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("N, chains", [(16, 32768), (16, 4096), (14, 4096),
                                       (32, 4096)])
def test_card_kernel_equals_twin(card, N, chains, mode):
    """Two 48-step chunks from step 0 and one from step 960 (colder, fewer
    moves accepted), by the layout rule: the anneal cell's width (N=16,
    32768 chains), 4096 chains, a ragged last word (N=14) and one lane a
    chain (N=32)."""
    spec = _spec(N, 2000, 48)
    end = _card_equals_twin(spec, chains, 2, mode, card)
    assert int((end.best_step > 0).sum()) > chains // 4
    _card_equals_twin(spec, chains, 1, mode, card, start_outer=20)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_card_every_team_size(card, lanes, mode):
    """Each team size forced at N=16, 4096 chains, CTAs of max(32 / L, 16)
    chains, and at N=5 (two words a row, the second ragged)."""
    for N in (16, 5):
        cpb = max(32 // lanes, 16)
        forced = board_shared.Layout(lanes, cpb, board_shared.cta_smem_bytes(
            N, cpb, mode != "freeze"))
        _card_equals_twin(_spec(N, 2000, 48), 4096, 2, mode, card,
                          forced=forced)


@pytest.mark.cuda
def test_card_searches_take_the_packed_instance(card):
    """A board search and a tempered search at the benchmark's widths, cut
    to 4096 chains and two 1024-step launches: every launch of the kernel
    kept its boards packed in shared memory."""
    spec = _spec(16, 2048, 1024)
    seeds = np.arange(4096, dtype=np.uint32)
    for search in (
            lambda: runner.run_chains(seeds, spec, device="cuda"),
            lambda: tempering.run_tempered(
                seeds, spec, tempering.geometric_ladder(1.0, 5.0, 16),
                device="cuda")):
        launches = board_shared.KERNEL_LAUNCHES
        packed = board_shared.PACKED_LAUNCHES
        search()
        assert board_shared.KERNEL_LAUNCHES - launches == 2
        assert board_shared.PACKED_LAUNCHES - packed == 2
