"""The warp-per-chain scan kernels, run as host C++, against their twins.

``kernels/csrc/board_scan.cu`` and ``full3d_scan.cu`` are CUDA only; on a
machine without a card :mod:`mcqueens_torch.kernels.host_emulation` builds
them with g++ against ``kernels/emu/cuda_runtime.h`` (a fiber per CUDA
thread, the warp intrinsics over barriers) and the chain modules'
``launch_segment`` runs them on CPU tensors, through the same argument
checks and layout rule as a launch on the card.  Each case of
``tests/test_torch_chain.py`` (``BOARD_CASES``, ``FULL3D_CASES``) runs
segment by segment through the emulated kernel and through the plain-torch
twin from one state; every state field and every ``ys`` row must be equal
(tolerance none).  The kernel runs four times, in both modes (``tables``
and ``naive`` walk the same trajectory, so one ``tables`` twin serves
both), each laid out for a card of 2 SMs (7 chains, so blocks of 4 warps
and a last block of 3, state in shared memory) and with a block's shared
memory too small for a chain's slot, so that the layout rule picks the
device-memory instance.  Skips only when g++ is absent.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mcqueens_torch.chain import board, full3d
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import rng, schedules
from mcqueens_torch.core.schedules import chunk_betas
from mcqueens_torch.kernels import _build, host_emulation
from tests.test_torch_chain import BOARD_CASES, FULL3D_CASES, _warm

SEEDS = 3 + np.arange(7, dtype=np.uint32)
N_SM = 2


@pytest.fixture(scope="module")
def lib():
    if host_emulation.compiler() is None:
        pytest.skip("no g++ to build the host emulation of the kernels")
    return host_emulation.load()


def _spec(case_kw, sched, **over):
    kw = {"init_mode": "random", **case_kw, **over}
    return ChainSpec(schedule=schedules.build_schedule(
        n_steps=kw["n_steps"], **sched), **kw)


def _emulated_equals_twin(lib, mod, spec, starts, segments, monkeypatch):
    """Run ``segments`` (n_outer of each, or the whole run) through the
    ``tables`` twin and through the emulated kernel in both modes and both
    layouts; returns the twin's state.  Both modes walk the same trajectory,
    so one twin serves both (the naive state has no table)."""
    keys = rng.chain_keys_from_seeds(SEEDS)
    carry = mod.init_carry_batch(keys, spec, starts, device="cpu")
    twin = mod.segment_state(carry)
    runs = []
    for kern in ("tables", "naive"):
        sp = dataclasses.replace(spec, kernel=kern)
        c = mod.init_carry_batch(keys, sp, starts, device="cpu")
        for smem in (_build.SMEM_PER_BLOCK, 0):
            runs.append((sp, smem, mod.segment_state(c)))
    stride, start = spec.history_stride, 0
    for n_outer in segments or (spec.n_outer,):
        beta = chunk_betas(spec.schedule, start * stride, n_outer * stride,
                           "cpu")
        want = torch.zeros((n_outer, len(SEEDS)), dtype=torch.int32)
        mod.segment_reference(twin, want, start, n_outer, spec, beta)
        for sp, smem, st in runs:
            monkeypatch.setattr(_build, "SMEM_PER_BLOCK", smem)
            layout = (board.scan_layout(sp.N, sp.kernel, len(SEEDS), N_SM)
                      if mod is board else
                      full3d.scan_layout(sp.N, sp.q_eff, sp.kernel,
                                         len(SEEDS), N_SM))
            assert layout.in_shared == (smem > 0)
            ys = torch.zeros_like(want)
            mod.launch_segment(lib, st, ys, start, n_outer, sp, beta, N_SM)
            where = (f"{sp.kernel}, {'shared' if smem else 'device'} "
                     f"memory, chunk {start}")
            for field, got in vars(st).items():
                w = getattr(twin, field)
                if sp.kernel == "naive" and field == "table":
                    assert got is None
                    continue
                assert torch.equal(got, w), f"{field} ({where})"
            assert torch.equal(ys, want), f"ys ({where})"
        start += n_outer
    return twin


@pytest.mark.parametrize("case", sorted(FULL3D_CASES))
def test_full3d_scan_emulated(lib, case, monkeypatch):
    case_kw, sched, warm, *segments = FULL3D_CASES[case]
    spec = _spec(case_kw, sched, kernel="tables", mcmc_type="full_3d")
    starts = _warm(spec, 2, len(SEEDS)) if warm else None
    end = _emulated_equals_twin(lib, full3d, spec, starts,
                                segments[0] if segments else None,
                                monkeypatch)
    assert int(end.total_bins.sum()) > 0


@pytest.mark.parametrize("case", sorted(BOARD_CASES))
def test_board_scan_emulated(lib, case, monkeypatch):
    case_kw, sched, warm, *segments = BOARD_CASES[case]
    spec = _spec(case_kw, sched, kernel="tables")
    starts = _warm(spec, 1, len(SEEDS)) if warm else None
    end = _emulated_equals_twin(lib, board, spec, starts,
                                segments[0] if segments else None,
                                monkeypatch)
    assert int(end.total_bins.sum()) > 0
