"""A run whose timed path is broken underneath comes out not correct:
a sampler step that leaves the state as it was, half the batch left
unstepped, the exchange (and, sharded, its gather between cards) left
out, and one reported answer altered."""

import dataclasses

import pytest
import torch

from benchmark.tests import tiny


def _unchanged(real):
    def segment(carry, *args):
        # Both samplers' run_segment* take n_outer last.
        ys = carry.energy.reshape(1, -1).expand(args[-1], -1).contiguous()
        return carry, ys
    return segment


def _half(real):
    def segment(carry, *args, **kw):
        out, ys = real(carry, *args, **kw)
        C = carry.energy.shape[0]
        h = C // 2
        mixed = {f.name: torch.cat([getattr(out, f.name)[:h],
                                    getattr(carry, f.name)[h:]])
                 for f in dataclasses.fields(carry)
                 if getattr(carry, f.name) is not None
                 and getattr(carry, f.name).shape[0] == C}
        ys = ys.clone()
        ys[:, h:] = carry.energy.reshape(-1)[h:]
        return dataclasses.replace(out, **mixed), ys
    return segment


def _patch_segments(monkeypatch, wrap):
    from mcqueens_torch.kernels import board_shared, full3d_shared

    for mod in (board_shared, full3d_shared):
        for name in ("run_segment", "run_segment_tempered"):
            monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))


def _altered(monkeypatch):
    from mcqueens_torch.dist import runner
    from mcqueens_torch.search import tempering

    def alter(real):
        def call(*args, **kw):
            out = real(*args, **kw)
            final = (out["final_energy"] if isinstance(out, dict)
                     else out.final_energy)
            final[-1] += 1
            return out
        return call

    monkeypatch.setattr(runner, "run_experiment",
                        alter(runner.run_experiment))
    monkeypatch.setattr(tempering, "run_tempered",
                        alter(tempering.run_tempered))


def _no_exchange(monkeypatch):
    from mcqueens_torch.search import tempering

    monkeypatch.setattr(tempering, "exchange", lambda betas, *a, **k: betas)


def _no_gather(monkeypatch):
    from mcqueens_torch.dist import mesh

    real = mesh.gather_chains

    def gather(shards, device=None):
        if not isinstance(shards[0], torch.Tensor):
            return real(shards, device)
        # Only the first card's energies arrive; the others' stay zero.
        return real([shards[0]] + [torch.zeros_like(s) for s in shards[1:]],
                    device)

    monkeypatch.setattr(mesh, "gather_chains", gather)


FAULTS = {
    "unchanged": lambda mp: _patch_segments(mp, _unchanged),
    "half": lambda mp: _patch_segments(mp, _half),
    "altered": _altered,
    "exchange": _no_exchange,
    "gather": _no_gather,
}
CASES = [("tiny_board.anneal", f) for f in ("unchanged", "half", "altered")]
CASES += [(c, f) for c in ("tiny_board.tempered", "tiny_3d.floors")
          for f in ("unchanged", "half", "exchange", "altered")]
CASES += [("tiny_3d.floors_x4", f)
          for f in ("unchanged", "half", "gather", "altered")]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(root, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    out = tiny.run(root, cell)
    assert out["correct"] is False, out["checks"]
    assert out["failed"] >= 1


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_run_is_correct(root, cell):
    out = tiny.run(root, cell)
    assert out["correct"] is True, out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
