"""The one-pass drain (``mcqueens_torch.dist.runner.drain``) against the
assembly it replaced, kept here as a plain reference.

The reference reads every carry field with a synchronising ``.cpu()`` (a
mesh's shards joined by ``np.concatenate``), stacks the Pallas samplers'
planes and widens the boards on the host, and concatenates the energy
history from the rounds' ``ys`` (:func:`old_chain_result`,
:func:`old_tempered_result`).  Each case runs a search with the final carry,
the first energies and every ``ys`` recorded on the way, and holds every
result field to the reference in value, dtype and shape: ``run_chains`` for
the six samplers (board and full-3D x ``pallas_shared``, ``pallas``,
``tables``), ``run_tempered`` for the two shared-site ones, each on one
device and on CPU meshes of 2 and 4 shards, an early stop and a
checkpoint's kill and resume.  ``DRAIN_COPIES`` grows by the drained fields
times the shards.  Tolerance: none.

``test_card_drains_the_cells_shapes`` needs a card (marker ``cuda``): run
it there with ``python -m pytest tests/test_torch_drain.py -m cuda
--noconftest``.  This file imports no JAX.
"""

import contextlib

import numpy as np
import pytest
import torch

from mcqueens_torch.chain import board as board_chain
from mcqueens_torch.chain import full3d as full3d_chain
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core import schedules
from mcqueens_torch.dist import mesh as mesh_mod
from mcqueens_torch.dist import runner
from mcqueens_torch.kernels import (board_shared, full3d_pallas,
                                    full3d_shared, metropolis_pallas)
from mcqueens_torch.search import tempering
from mcqueens_torch.utils.checkpoint import Checkpointer

LIN = dict(sched_type="linear_annealing", beta_start=0.5, beta_end=3.0)
CONST = dict(sched_type="constant", beta_const=1.0)

# sampler -> (module whose segments the searches run, ChainSpec kwargs)
SAMPLERS = {
    "pallas_shared-board": (board_shared, dict(
        N=5, kernel="pallas_shared", mcmc_type="board",
        early_stop_patience=60)),
    "pallas_shared-full_3d": (full3d_shared, dict(
        N=4, Q=12, kernel="pallas_shared", mcmc_type="full_3d")),
    "pallas-board": (metropolis_pallas, dict(
        N=5, kernel="pallas", mcmc_type="board", early_stop_patience=60)),
    "pallas-full_3d": (full3d_pallas, dict(
        N=4, Q=12, kernel="pallas", mcmc_type="full_3d")),
    "tables-board": (board_chain, dict(
        N=5, kernel="tables", mcmc_type="board", early_stop_patience=60)),
    "tables-full_3d": (full3d_chain, dict(
        N=3, Q=8, kernel="tables", mcmc_type="full_3d")),
}
TEMPERED = ("pallas_shared-board", "pallas_shared-full_3d")
SEEDS = 11 + np.arange(6, dtype=np.uint32)   # padded on 4 shards
LADDER = tempering.geometric_ladder(0.5, 3.0, 4)


# --- the assembly the drain replaced ---------------------------------------

def old_field(state, name):
    if isinstance(state, tuple):
        return np.concatenate([getattr(c, name).cpu().numpy()
                               for c in state])
    return getattr(state, name).cpu().numpy()


def old_state_fields(spec):
    if spec.mcmc_type == "board":
        state = ("heights", "best_heights")
    elif spec.kernel in ("tables", "naive"):
        state = ("queens", "best_queens")
    else:
        state = ("qi", "qj", "qk", "best_qi", "best_qj", "best_qk")
    return ("energy", "best_energy", "best_step", "stop_step", "accept_bins",
            "total_bins") + state


def old_states_of(host, spec):
    if spec.mcmc_type == "board":
        return tuple(host[name].astype(np.int64).reshape(-1, spec.N, spec.N)
                     for name in ("best_heights", "heights"))
    if spec.kernel in ("tables", "naive"):
        return host["best_queens"], host["queens"]
    return (np.stack([host[f"best_q{a}"] for a in "ijk"], axis=-1),
            np.stack([host[f"q{a}"] for a in "ijk"], axis=-1))


def old_chain_result(spec, state, e0, chunks, n_runs) -> dict:
    """``run_chains``' result fields as the parent assembled them."""
    host = {name: old_field(state, name) for name in old_state_fields(spec)}
    n_outer = spec.n_outer
    hist = np.concatenate(chunks, axis=0)[:n_outer]
    energy_history = np.concatenate([e0[None, :], hist], axis=0).T
    history_steps = np.minimum(
        np.arange(n_outer + 1, dtype=np.int64) * spec.history_stride,
        spec.n_steps)
    stop_step = host["stop_step"].reshape(-1)
    stopped = stop_step < spec.n_steps
    pts = -(-stop_step // spec.history_stride)
    history_len = (np.where(stopped, pts, n_outer) + 1).astype(np.int64)
    best_state, final_state = old_states_of(host, spec)
    s = slice(0, n_runs)
    return dict(
        energy_history=energy_history[s], history_steps=history_steps,
        history_len=history_len[s],
        final_energy=host["energy"].reshape(-1)[s],
        final_state=final_state[s],
        best_energy=host["best_energy"].reshape(-1)[s],
        best_state=best_state[s],
        steps_to_best=host["best_step"].reshape(-1)[s],
        stop_step=stop_step[s], accept_bins=host["accept_bins"][s],
        total_bins=host["total_bins"][s])


def old_tempered_result(spec, state, e0, chunks, betas, n_runs) -> dict:
    """``run_tempered``'s drained fields as the parent assembled them."""
    host = {name: old_field(state, name) for name in old_state_fields(spec)}
    best_state, final_state = old_states_of(host, spec)
    s = slice(0, n_runs)
    return {
        "best_energy": host["best_energy"].reshape(-1)[s],
        "best_state": best_state[s],
        "final_energy": host["energy"].reshape(-1)[s],
        "final_state": final_state[s],
        "energy_history": np.concatenate([e0[None, :]] + chunks, axis=0).T[s],
        "proposals": int(host["total_bins"].sum()),
        "betas_history": np.stack(betas, axis=0)[:, :n_runs],
    }


@contextlib.contextmanager
def recorded(monkeypatch, mod, segment, tempered=False):
    """Record what the reference needs of a search: the first energies
    (``mod.init_carry_batch``), each round's ``ys`` and, ``tempered``,
    betas (``segment``, the function the search calls, as :func:`_segment`
    gives it) and the carry it drains."""
    rec = {"e0": None, "ys": [], "betas": [], "state": None, "copies": 0}
    owner, name = segment
    init, seg, drain = mod.init_carry_batch, getattr(owner, name), \
        runner.drain

    def init_rec(*args, **kw):
        carry = init(*args, **kw)
        rec["e0"] = carry.energy.reshape(-1).cpu().numpy().copy()
        return carry

    def seg_rec(*args):
        if tempered:
            rec["betas"].append(torch.as_tensor(
                args[1] if owner is mod else args[3]).cpu().numpy().copy())
        state, ys = seg(*args)
        rec["ys"].append(ys.cpu().numpy().copy())
        return state, ys

    def drain_rec(state, names, spec):
        rec["state"] = state
        before = runner.DRAIN_COPIES
        out = drain(state, names, spec)
        rec["copies"] = runner.DRAIN_COPIES - before
        return out

    monkeypatch.setattr(mod, "init_carry_batch", init_rec)
    monkeypatch.setattr(owner, name, seg_rec)
    monkeypatch.setattr(runner, "drain", drain_rec)
    try:
        yield rec
    finally:
        monkeypatch.setattr(mod, "init_carry_batch", init)
        monkeypatch.setattr(owner, name, seg)
        monkeypatch.setattr(runner, "drain", drain)


def _spec(sampler, n_steps=250, stride=50, sched=LIN):
    kw = dict(SAMPLERS[sampler][1])
    if sched is CONST:
        kw.pop("early_stop_patience", None)
    return ChainSpec(schedule=schedules.build_schedule(n_steps=n_steps,
                                                       **sched),
                     n_steps=n_steps, history_stride=stride,
                     init_mode="random", **kw)


def _mesh(shards):
    return None if shards == 1 else mesh_mod.mesh_for("cpu", shards)


def _segment(mod, name, shards):
    """The function a search calls for a segment, as ``(owner, name)``:
    ``mod.<name>``, or ``mesh.run_sharded`` on a mesh of several shards
    (the betas its fourth argument where the search is tempered)."""
    return (mod, name) if shards == 1 else (mesh_mod, "run_sharded")


def assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, int):
            assert type(g) is int and g == w, key
            continue
        assert (g.dtype, g.shape) == (w.dtype, w.shape), key
        np.testing.assert_array_equal(g, w, err_msg=key)


def chain_fields(result) -> dict:
    return {k: getattr(result, k) for k in (
        "energy_history", "history_steps", "history_len", "final_energy",
        "final_state", "best_energy", "best_state", "steps_to_best",
        "stop_step", "accept_bins", "total_bins")}


def tempered_fields(out) -> dict:
    return {k: out[k] for k in (
        "best_energy", "best_state", "final_energy", "final_state",
        "energy_history", "proposals", "betas_history")}


class Killed(Exception):
    pass


class KilledAfter(Checkpointer):
    """A checkpointer whose save raises after writing ``kill_at`` segments:
    a process killed right after its checkpoint."""

    def __init__(self, *args, kill_at, **kw):
        super().__init__(*args, **kw)
        self.kill_at = kill_at

    def save(self, carry, segments_done, chunks, **kw):
        super().save(carry, segments_done, chunks, **kw)
        if segments_done == self.kill_at:
            raise Killed()


# --- run_chains --------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_chain_drain_matches_the_old_assembly(sampler, shards, monkeypatch):
    """Five history chunks in two segments of three (the last row written
    past the horizon and cut), every field as the parent built it."""
    mod = SAMPLERS[sampler][0]
    spec = _spec(sampler)
    with recorded(monkeypatch, mod,
                  _segment(mod, "run_segment", shards)) as rec:
        got = runner.run_chains(SEEDS, spec, device="cpu",
                                mesh=_mesh(shards), min_segments=2)
    assert len(rec["ys"]) == 2
    want = old_chain_result(spec, rec["state"], rec["e0"], rec["ys"],
                            len(SEEDS))
    assert_same(chain_fields(got), want)
    assert rec["copies"] == len(runner.CHAIN_FIELDS) * shards


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_chain_drain_after_resume(sampler, shards, monkeypatch, tmp_path):
    """A run killed after 2 of 4 segments and resumed writes the restored
    chunks into their rows: the same result as the uninterrupted run's
    old assembly."""
    mod = SAMPLERS[sampler][0]
    spec = _spec(sampler, n_steps=200)
    mesh = _mesh(shards)
    with recorded(monkeypatch, mod,
                  _segment(mod, "run_segment", shards)) as rec:
        runner.run_chains(SEEDS, spec, device="cpu", mesh=mesh,
                          min_segments=4)
    want = old_chain_result(spec, rec["state"], rec["e0"], rec["ys"],
                            len(SEEDS))
    with pytest.raises(Killed):
        runner.run_chains(SEEDS, spec, device="cpu", mesh=mesh,
                          checkpointer=KilledAfter(str(tmp_path), kill_at=2,
                                                   min_segments=4))
    ck = Checkpointer(str(tmp_path), min_segments=4)
    with recorded(monkeypatch, mod,
                  _segment(mod, "run_segment", shards)) as rec:
        got = runner.run_chains(SEEDS, spec, device="cpu", mesh=mesh,
                                checkpointer=ck)
    assert len(rec["ys"]) == 2  # only segments 2 and 3 ran
    assert_same(chain_fields(got), want)


# --- run_tempered ------------------------------------------------------------

def _tempered(sampler, shards, **kw):
    return tempering.run_tempered(
        np.arange(8, dtype=np.uint32), _spec(sampler, n_steps=200,
                                             sched=CONST),
        LADDER, device="cpu", swap_seed=3, mesh=_mesh(shards),
        record_betas=True, **kw)


@pytest.mark.parametrize("stop", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("sampler", TEMPERED)
def test_tempered_drain_matches_the_old_assembly(sampler, shards, stop,
                                                 monkeypatch):
    """Four rounds, or one where ``stop_at_energy`` ends the search after
    its first round, every drained field and the beta history as the
    parent built them."""
    mod = SAMPLERS[sampler][0]
    spec = _spec(sampler, n_steps=200, sched=CONST)
    segment = _segment(mod, "run_segment_tempered", shards)
    with recorded(monkeypatch, mod, segment, tempered=True) as rec:
        got = _tempered(sampler, shards,
                        stop_at_energy=10 ** 6 if stop else None)
    assert len(rec["ys"]) == (1 if stop else 4)
    want = old_tempered_result(spec, rec["state"], rec["e0"], rec["ys"],
                               rec["betas"], 8)
    assert_same(tempered_fields(got), want)
    assert rec["copies"] == len(tempering.RESULT_FIELDS) * shards


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("sampler", TEMPERED)
def test_tempered_drain_after_resume(sampler, shards, monkeypatch, tmp_path):
    """A search killed in its third round resumes: the restored chunks and
    betas fill their rows, and the result is the uninterrupted search's
    old assembly."""
    mod = SAMPLERS[sampler][0]
    spec = _spec(sampler, n_steps=200, sched=CONST)
    segment = _segment(mod, "run_segment_tempered", shards)
    with recorded(monkeypatch, mod, segment, tempered=True) as rec:
        _tempered(sampler, shards)
    want = old_tempered_result(spec, rec["state"], rec["e0"], rec["ys"],
                               rec["betas"], 8)
    real, calls = getattr(*segment), []

    def dying(*args):
        if len(calls) == 2:
            raise Killed()
        calls.append(args[2])
        return real(*args)

    ck = Checkpointer(str(tmp_path), tag="pt")
    monkeypatch.setattr(*segment, dying)
    with pytest.raises(Killed):
        _tempered(sampler, shards, checkpointer=ck)
    monkeypatch.setattr(*segment, real)
    with recorded(monkeypatch, mod, segment, tempered=True) as rec:
        got = _tempered(sampler, shards, checkpointer=ck)
    assert len(rec["ys"]) == 2  # rounds 2 and 3
    assert_same(tempered_fields(got), want)


# --- pieces ----------------------------------------------------------------

def test_history_rows_fill_and_view():
    rows = np.zeros((6, 3), np.int32)
    chunks = [np.full((1, 3), 1, np.int32), np.full((2, 3), 2, np.int32)]
    views = runner.history_rows(rows, chunks, 1)
    assert [v.shape for v in views] == [(1, 3), (2, 3)]
    np.testing.assert_array_equal(rows[:, 0], [0, 1, 2, 2, 0, 0])
    views[1][0, 0] = 7  # a view, not a copy
    assert rows[2, 0] == 7


def test_cpu_host_arrays_are_plain_memory():
    t = runner.host_empty((3, 2), torch.int64, torch.device("cpu"))
    assert (t.shape, t.dtype, t.device.type) == ((3, 2), torch.int64, "cpu")
    assert not t.is_pinned()


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["floors", "floors_2_shards", "anneal",
                                  "tempered_board"])
def test_card_drains_the_cells_shapes(case, monkeypatch):
    """Five searches at each benchmark cell's widths, cut to 4096 chains and
    two 1024-step launches, on one card: the floors protocol (N=15, Q=225,
    a 16-level ladder 0.8 -> 7), also over two shards of the card; the
    board anneal (N=16, linear beta 1 -> 5) and its tempered search.  Every
    drained field bitwise the old assembly's, one take a field and shard,
    and the pinned host memory no larger after the fifth search than after
    the second (a dropped result's blocks serve the next)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    board = case in ("anneal", "tempered_board")
    shards = 2 if case == "floors_2_shards" else 1
    mesh = mesh_mod.make_mesh(["cuda:0"] * 2) if shards > 1 else None
    sched = (dict(sched_type="linear_annealing", beta_start=1.0,
                  beta_end=5.0) if case == "anneal" else CONST)
    spec = ChainSpec(n_steps=2048, history_stride=1024,
                     schedule=schedules.build_schedule(n_steps=2048, **sched),
                     init_mode="random", kernel="pallas_shared",
                     **(dict(N=16, mcmc_type="board") if board else
                        dict(N=15, Q=225, mcmc_type="full_3d")))
    mod = board_shared if board else full3d_shared
    ladder = tempering.geometric_ladder(*((1.0, 5.0) if board
                                          else (0.8, 7.0)), 16)
    stats = getattr(torch.cuda, "host_memory_stats", None)
    pinned = []
    for i in range(5):
        seeds = 4096 * i + np.arange(4096, dtype=np.uint32)
        if case == "anneal":
            with recorded(monkeypatch, mod, (mod, "run_segment")) as rec:
                got = chain_fields(runner.run_chains(seeds, spec,
                                                     device="cuda"))
            want = old_chain_result(spec, rec["state"], rec["e0"],
                                    rec["ys"], 4096)
            fields = runner.CHAIN_FIELDS
        else:
            segment = _segment(mod, "run_segment_tempered", shards)
            with recorded(monkeypatch, mod, segment, tempered=True) as rec:
                got = tempered_fields(tempering.run_tempered(
                    seeds, spec, ladder, device="cuda", swap_seed=i,
                    mesh=mesh, record_betas=True))
            want = old_tempered_result(spec, rec["state"], rec["e0"],
                                       rec["ys"], rec["betas"], 4096)
            fields = tempering.RESULT_FIELDS
        assert got["final_state"].shape == ((4096, 16, 16) if board
                                            else (4096, 225, 3))
        assert_same(got, want)
        assert rec["copies"] == len(fields) * shards
        del got, want, rec
        if stats is not None:
            s = stats()
            pinned.append(s.get("allocated_bytes.current",
                                s.get("reserved_bytes.current")))
    if stats is not None and pinned[1] is not None:
        assert pinned[4] <= pinned[1], pinned
