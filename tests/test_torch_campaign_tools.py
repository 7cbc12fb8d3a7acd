"""The port's campaign tools and their guards (CPU).

Mirrors ``tests/test_qmax_tools.py`` against ``mcqueens_torch.tools``: the
descent, gallop and bisect of the frontier, the warm walk and two-seed
confirmation of the campaign, the push's checkpoint and edge records and
the floors campaign's refinements, with the searches faked out as there.
Besides: the port's ``verify_board`` oracle equals ``tests/_oracle.py`` and
the JAX tool on random boards and committed certificates; the output guard
refuses every path under the TPU's ``artifacts/`` outside
``artifacts/h100/``; a push and a floors campaign run for real on the CPU
(the kernels' plain twins, tiny widths) write only under their root;
``schedules_fig`` draws its figure; the options not ported yet still raise.
"""

import contextlib
import io
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import yaml

from mcqueens_torch import tools
from mcqueens_torch.cli import competition
from mcqueens_torch.cli import experiments as exp_cli
from mcqueens_torch.tools import (full3d_floors_campaign, qmax, qmax_campaign,
                                  qmax_frontier, qmax_push, verify_board)
from mcqueens_torch.utils.checkpoint import Checkpointer
from tests import _oracle

REPO = Path(tools.REPO)
CERTIFICATES = ("qmax_N8_Q48.txt", "qmax_N15_Q182.txt", "qmax_N20_Q279.txt",
                "qmax_N22_Q332.txt", "qmax_N24_Q402.txt")


def test_campaign_rejects_klarner_closed_sizes():
    for n in (11, 13, 17, 19):
        assert math.gcd(n, 210) == 1
        with pytest.raises(SystemExit):
            qmax_campaign.main(["--n", str(n)])
        with pytest.raises(SystemExit):
            qmax_frontier.main(["--n", str(n)])


def _wire(tmp_path, monkeypatch, edge_by_seed):
    """Fake the two card tools around a shared frontier JSON.

    ``edge_by_seed[seed]`` = highest Q that seed's warm push can certify;
    pushes walk up from --start and record a miss one past their edge,
    exactly like ``qmax_push.main``.
    """
    outdir = str(tmp_path)
    monkeypatch.setattr(qmax_campaign, "OUTDIR", outdir)
    calls = []

    def path(n):
        return os.path.join(outdir, f"qmax_frontier_N{n}.json")

    def fake_frontier(argv):
        n = int(argv[argv.index("--n") + 1])
        calls.append(("frontier", n))
        with open(path(n), "w") as f:
            json.dump({"lower_bound": 10}, f)

    def fake_push(argv):
        n = int(argv[argv.index("--n") + 1])
        start = int(argv[argv.index("--start") + 1])
        seed = int(argv[argv.index("--seed") + 1])
        assert "--warm-start" in argv
        calls.append(("push", start, seed))
        with open(path(n)) as f:
            out = json.load(f)
        q = start
        while q <= edge_by_seed[seed]:
            out["lower_bound"] = max(out.get("lower_bound") or 0, q)
            edge = out.get("edge")
            if edge is not None and q >= edge["q"]:
                out.setdefault("edge_history", []).append(edge)
                del out["edge"]
            out.pop("complete", None)
            q += 1
        # full-budget warm miss at q, recorded like qmax_push.main
        key = f"Q{q}_push_warm"
        if key in out and out[key].get("seed", 31337) != seed:
            key = f"{key}_s{seed}"
        out[key] = {"min_energy": 1, "wall_s": 1.0,
                    "proposals": qmax_campaign.FULL_BUDGET,
                    "protocol": "tempered_push_warm", "seed": seed}
        with open(path(n), "w") as f:
            json.dump(out, f)

    monkeypatch.setattr(qmax_campaign.qmax_frontier, "main", fake_frontier)
    monkeypatch.setattr(qmax_campaign.qmax_push, "main", fake_push)
    return calls, path


def test_campaign_walk_and_two_seed_confirmation(tmp_path, monkeypatch):
    calls, path = _wire(tmp_path, monkeypatch,
                        edge_by_seed={31337: 12, 4242: 13})
    qmax_campaign.main(["--n", "12", "--seed", "31337",
                        "--confirm-seed", "4242"])
    assert calls == [
        ("frontier", 12),
        ("push", 11, 31337),   # walk from probes' bound+1 -> certifies 12
        ("push", 13, 4242),    # confirm attacks the miss -> breaks it (13)
        ("push", 14, 31337),   # primary walk resumes -> misses at 14
        ("push", 14, 4242),    # confirm re-attacks -> miss holds: done
    ]
    with open(path(12)) as f:
        out = json.load(f)
    assert out["lower_bound"] == 13
    assert out["edge"] == {"q": 14, "seeds": [4242, 31337],
                           "budget_proposals": qmax_campaign.FULL_BUDGET}
    assert "complete" not in out


def test_campaign_without_confirm_stops_at_first_miss(tmp_path, monkeypatch):
    calls, path = _wire(tmp_path, monkeypatch, edge_by_seed={31337: 12})
    qmax_campaign.main(["--n", "12", "--seed", "31337"])
    assert calls == [("frontier", 12), ("push", 11, 31337)]
    with open(path(12)) as f:
        out = json.load(f)
    assert out["lower_bound"] == 12
    assert out["edge"] == {"q": 13, "seeds": [31337],
                           "budget_proposals": qmax_campaign.FULL_BUDGET}
    assert "complete" not in out


def test_campaign_forwards_probe_budget(tmp_path, monkeypatch):
    calls, path = _wire(tmp_path, monkeypatch, edge_by_seed={31337: 12})
    seen = []

    def budget_frontier(argv):
        seen.append(argv)
        n = int(argv[argv.index("--n") + 1])
        with open(path(n), "w") as f:
            json.dump({"lower_bound": 10}, f)

    monkeypatch.setattr(qmax_campaign.qmax_frontier, "main", budget_frontier)
    qmax_campaign.main(["--n", "12", "--budget-s", "900"])
    assert seen == [["--n", "12", "--budget-s", "900.0"]]
    # --device reaches both tools when it is not the default
    seen.clear()
    pushes = []
    monkeypatch.setattr(qmax_campaign.qmax_push, "main",
                        lambda argv: pushes.append(argv))
    qmax_campaign.main(["--n", "12", "--device", "cpu"])
    assert seen[0][-2:] == ["--device", "cpu"]
    assert pushes[0][-2:] == ["--device", "cpu"]


def test_campaign_skip_probes_reuses_bound(tmp_path, monkeypatch):
    calls, path = _wire(tmp_path, monkeypatch, edge_by_seed={31337: 12})
    with open(path(12), "w") as f:
        json.dump({"lower_bound": 11}, f)
    qmax_campaign.main(["--n", "12", "--skip-probes"])
    assert calls == [("push", 12, 31337)]


def test_campaign_forwards_checkpoint_dir(tmp_path, monkeypatch):
    # Default on: every push gets OUTDIR/.ckpt so a killed push resumes
    # mid-search; '' disables the forwarding entirely.
    calls, path = _wire(tmp_path, monkeypatch, edge_by_seed={31337: 12})
    argvs = []
    real_push = qmax_campaign.qmax_push.main

    def spy_push(argv):
        argvs.append(list(argv))
        real_push(argv)

    monkeypatch.setattr(qmax_campaign.qmax_push, "main", spy_push)
    qmax_campaign.main(["--n", "12", "--seed", "31337"])
    expected = os.path.join(str(tmp_path), ".ckpt")
    for argv in argvs:
        assert argv[argv.index("--checkpoint-dir") + 1] == expected

    argvs.clear()
    qmax_campaign.main(["--n", "12", "--seed", "31337",
                        "--checkpoint-dir", ""])
    assert argvs and all("--checkpoint-dir" not in a for a in argvs)


def test_push_checkpoints_and_clears_on_success(tmp_path, monkeypatch):
    # push() hands run_tempered a Checkpointer rooted at checkpoint_dir
    # (tagged by N/Q/seed/protocol so campaigns never cross-restore) and
    # clears it once the push completes.
    seen = {}

    def fake_run_tempered(seeds, spec, ladder, **kw):
        ck = kw["checkpointer"]
        seen["ckpt"], seen["device"] = ck, kw["device"]
        ck._last_save_t = None
        with open(ck.chunk_path(0, "fp"), "wb") as f:
            np.save(f, np.zeros(1))
        with open(ck.path, "wb") as f:
            f.write(b"x")
        return {"best_energy": np.asarray([3]),
                "best_state": np.zeros((1, 5, 3), np.int64),
                "proposals": 7}

    monkeypatch.setattr(qmax_push.tempering_mod, "run_tempered",
                        fake_run_tempered)
    monkeypatch.setattr(qmax_push, "oracle_energy", lambda a: 3)
    e, best, wall, proposals = qmax_push.push(
        6, 5, seed=9, warm=False, checkpoint_dir=str(tmp_path),
        device="cpu")
    ck = seen["ckpt"]
    assert isinstance(ck, Checkpointer)
    assert ck.directory == str(tmp_path)
    assert ck.tag == "push_N6_Q5_s9"
    assert ck.min_interval_s == 300.0
    assert seen["device"] == "cpu"
    assert not os.path.exists(ck.path)
    assert not os.path.exists(ck.chunk_path(0, "fp"))

    def no_ckpt_run(seeds, spec, ladder, **kw):
        assert kw["checkpointer"] is None
        return {"best_energy": np.asarray([3]),
                "best_state": np.zeros((1, 5, 3), np.int64),
                "proposals": 7}

    monkeypatch.setattr(qmax_push.tempering_mod, "run_tempered", no_ckpt_run)
    qmax_push.push(6, 5, seed=9, warm=False, checkpoint_dir=None)


def test_campaign_errors_when_probes_find_nothing(tmp_path, monkeypatch):
    calls, path = _wire(tmp_path, monkeypatch, edge_by_seed={})

    def no_cert(argv):
        n = int(argv[argv.index("--n") + 1])
        with open(path(n), "w") as f:
            json.dump({"lower_bound": None}, f)

    monkeypatch.setattr(qmax_campaign.qmax_frontier, "main", no_cert)
    with pytest.raises(SystemExit):
        qmax_campaign.main(["--n", "12"])


class _FakeClock:
    """time.time() stand-in advancing a fixed step per call."""

    def __init__(self, step):
        self.now, self.step = 0.0, step

    def time(self):
        t = self.now
        self.now += self.step
        return t


def _wire_frontier(tmp_path, monkeypatch, energy_by_q, clock_step=0.0):
    """Fake the card search under qmax_frontier's real orchestration.

    Returns (probed, banked): ``banked[i]`` is the frontier JSON as it sat
    on disk when probe ``i`` started.
    """
    monkeypatch.setattr(qmax_frontier, "OUTDIR", str(tmp_path))
    monkeypatch.setattr(qmax_frontier, "oracle_energy", lambda a: 0)
    monkeypatch.setattr(qmax_frontier, "time", _FakeClock(clock_step))
    probed, banked = [], []
    json_path = os.path.join(str(tmp_path), "qmax_frontier_N12.json")

    def fake_search(N, Q, n_steps, beta_end, seed=0, **kw):
        if os.path.exists(json_path):
            with open(json_path) as f:
                banked.append(json.load(f))
        else:
            banked.append(None)
        probed.append(Q)
        board = np.zeros((Q, 3), np.int32)
        return energy_by_q[Q], board, 1.0, 4096 * n_steps

    monkeypatch.setattr(qmax_frontier, "search", fake_search)
    return probed, banked


def _frontier(tmp_path):
    with open(os.path.join(str(tmp_path), "qmax_frontier_N12.json")) as f:
        return json.load(f)


def test_frontier_budget_stops_walk_and_flushes(tmp_path, monkeypatch):
    energy = {10: 0, 11: 0, 12: 0, 13: 0, 14: 4}
    probed, banked = _wire_frontier(tmp_path, monkeypatch, energy,
                                    clock_step=30.0)
    qmax_frontier.main(["--n", "12", "--start", "10", "--budget-s", "100"])
    out = _frontier(tmp_path)
    assert out["probes_complete"] is False
    assert out["lower_bound"] == max(q for q in probed if energy[q] == 0)
    assert 14 not in probed  # the edge probe never started
    for i, q in enumerate(probed[1:], start=1):
        assert banked[i] is not None
        for prev in probed[:i]:
            assert f"Q{prev}" in banked[i]


def test_frontier_unbudgeted_walks_to_the_edge(tmp_path, monkeypatch):
    energy = {10: 4, 8: 0, 9: 0}  # descent 10 -> miss e=4 -> 8, walk up to 9
    probed, banked = _wire_frontier(tmp_path, monkeypatch, energy)
    qmax_frontier.main(["--n", "12", "--start", "10"])
    out = _frontier(tmp_path)
    assert probed == [10, 10, 8, 9]  # the miss at 10 escalates (2nd search)
    assert out["probes_complete"] is True
    assert out["lower_bound"] == 9
    assert out["Q10"]["min_energy"] == 4
    # the certificate of the descent is banked before the walk starts
    assert banked[3]["lower_bound"] == 8
    assert (tmp_path / "qmax_N12_Q9.txt").exists()


def test_frontier_resumes_from_banked_json(tmp_path, monkeypatch):
    banked = {
        "Q10": {"min_energy": 4, "proposals": 1, "wall_s": 1.0},
        "Q8": {"min_energy": 0, "proposals": 1, "wall_s": 1.0,
               "board": "qmax_N12_Q8.txt"},
        "lower_bound": 8, "complete": False,  # legacy conflated flag
    }
    with open(os.path.join(str(tmp_path), "qmax_frontier_N12.json"),
              "w") as f:
        json.dump(banked, f)
    probed, _ = _wire_frontier(tmp_path, monkeypatch, {9: 0})
    qmax_frontier.main(["--n", "12", "--start", "10"])
    assert probed == [9]  # banked 10 and 8 never re-searched
    out = _frontier(tmp_path)
    assert out["lower_bound"] == 9 and out["probes_complete"] is True
    assert "complete" not in out
    assert out["Q10"]["min_energy"] == 4


def test_frontier_resume_never_lowers_a_pushed_bound(tmp_path, monkeypatch):
    banked = {
        "Q8": {"min_energy": 0, "proposals": 1, "wall_s": 1.0},
        "Q12_push_warm": {"min_energy": 0, "proposals": 1, "wall_s": 1.0,
                          "protocol": "tempered_push_warm", "seed": 31337},
        "lower_bound": 12, "edge": {"q": 13, "seeds": [31337],
                                    "budget_proposals": 524288000000},
    }
    with open(os.path.join(str(tmp_path), "qmax_frontier_N12.json"),
              "w") as f:
        json.dump(banked, f)
    probed, _ = _wire_frontier(tmp_path, monkeypatch, {9: 2})
    qmax_frontier.main(["--n", "12", "--start", "8"])
    assert probed == [9, 9]  # one real (escalated) cold probe at the edge
    out = _frontier(tmp_path)
    assert out["lower_bound"] == 12
    assert "Q12_push_warm" in out
    assert out["edge"] == banked["edge"]


def test_frontier_walkup_gallops_and_bisects_wide_gaps(tmp_path, monkeypatch):
    energy = {30: 20, 20: 0, 21: 0, 23: 0, 27: 0, 28: 2}
    probed, _ = _wire_frontier(tmp_path, monkeypatch, energy)
    qmax_frontier.main(["--n", "12", "--start", "30"])
    out = _frontier(tmp_path)
    assert probed == [30, 30, 20, 21, 23, 27, 28, 28]
    for skipped in (22, 24, 25, 26, 29):
        assert skipped not in probed
    assert out["probes_complete"] is True
    assert out["lower_bound"] == 27
    assert out["Q28"]["min_energy"] == 2


def test_push_past_closed_edge_reopens_it(tmp_path, monkeypatch):
    monkeypatch.setattr(qmax_push, "OUTDIR", str(tmp_path))
    json_path = os.path.join(str(tmp_path), "qmax_frontier_N12.json")
    with open(json_path, "w") as f:
        json.dump({"lower_bound": 12, "complete": True,
                   "edge": {"q": 13, "seeds": [31337],
                            "budget_proposals": 524288000000}}, f)
    edge_q = 14  # certs at 13, 14; miss at 15

    def fake_push(N, Q, seed, warm, checkpoint_dir=None, **kw):
        e = 0 if Q <= edge_q else 1
        return e, np.zeros((Q, 3), np.int64), 1.0, qmax_campaign.FULL_BUDGET

    monkeypatch.setattr(qmax_push, "push", fake_push)
    qmax_push.main(["--n", "12", "--start", "13", "--seed", "777",
                    "--warm-start"])
    with open(json_path) as f:
        out = json.load(f)
    assert out["lower_bound"] == 14
    assert "edge" not in out
    assert "complete" not in out
    assert out["edge_history"][0]["q"] == 13
    assert qmax_campaign.derive_edge(out, 14) == {
        "q": 15, "seeds": [777],
        "budget_proposals": qmax_campaign.FULL_BUDGET}


def test_campaign_stays_open_without_full_budget_miss(tmp_path, monkeypatch):
    calls, path = _wire(tmp_path, monkeypatch, edge_by_seed={31337: 12})

    def truncated_push(argv):
        n = int(argv[argv.index("--n") + 1])
        with open(path(n)) as f:
            out = json.load(f)
        out["lower_bound"] = 12
        out["Q13_push_warm"] = {
            "min_energy": 1, "proposals": qmax_campaign.FULL_BUDGET // 2,
            "protocol": "tempered_push_warm", "seed": 31337}
        with open(path(n), "w") as f:
            json.dump(out, f)

    monkeypatch.setattr(qmax_campaign.qmax_push, "main", truncated_push)
    qmax_campaign.main(["--n", "12", "--seed", "31337"])
    with open(path(12)) as f:
        out = json.load(f)
    assert "edge" not in out and "complete" not in out


def test_derive_edge_filters_non_evidence():
    full = qmax_campaign.FULL_BUDGET
    assert full == 65536 * 8_000_000
    out = {
        "lower_bound": 12,
        "Q13_push_warm": {"min_energy": 1, "proposals": full,
                          "protocol": "tempered_push_warm", "seed": 31337},
        "Q13_push_warm_s4242": {"min_energy": 1, "proposals": full,
                                "protocol": "tempered_push_warm",
                                "seed": 4242},
        "Q13_push": {"min_energy": 2, "proposals": full,
                     "protocol": "tempered_push", "seed": 1},
        "Q13_push_warm_s9": {"min_energy": 1, "proposals": full - 1,
                             "protocol": "tempered_push_warm", "seed": 9},
        "Q12_push_warm": {"min_energy": 0, "proposals": full,
                          "protocol": "tempered_push_warm", "seed": 31337},
        "Q14_push_warm": {"min_energy": 3, "proposals": full,
                          "protocol": "tempered_push_warm", "seed": 31337},
    }
    assert qmax_campaign.derive_edge(out, 12) == {
        "q": 13, "seeds": [4242, 31337], "budget_proposals": full}
    assert qmax_campaign.derive_edge({"Q13": {"min_energy": 1}}, 12) is None


def test_warm_states_structure(tmp_path, monkeypatch):
    N, Q = 4, 8
    rng = np.random.default_rng(3)
    cells = rng.choice(N ** 3, size=Q - 1, replace=False)
    base = np.stack([cells // (N * N), (cells // N) % N, cells % N],
                    axis=-1).astype(np.int32)
    monkeypatch.setattr(qmax_push, "OUTDIR", str(tmp_path))
    with open(os.path.join(str(tmp_path), f"qmax_N{N}_Q{Q-1}.txt"), "w") as f:
        for i, j, k in base.tolist():
            f.write(f"{i},{j},{k}\n")
    monkeypatch.setattr(qmax_push, "oracle_energy", lambda a: 0)
    states = qmax_push.warm_states(N, Q, chains=32, seed=5)
    assert states.shape == (32, Q, 3)
    occ = set(map(tuple, base.tolist()))
    for r in range(32):
        rows = [tuple(q) for q in states[r].tolist()]
        assert rows[:Q - 1] == [tuple(q) for q in base.tolist()]
        assert len(set(rows)) == Q
        assert tuple(states[r, -1]) not in occ
    # the same starts as the JAX tool's from the same file and seed
    from tools import qmax_push as jax_push
    monkeypatch.setattr(jax_push, "OUTDIR", str(tmp_path))
    monkeypatch.setattr(jax_push, "full3d_energy", lambda a: 0)
    np.testing.assert_array_equal(
        states, jax_push.warm_states(N, Q, chains=32, seed=5))
    # a certificate that attacks is refused
    monkeypatch.setattr(qmax_push, "oracle_energy", verify_board.energy)
    (tmp_path / "qmax_N4_Q2.txt").write_text("0,0,0\n0,0,1\n")
    with pytest.raises(ValueError, match="zero-attack"):
        qmax_push.load_certificate(4, 2)


def _wire_floors(tmp_path, monkeypatch, energies):
    """Fake full3d_floors_campaign._search; energies is a list popped per
    call (fresh, confirm, refine0, refine1, ...)."""
    camp = full3d_floors_campaign
    monkeypatch.setattr(camp, "_outdir", lambda mcmc_type: str(tmp_path))
    calls = []

    def fake_search(n, seed, b0, b1, mcmc_type, outdir, resume_from=None,
                    n_steps=None, ladder=None, device=None):
        e = energies[len(calls)]
        calls.append((seed, b0, b1, resume_from, mcmc_type, n_steps, ladder))
        path = os.path.join(str(tmp_path), "competition_results",
                            f"best_heights_{n}_{len(calls):04d}.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("0,0,0\n")
        return e, path, 1.0

    monkeypatch.setattr(camp, "_search", fake_search)
    return camp, calls


def _floors_log(tmp_path):
    with open(os.path.join(str(tmp_path), "campaign.json")) as f:
        return json.load(f)


def test_floors_campaign_refines_until_stable(tmp_path, monkeypatch):
    camp, calls = _wire_floors(tmp_path, monkeypatch, [27, 26, 24, 24])
    camp.main(["--sizes", "14"])
    log = _floors_log(tmp_path)
    assert log["N14"]["floor"] == 24
    assert [c[:3] for c in calls] == [
        (31337, 0.8, 7.0), (4242, 0.8, 7.0),
        (777, 2.0, 10.0), (778, 2.0, 10.0),
    ]
    assert calls[2][3].endswith("0002.txt")  # confirm's 26 board
    assert calls[3][3].endswith("0003.txt")  # refine0's 24 board


def test_floors_campaign_resumes_from_banked_searches(tmp_path, monkeypatch):
    camp, calls = _wire_floors(tmp_path, monkeypatch, [30, 29, 29])
    camp.main(["--sizes", "12"])
    assert len(calls) == 3  # fresh, confirm, one stalled refinement
    camp2, calls2 = _wire_floors(tmp_path, monkeypatch, [])
    camp2.main(["--sizes", "12"])
    assert calls2 == []
    assert _floors_log(tmp_path)["N12"]["floor"] == 29


def _prior(tmp_path, monkeypatch, n, energy):
    prior = os.path.join(str(tmp_path), f"committed_{n}.txt")
    with open(prior, "w") as f:
        f.write("0,0,0\n")
    monkeypatch.setattr(verify_board, "verify", lambda p: {
        "distinct_cells": True, "oracle_energy": energy})
    return prior


def test_floors_campaign_board_refine_from(tmp_path, monkeypatch):
    camp, calls = _wire_floors(tmp_path, monkeypatch, [29, 29])
    prior = _prior(tmp_path, monkeypatch, 14, 30)
    camp.main(["--sizes", "14", "--mcmc-type", "board",
               "--refine-from", prior])
    log = _floors_log(tmp_path)
    kinds = [s["kind"] for s in log["N14"]["searches"]]
    assert kinds == ["prior", "refine0", "refine1"]
    assert log["N14"]["floor"] == 29
    assert calls[0][3] == prior and calls[0][4] == "board"
    assert calls[1][3].endswith("0001.txt") and calls[1][4] == "board"


def test_floors_campaign_long_schedule_banks_separately(tmp_path, monkeypatch):
    camp, calls = _wire_floors(tmp_path, monkeypatch, [29, 29])
    prior = _prior(tmp_path, monkeypatch, 18, 30)
    camp.main(["--sizes", "18", "--mcmc-type", "board",
               "--refine-from", prior])
    assert [c[0] for c in calls] == [777, 778]
    camp2, calls2 = _wire_floors(tmp_path, monkeypatch, [28, 28])
    camp2.main(["--sizes", "18", "--mcmc-type", "board",
                "--refine-from", prior, "--kind-prefix", "long",
                "--n-steps", "32000000", "--max-refines", "2"])
    assert [(c[0], c[5]) for c in calls2] == [(777, 32000000),
                                              (778, 32000000)]
    log = _floors_log(tmp_path)
    kinds = [s["kind"] for s in log["N18"]["searches"]]
    assert kinds == ["prior", "refine0", "refine1", "long0", "long1"]
    assert log["N18"]["searches"][3]["n_steps"] == 32000000
    assert log["N18"]["floor"] == 28


def test_floors_campaign_refine_from_held_floor(tmp_path, monkeypatch):
    camp, calls = _wire_floors(tmp_path, monkeypatch, [62])
    prior = _prior(tmp_path, monkeypatch, 15, 62)
    camp.main(["--sizes", "15", "--mcmc-type", "board",
               "--refine-from", prior])
    log = _floors_log(tmp_path)
    assert len(calls) == 1  # one stalled refinement, then stop
    assert log["N15"]["floor"] == 62
    assert log["N15"]["floor_board"] == "committed_15.txt"


# -- the oracle, the guard, real runs on the CPU ----------------------------

def test_verify_board_oracle_matches_tests_oracle():
    rng = np.random.default_rng(17)
    for _ in range(20):
        a, b = (tuple(int(x) for x in rng.integers(0, 6, 3)) for _ in "ab")
        for board_mode in (False, True):
            assert verify_board.pair_attacks(a, b, board_mode) == \
                _oracle.pair_attacks(a, b, board_mode)
    for N, Q in ((4, 12), (5, 25), (6, 30), (8, 48)):
        q = _oracle.random_full3d(rng, N, Q)
        assert verify_board.energy(q) == _oracle.full3d_energy(q)
    for N in (4, 6, 9):
        h = _oracle.random_board(rng, N)
        queens = [(i, j, int(h[i, j])) for i in range(N) for j in range(N)]
        assert verify_board.energy(queens) == _oracle.board_energy(h)


@pytest.mark.parametrize("name", [f"qmax/{c}" for c in CERTIFICATES] + [
    "competition_results/best_heights_14_20260817_0519_5e11tempering.txt",
    "board_floors/competition_results/best_heights_14_20260819_2259.txt",
    "full3d_floors/competition_results/best_heights_12_20260819_1413.txt"])
def test_verify_board_matches_the_jax_tool(name):
    from tools import verify_board as jax_verify

    path = str(REPO / "artifacts" / name)
    got = verify_board.verify(path)
    assert got == jax_verify.verify(path)
    if name.startswith("qmax/"):
        assert got["oracle_energy"] == 0 and got["distinct_cells"]
        assert got["queens"] == int(name.split("_Q")[1][:-4])


def test_output_guard_covers_every_depth():
    art = REPO / "artifacts"
    for path in (art / "qmax" / "x.txt", art / "full3d_floors" / "campaign.json",
                 art / "qmax" / "qmax_N24_Q403.txt", art / "x.json",
                 art / "board_floors" / "competition_results" / "b.txt",
                 art / "h100" / ".." / "qmax" / "x.txt"):
        for guard in (tools.output_path, tools.input_path):
            with pytest.raises(ValueError, match="TPU"):
                guard(path)
    for path in (art / "h100" / "qmax" / "x.txt",
                 art / "h100" / "full3d_floors" / "campaign.json",
                 art / "h100" / "x.json", REPO / "build" / "x.json"):
        assert tools.output_path(path) == path


def test_tool_roots_are_under_h100(monkeypatch):
    h100 = tools.H100_ARTIFACTS
    assert Path(qmax.OUTDIR) == h100 / "qmax"
    assert qmax_frontier.OUTDIR == qmax_push.OUTDIR == qmax_campaign.OUTDIR \
        == qmax.OUTDIR
    assert Path(full3d_floors_campaign._outdir("full_3d")) == (
        h100 / "full3d_floors")
    assert Path(full3d_floors_campaign._outdir("board")) == (
        h100 / "board_floors")
    # A root pointed into the TPU's artifacts is refused before any write.
    tpu = str(REPO / "artifacts" / "qmax")
    for mod in (qmax_frontier, qmax_push, qmax_campaign):
        monkeypatch.setattr(mod, "OUTDIR", tpu)
    with pytest.raises(ValueError, match="TPU"):
        qmax_frontier.main(["--n", "12", "--device", "cpu"])
    with pytest.raises(ValueError, match="TPU"):
        qmax_push.main(["--n", "12", "--start", "140", "--device", "cpu"])
    with pytest.raises(ValueError, match="TPU"):
        qmax_campaign.main(["--n", "12", "--skip-probes"])
    monkeypatch.setattr(full3d_floors_campaign, "_outdir",
                        lambda m: str(REPO / "artifacts" / "full3d_floors"))
    with pytest.raises(ValueError, match="TPU"):
        full3d_floors_campaign.main(["--sizes", "5", "--device", "cpu"])
    monkeypatch.setattr(qmax, "OUTDIR", tpu)
    with pytest.raises(ValueError, match="TPU"):
        qmax.write_certificate(os.path.join(tpu, "x.txt"), np.zeros((1, 3)))


def _tree(root):
    return {str(p): p.stat().st_mtime_ns for p in Path(root).rglob("*")}


def test_push_runs_on_the_cpu_inside_its_root(tmp_path, monkeypatch):
    """A warm push at tiny widths, run for real on the plain twins: it
    certifies or records a miss, clears its checkpoint, and writes nothing
    outside its root."""
    before = _tree(REPO / "artifacts")
    root = tmp_path / "qmax"
    root.mkdir()
    N, Q = 4, 7
    # The first six queens of the committed N=4 certificate attack none.
    rows = (REPO / "artifacts" / "qmax" / "qmax_N4_Q7.txt").read_text()
    (root / f"qmax_N{N}_Q{Q - 1}.txt").write_text(
        "".join(rows.splitlines(keepends=True)[:Q - 1]))
    for name, value in (("OUTDIR", str(root)), ("CHAINS", 32),
                        ("N_STEPS", 200), ("STRIDE", 50)):
        monkeypatch.setattr(qmax_push, name, value)
    ck = tmp_path / "ckpt"
    qmax_push.main(["--n", str(N), "--start", str(Q), "--warm-start",
                    "--checkpoint-dir", str(ck), "--device", "cpu"])
    out = json.loads((root / f"qmax_frontier_N{N}.json").read_text())
    rec = out[f"Q{Q}_push_warm"]
    assert rec["protocol"] == "tempered_push_warm"
    assert rec["proposals"] <= 32 * 200
    if rec["min_energy"] == 0:
        cert = verify_board.verify(str(root / rec["board"]))
        assert cert["oracle_energy"] == 0 and cert["queens"] == Q
    assert list(ck.iterdir()) == []  # cleared on completion
    assert _tree(REPO / "artifacts") == before


def test_floors_campaign_runs_on_the_cpu_inside_its_root(tmp_path,
                                                        monkeypatch):
    """Fresh, confirm and one refinement through the port's competition CLI
    on the plain twins: every search's board is banked under its own name
    (short searches finish within one minute), the floor is the least
    re-scored energy, and nothing is written outside the root."""
    before = _tree(REPO / "artifacts")
    for name, value in (("CHAINS", 16), ("STRIDE", 50)):
        monkeypatch.setattr(full3d_floors_campaign, name, value)
    monkeypatch.setattr(full3d_floors_campaign, "_outdir",
                        lambda m: str(tmp_path / m))
    full3d_floors_campaign.main(["--sizes", "4", "--n-steps", "100",
                                 "--ladder", "4", "--max-refines", "1",
                                 "--device", "cpu"])
    log = json.loads((tmp_path / "full_3d" / "campaign.json").read_text())
    searches = log["N4"]["searches"]
    assert [s["kind"] for s in searches] == ["fresh", "confirm", "refine0"]
    boards = sorted((tmp_path / "full_3d" / "competition_results").iterdir())
    assert len(boards) == 3 == len({s["board"] for s in searches})
    energies = {b.name: verify_board.verify(str(b))["oracle_energy"]
                for b in boards}
    assert {s["board"]: s["energy"] for s in searches} == energies
    assert log["N4"]["floor"] == min(energies.values())
    assert set(os.listdir(tmp_path / "full_3d")) == {"campaign.json",
                                                     "competition_results"}
    assert _tree(REPO / "artifacts") == before


def test_schedules_fig_cli(tmp_path):
    pytest.importorskip("matplotlib")
    from mcqueens_torch.cli import schedules_fig

    assert schedules_fig.main(["--outdir", str(tmp_path)]) == 0
    assert (tmp_path / "figures" / "beta_schedules.png").exists()


def test_remaining_refusals_cite_item_7(monkeypatch, tmp_path):
    """Nothing is left unported: the mesh runs in every entry point that
    refused it (tests/test_torch_mesh.py holds it to the JAX package), and
    no message cites the old queue item."""
    from mcqueens_torch.chain.spec import ChainSpec
    from mcqueens_torch.core.schedules import build_schedule
    from mcqueens_torch.dist import mesh, runner
    from mcqueens_torch.experiments.config import parse_config
    from mcqueens_torch.search import tempering

    spec = ChainSpec(N=4, n_steps=8, kernel="pallas_shared",
                     schedule=build_schedule("constant", 8, beta_const=1.0))
    seeds = np.arange(4, dtype=np.uint32)
    two = mesh.make_mesh(["cpu", "cpu"])
    plain = runner.run_chains(seeds, spec, device="cpu")
    got = runner.run_chains(seeds, spec, device="cpu", mesh=two)
    np.testing.assert_array_equal(got.best_energy, plain.best_energy)
    out = tempering.run_tempered(seeds, spec, [0.5, 1.0], device="cpu",
                                 mesh=two)
    assert out["energy_history"].shape == (4, 9)
    base = {"experiment_type": "single_N", "common": {}}
    for tpu in ({"mesh": True}, {"mesh": True, "profile_dir": "trace"}):
        assert parse_config({**base, "tpu": tpu}).tpu.mesh is True
    assert parse_config({**base, "tpu": {"profile_dir": "trace"}})
    monkeypatch.chdir(tmp_path)
    cfg = {"experiment_type": "single_N",
           "common": {"n_steps": 40, "n_runs": 2, "verbose": False,
                      "initialization": "random", "mcmc_type": "board",
                      "betta_scheduling": {"type": "linear_annealing",
                                           "beta_start": 0.5,
                                           "beta_end": 3.0},
                      "output_path": "figures/out.png"},
           "single_N": {"N": 4},
           "tpu": {"kernel": "pallas", "history_stride": 20}}
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    small = ["--n", "4", "--n-runs", "2", "--n-steps", "40"]
    for main, flags in ((competition.main, small + ["--mesh"]),
                        (exp_cli.main, ["--config", "cfg.yaml", "--mesh"]),
                        (exp_cli.main, ["--config", "cfg.yaml", "--mesh",
                                        "--profile-dir", "trace"])):
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(flags + ["--device", "cpu"]) == 0
    assert os.listdir(tmp_path / "trace")
    for mod in (runner, tempering, competition, exp_cli):
        with open(mod.__file__) as f:
            assert "queue 1 item 7" not in f.read(), mod.__name__


def test_warm_start_validation_matches_jax():
    """The runner's check of full-3D warm starts (vectorised for the push's
    65536 x 403 queens) refuses exactly what the JAX package's refuses."""
    from mcqueens.chain.spec import ChainSpec as JaxSpec
    from mcqueens.core import schedules as jschedules
    from mcqueens.dist import runner as jrunner
    from mcqueens_torch.chain.spec import ChainSpec
    from mcqueens_torch.core.schedules import build_schedule
    from mcqueens_torch.dist import runner

    N, Q, C = 4, 10, 16
    kw = dict(N=N, n_steps=8, Q=Q, mcmc_type="full_3d",
              kernel="pallas_shared")
    spec = ChainSpec(schedule=build_schedule("constant", 8, beta_const=1.0),
                     **kw)
    jspec = JaxSpec(schedule=jschedules.build_schedule("constant", 8,
                                                       beta_const=1.0), **kw)
    rng = np.random.default_rng(23)
    states = np.stack([_oracle.random_full3d(rng, N, Q) for _ in range(C)])
    np.testing.assert_array_equal(
        runner.validate_initial_states(states, spec, C),
        jrunner.validate_initial_states(states, jspec, C))
    for r, a, b in ((0, 0, 1), (7, 3, 9), (15, 8, 9)):
        bad = states.copy()
        bad[r, b] = bad[r, a]
        for check, s in ((runner.validate_initial_states, spec),
                         (jrunner.validate_initial_states, jspec)):
            with pytest.raises(ValueError, match="same"):
                check(bad, s, C)
