"""Whether a run's searches answered right, judged by the reference.

One search of the window, drawn from the run's seed among its first four
(:func:`drawn_search`), is checked whole against what its chains claim
(:func:`claims`) and chain by chain: a few of its chains, drawn from the
seed as well, one from each stretch of the batch, are walked again step by
step from their seeds by the reference of the configuration's sampler
family (``reference/<family>.py``), with the betas the kind of search
gives them (``kinds/<search>.py``), and every number the program returned
of them must come out the same (:func:`replay`).

The numbers compared, each with the limit it may not pass:

* ``energy``: chains whose reported initial, final or best energy is not
  the reference's energy of the reference's initial state, of the reported
  final state or of the reported best state, or whose last history point
  is not the final energy, or whose best is above a history point;
* ``proposals`` (the kind's): chains whose proposals in each bin are not
  the spec's steps there (a tempered search reports only its total, held
  to chains x steps);
* ``exchange`` (tempered searches only), ladder groups whose final betas
  are not those the reference works out from the reported energies, or
  not a permutation of the ladder;
* ``replay``: drawn chains whose replayed history, final and best states
  and energies, best step, bins or betas differ from the reported ones.

All four are exact, so every limit is 0.  The reference takes from the
program only its reported numbers: it makes the initial states, the
block partition, the draws, the schedule and the ladder from the seeds and
the configuration itself.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch

from benchmark.reference import states as S

LIMITS = {"energy": 0, "proposals": 0, "exchange": 0, "replay": 0}


@dataclasses.dataclass
class Spec:
    """What the reference needs of a cell: its configuration and workload,
    the search's shape, and the modules of its sampler family
    (``reference/<family>.py``) and kind of search (``kinds/<search>.py``)."""

    config: dict
    workload: dict
    n_steps: int
    stride: int
    n_bins: int
    shards: int              # cards the chains are sharded over
    family: object
    kind: object

    @property
    def N(self) -> int:
        return self.config["N"]

    @property
    def chains(self) -> int:
        return self.config["chains"]


def field(result, name):
    """Field ``name`` of what a search returned (a dict or an object)."""
    return result[name] if isinstance(result, dict) else getattr(result, name)


def _energies(spec: Spec, states, device) -> np.ndarray:
    t = torch.as_tensor(states, device=device)
    return S.energies(spec.family.queens(spec.config, t), spec.N).cpu().numpy()


def initial_states(spec: Spec, base: int, chains, device):
    """The reference's initial states of ``chains`` (a 1-D index tensor)
    of the search with base seed ``base``."""
    seeds = torch.as_tensor(chains, dtype=torch.int64, device=device) + base
    return spec.family.initial_states(spec.config, seeds)


def claims(spec: Spec, base: int, result, device) -> dict:
    """Whole-batch counts of ``energy`` faults of one search, and the
    kind's own (``proposals``; tempered: ``exchange``, and the ladder
    groups whose exchanges were ambiguous, ``ambiguous``, a (G,) bool
    row)."""
    hist = np.asarray(field(result, "energy_history"), np.int64)
    final = np.asarray(field(result, "final_energy"), np.int64)
    best = np.asarray(field(result, "best_energy"), np.int64)
    init = initial_states(spec, base, torch.arange(spec.chains), device)
    e0 = _energies(spec, init, device)
    bad = ((hist[:, 0] != e0) | (hist[:, -1] != final)
           | (_energies(spec, field(result, "final_state"), device) != final)
           | (_energies(spec, field(result, "best_state"), device) != best)
           | (best > hist.min(1)))
    return {"energy": int(bad.sum()),
            **spec.kind.claims(spec, base, result, hist)}


def draw_chains(spec: Spec, rng: random.Random, k: int, ambiguous=None):
    """``k`` chains, one from each of ``k`` equal stretches of the batch,
    none from a group whose exchanges were ambiguous."""
    levels = spec.workload.get("ladder_levels", 1)
    out = []
    for s in range(k):
        lo, hi = s * spec.chains // k, (s + 1) * spec.chains // k
        for _ in range(64):
            c = rng.randrange(lo, hi)
            if ambiguous is None or not ambiguous[c // levels]:
                out.append(c)
                break
    return out


def reported(spec: Spec, result, chain: int) -> dict:
    """What the program reported of one chain, in the reference's form."""
    def row(name):
        return np.asarray(field(result, name))[chain]

    shape = spec.family.STATE_SHAPE
    out = {"energy_history": row("energy_history").tolist(),
           "final_energy": int(row("final_energy")),
           "final_state": row("final_state").reshape(shape).tolist(),
           "best_energy": int(row("best_energy")),
           "best_state": row("best_state").reshape(shape).tolist()}
    for key, name in spec.kind.REPORTED.items():
        v = row(name)
        out[key] = v.tolist() if v.ndim else int(v)
    return out


def replay(spec: Spec, base: int, result, chains,
           precision: str = "float32"):
    """The drawn ``chains`` whose replay differs from what the program
    reported."""
    hist = np.asarray(field(result, "energy_history"), np.int64)
    init = initial_states(spec, base, chains, "cpu").numpy()
    betas, final = spec.kind.chain_betas(spec, base, hist, chains)
    bad = []
    for n, c in enumerate(chains):
        want = reported(spec, result, c)
        got = spec.family.walk(spec, base, c, init[n], betas[n], precision)
        same = any(all(g[k] == v for k, v in want.items()) for g in got)
        if final is not None:
            same &= bool(np.asarray(field(result, "betas"))[c] == final[n])
        if not same:
            bad.append(c)
    return bad


def drawn_search(seed: int, first: int = 4) -> int:
    """The index of the search a run checks, drawn from its seed among
    the window's first ``first`` searches."""
    return random.Random(f"search:{seed}").randrange(first)


def run_checks(spec: Spec, base: int, result, seed: int, k: int, device,
               precision: str = "float32"):
    """``(checks, notes)``: each number of the module docstring with its
    limit, for the search of base seed ``base`` that returned ``result``;
    ``k`` of its chains, drawn from ``seed``, are walked again."""
    got = claims(spec, base, result, device)
    ambiguous = got.pop("ambiguous", None)
    chains = draw_chains(spec, random.Random(seed), k, ambiguous)
    bad = replay(spec, base, result, chains, precision)
    got["replay"] = len(bad) + (k - len(chains))
    notes = {"chains": chains, "replay_bad": bad}
    if ambiguous is not None:
        notes["ambiguous_groups"] = int(ambiguous.sum())
    checks = {name: {"value": got[name], "limit": LIMITS[name]}
              for name in LIMITS if name in got}
    return checks, notes
