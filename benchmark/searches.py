"""The general generator: whole searches of a cell, from its files.

A configuration file (``configs/<config>.json``) fixes the deployment: the
sampler ``family``, the placement kind, N and Q, the chains, the beta
range, the steps of a search and its history stride (the steps of each
launch).  A workload file (``workloads/<cell>.json``) fixes how the cell
searches: the kind of search (``search``), read by ``kinds/<search>.py``
with its own keys, ``mesh`` (shard the chains over the cell's cards,
``mesh_for("cuda", chips)``), the launches of the warm-up search and the
chains the check walks again.  The family names the reference that judges
the chains (``reference/<family>.py``) and their work count
(``work/<family>.py``).

Search ``i`` of a run takes the base seed :func:`base_seed` of (run seed,
i): its chains are ``base + 0 .. chains - 1`` and a tempered search's swap
seed is ``base``, as the CLI sets them from ``--seed``.  Every search of
every run does the same work; only its draws differ.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
from pathlib import Path

from benchmark import check


def base_seed(seed: int, i: int, chains: int) -> int:
    """A base seed for search ``i`` of the run with seed ``seed``, below
    2^31 - chains so that every chain seed stays a non-negative int32."""
    digest = hashlib.sha256(f"{seed}:{i}".encode()).digest()
    return int.from_bytes(digest[:8], "little") % (2 ** 31 - chains)


def n_bins(n_steps: int) -> int:
    """The competition CLI's acceptance bins: 100, fewer where
    n_steps * bins would overflow int32."""
    return max(1, min(100, (2 ** 31 - 1) // max(n_steps, 1)))


def load_module(path: Path):
    """A module of the benchmark found by file name (names may hold
    dots)."""
    name = f"benchmark_{path.parent.name}_{path.stem}"
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    workload: dict
    chips: int
    family: object            # reference/<family>.py
    work: object              # work/<family>.py
    kind: object              # kinds/<search>.py

    @classmethod
    def load(cls, here: Path, name: str, config: dict, workload: dict,
             chips: int) -> "Cell":
        """The cell with its family's and kind's modules, from the
        benchmark's folder ``here``."""
        fam = config["family"]
        return cls(name=name, config=config, workload=workload, chips=chips,
                   family=load_module(here / "reference" / f"{fam}.py"),
                   work=load_module(here / "work" / f"{fam}.py"),
                   kind=load_module(here / "kinds"
                                    / f"{workload['search']}.py"))

    @property
    def stride(self) -> int:
        return self.config["history_stride"]

    @property
    def shards(self) -> int:
        return self.chips if self.workload.get("mesh") else 1

    def spec(self) -> check.Spec:
        """The reference's view of a search of this cell."""
        c = self.config
        return check.Spec(
            config=c, workload=self.workload, n_steps=c["n_steps"],
            stride=self.stride, n_bins=n_bins(c["n_steps"]),
            shards=self.shards, family=self.family, kind=self.kind)

    @property
    def proposals(self) -> int:
        """Proposed moves of one search: chains x steps."""
        return self.config["chains"] * self.config["n_steps"]

    def launches(self):
        """Steps of each sampler launch of a search (one a history chunk);
        each card of a mesh makes all of them on its share."""
        n, s = self.config["n_steps"], self.stride
        return [min(s, n - a) for a in range(0, n, s)]


class Searcher:
    """Calls into the program for one cell's searches on ``device``."""

    def __init__(self, cell: Cell, device: str):
        from mcqueens_torch.dist import mesh as mesh_mod

        self.cell, self.device = cell, device
        self.mesh = (mesh_mod.mesh_for(device, cell.chips)
                     if cell.workload.get("mesh") else None)

    def __call__(self, base: int, n_steps: int | None = None):
        """One search from base seed ``base`` (``n_steps`` shortens it, for
        the warm-up); returns what the program returns."""
        return self.cell.kind.search(
            self.cell, self.device, self.mesh, base,
            n_steps or self.cell.config["n_steps"])
