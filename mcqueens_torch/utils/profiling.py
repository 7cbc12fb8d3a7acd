"""Throughput reporting and wall-clock phases, port of
:mod:`mcqueens.utils.profiling` (its ``jax.profiler`` trace is not ported)."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


@dataclasses.dataclass
class ThroughputReport:
    proposals: int
    wall_time_s: float
    n_devices: int

    @property
    def moves_per_sec(self) -> float:
        return self.proposals / max(self.wall_time_s, 1e-9)

    @property
    def moves_per_sec_per_chip(self) -> float:
        return self.moves_per_sec / max(self.n_devices, 1)

    def __str__(self) -> str:
        return (
            f"{self.proposals:.3e} proposals in {self.wall_time_s:.3f}s "
            f"= {self.moves_per_sec:.3e} moves/s "
            f"({self.moves_per_sec_per_chip:.3e} /chip on {self.n_devices})"
        )


def throughput_of(result, n_devices: int | None = None) -> ThroughputReport:
    """Throughput of a :class:`mcqueens_torch.dist.runner.ChainResult`;
    devices are ``torch.cuda.device_count()`` for a CUDA run, 1 on the CPU."""
    if n_devices is None:
        n_devices = (torch.cuda.device_count()
                     if torch.device(result.device).type == "cuda" else 1)
    return ThroughputReport(
        proposals=result.proposals,
        wall_time_s=result.wall_time,
        n_devices=n_devices,
    )


@contextlib.contextmanager
def timed(label: str, sink=print):
    """Report the wall-clock seconds of the ``with`` body to ``sink``."""
    t0 = time.time()
    yield
    sink(f"[mcqueens] {label}: {time.time() - t0:.3f}s")
