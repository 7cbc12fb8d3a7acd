"""Throughput reporting, profiler traces and wall-clock phases, port of
:mod:`mcqueens.utils.profiling`.

:func:`trace` is the counterpart of its ``jax.profiler`` trace: a
``torch.profiler`` trace (host activity, and the card's kernels where CUDA
is available) written under a directory as a Chrome trace,
``<host>_<pid>.<ns>.pt.trace.json``, which ``chrome://tracing``, Perfetto
and TensorBoard's PyTorch profiler plugin read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
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
    devices are the distinct devices the run used (``result.devices``: one
    without a mesh, the mesh's distinct cards with one; a CPU mesh is one
    device however many shards it has)."""
    if n_devices is None:
        n_devices = len(set(result.devices)) or 1
    return ThroughputReport(
        proposals=result.proposals,
        wall_time_s=result.wall_time,
        n_devices=n_devices,
    )


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` trace of the ``with`` body, written under
    ``log_dir`` when the body ends; no-op when ``log_dir`` is None.

    The port's kernels launch through ``ctypes``, not as torch operators, so
    the host side of the trace shows the Python calls around them; the
    card's side (CUDA activity, recorded by CUPTI) names each kernel."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def timed(label: str, sink=print):
    """Report the wall-clock seconds of the ``with`` body to ``sink``."""
    t0 = time.time()
    yield
    sink(f"[mcqueens] {label}: {time.time() - t0:.3f}s")
