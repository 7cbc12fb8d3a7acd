"""Throughput reporting, profiler traces, spans and wall-clock phases, port
of :mod:`mcqueens.utils.profiling`.

:func:`trace` is the counterpart of its ``jax.profiler`` trace: a
``torch.profiler`` trace (host activity, and the card's kernels where CUDA
is available) written under a directory as a Chrome trace,
``<host>_<pid>.<ns>.pt.trace.json``, which ``chrome://tracing``, Perfetto
and TensorBoard's PyTorch profiler plugin read.

:func:`span` marks the program's layers on the host side of any running
``torch.profiler`` (a :func:`trace`, or a caller's own profiler) and costs
one check when none runs.  The spans of a search, each nested in the one
above it on the calling thread:

- ``mcq.search``: one ``run_chains`` or ``run_tempered`` call, entry to
  return (its ``wall_time``);
- ``mcq.init``: the carry's build, the first energies' read, a checkpoint's
  restore, the ladder's betas, the mesh's shard copies;
- ``mcq.round``: one segment of ``run_chains``, one round of
  ``run_tempered``;
- ``mcq.launch``: one sampler launch (``kernels.segment.call``): its betas
  (``mcq.betas``, :func:`~mcqueens_torch.core.schedules.chunk_betas`) and
  the kernel's enqueue, or its plain-torch twin on the CPU;
- ``mcq.transpose``: a carry's transpose into or out of a segment's
  working state (``segment_state`` / ``carry_of``);
- ``mcq.read``: one device-to-host read (the segment's energies, a carry
  field, the first energies, the betas, the heights' range check);
- ``mcq.exchange``: the tempered round's energy gather and exchange;
- ``mcq.mesh.shard``: one shard's enqueue of a segment; ``mcq.mesh.gather``:
  one gather of shards to one device (``gather_chains``, the segment's
  energies);
- ``mcq.checkpoint``: one save (the carry's gather to the host and its
  files); ``mcq.checkpoint.write``: one file it writes, a history chunk or
  the main npz;
- ``mcq.drain``: the last round to the return: ``mcq.sync`` (the wait for
  every card), the result's reads and its assembly.
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


_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context manager that records ``name`` as one host event of the
    running ``torch.profiler``, on the profiler's clock and the calling
    thread, and puts nothing on the device's timeline (a plain ``cpu_op``,
    not a ``record_function`` user annotation, which the profiler mirrors
    on the card).  With no profiler running it is one shared null
    context."""
    return _RecordFunctionFast(name) if _profiling() else _NULL


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` trace of the ``with`` body, written under
    ``log_dir`` when the body ends; no-op when ``log_dir`` is None.

    The port's kernels launch through ``ctypes``, not as torch operators, so
    the host side of the trace shows each launch as its ``mcq.launch`` span
    (:func:`span`); the card's side (CUDA activity, recorded by CUPTI)
    names each kernel."""
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
