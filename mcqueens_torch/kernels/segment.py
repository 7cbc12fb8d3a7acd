"""What the samplers' segment layers share.

Every sampler keeps its chains in a chains-major carry between segments and
runs a launch on a working state that its CUDA kernel and the kernel's
plain-torch twin both update in place.  This module holds the parts that do
not depend on the sampler: the transposes between a carry and a
chains-minor working state; every sampler's launch path (:func:`call`,
:func:`launch`) and chunk loop (:func:`run`), with the twin for CPU tensors
and the kernel for CUDA tensors and no fallback between them; the launch
layout of the team kernels (a team of lanes a chain) with what an SM holds
of it, and the cost model that lays out the per-chain ones.

A sampler is its module (``mod``), read when it is called: its
``segment_state``, ``segment_reference`` (the twin), ``launch_segment``
(argument checks, layout, and the call of the CUDA library or its host
emulation) and ``KERNEL_LAUNCHES``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from mcqueens_torch.core.schedules import chunk_betas
from mcqueens_torch.kernels import _build
from mcqueens_torch.utils import profiling

# An SM's limits on Hopper: resident threads, CTAs and 32-bit registers.
SM_THREADS, SM_CTAS, SM_REGISTERS = 2048, 32, 65536


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a shared-site CUDA kernel lays out a launch: ``lanes`` lanes a
    chain, ``chains_per_cta`` chains a CTA, and ``smem_bytes`` of shared
    memory a CTA holding its chains' state, or 0 when the kernel walks it in
    device memory."""

    lanes: int
    chains_per_cta: int
    smem_bytes: int

    @property
    def in_shared(self) -> bool:
        return self.smem_bytes > 0


def resident_ctas(lay: Layout, registers: int) -> int:
    """CTAs of ``lay`` an SM holds at once: its threads, CTAs, registers
    (``registers`` a thread) and, for a shared-memory layout, shared
    memory."""
    threads = lay.lanes * lay.chains_per_cta
    ctas = min(SM_CTAS, SM_THREADS // threads,
               SM_REGISTERS // (registers * threads))
    if lay.smem_bytes:
        ctas = min(ctas, _build.SMEM_PER_SM // (
            lay.smem_bytes + _build.SMEM_RESERVED_PER_BLOCK))
    return ctas


@dataclasses.dataclass(frozen=True)
class TeamModel:
    """The cost model of a per-chain kernel whose team of L lanes splits a
    step's work into units (``csrc/metropolis.cu``: the lines' row
    offsets; ``csrc/full3d_pallas.cu``: the queens), fitted on the card: a
    lane issues ``per_unit`` instructions for each unit it takes,
    ``per_step`` for the rest of a step and ``per_draw`` for a step's draws
    (one a lane a batch of L steps); a step's latency is ``unit_lat``
    cycles a unit, ``step_lat`` for the rest, and ``sum_lat`` a level of
    the team's sum (``redux_lat`` for the one reduce of a whole warp).  A
    wave of warps takes the longer of its instructions over four schedulers
    and a step's latency, plus ``overlap`` of the shorter.  ``registers`` a
    thread, ``max_threads`` a CTA."""

    per_unit: float
    per_step: float
    per_draw: float
    unit_lat: float
    step_lat: float
    sum_lat: float
    redux_lat: float
    overlap: float
    registers: int
    max_threads: int

    def cost(self, lay: Layout, units: int, C: int, n_sm: int) -> float:
        """A step's cycles on the busiest SM of ``n_sm`` for ``C`` chains of
        ``units`` units each: its CTAs run in waves of what it holds
        (:func:`resident_ctas`)."""
        lanes, cpb = lay.lanes, lay.chains_per_cta
        passes, levels = -(-units // lanes), int(math.log2(lanes))
        issue = (passes * self.per_unit + self.per_step
                 + self.per_draw / lanes + (3 + levels) * (lanes > 1))
        latency = (passes * self.unit_lat + self.step_lat
                   + (self.redux_lat if lanes == 32 else levels * self.sum_lat))
        ctas = resident_ctas(lay, self.registers)
        per_sm = -(-math.ceil(C / cpb) // n_sm)  # CTAs on the busiest SM

        def wave(k):
            slots = k * cpb * lanes / 32 / 4 * issue
            return max(slots, latency) + self.overlap * min(slots, latency)

        full, rest = divmod(per_sm, ctas)
        return full * wave(ctas) + (wave(rest) if rest else 0)

    def layout(self, units: int, C: int, n_sm: int, lanes,
               cta_smem: Callable[[int, int], int]) -> Layout:
        """The layout of least :meth:`cost` among the team sizes ``lanes``
        and chains a CTA (lanes times chains a CTA a power of two from 32 to
        ``max_threads``) whose ``cta_smem(lanes, chains_per_cta)`` bytes fit
        a block; ties go to fewer chains a CTA (more SMs), then fewer lanes.
        Raises ``ValueError`` if none fits."""
        lays = [Layout(L, (32 << k) // L, cta_smem(L, (32 << k) // L))
                for L in lanes for k in range(6)
                if 32 << k <= self.max_threads
                and cta_smem(L, (32 << k) // L) <= _build.SMEM_PER_BLOCK]
        if not lays:
            raise ValueError(f"no layout of {lanes} lanes a chain fits a "
                             f"block's {_build.SMEM_PER_BLOCK} bytes of "
                             f"shared memory")
        return min(lays, key=lambda lay: (self.cost(lay, units, C, n_sm),
                                          lay.chains_per_cta, lay.lanes))


def chains_minor(carry, planes, rows) -> dict:
    """Fresh chains-minor copies of ``carry``'s fields: each ``(C, ...)``
    plane of ``planes`` as ``(X, C)`` (a ``None`` field stays ``None``),
    each ``(C,)`` or ``(C, 1)`` row of ``rows`` as ``(C,)``."""
    kw = {}
    for name in planes:
        t = getattr(carry, name)
        kw[name] = (None if t is None
                    else t.reshape(t.shape[0], -1).t().contiguous())
    kw.update({name: getattr(carry, name).reshape(-1).clone()
               for name in rows})
    return kw


def chains_major(st, planes, rows, row_shape=(-1, 1)) -> dict:
    """Inverse of :func:`chains_minor`: each plane back to ``(C, X)``, each
    row to ``row_shape``."""
    kw = {}
    for name in planes:
        t = getattr(st, name)
        kw[name] = None if t is None else t.t().contiguous()
    kw.update({name: getattr(st, name).reshape(row_shape).clone()
               for name in rows})
    return kw


def on_device(name: str, dev, reference: Callable, cuda: Callable, *args,
              **kw):
    """``reference(*args, **kw)`` for state on the CPU, ``cuda(*args,
    **kw)`` for state on a CUDA device, ``ValueError`` for anything else."""
    if dev.type == "cpu":
        return reference(*args, **kw)
    if dev.type == "cuda":
        return cuda(*args, **kw)
    raise ValueError(f"{name} runs on cpu or cuda, not {dev}")


class _OffCard:
    """The library a launch of state off the card gets: ``launch_segment``
    checks its arguments first, then finds its entry point refused."""

    def __init__(self, dev):
        self.dev = dev

    def __getattr__(self, name):
        raise ValueError(f"{name}: state on {self.dev}, not a CUDA device")


def launch(mod, st, *args, **kw):
    """``mod.launch_segment(lib, st, *args, n_sm=, stream=, **kw)`` on the
    current stream of ``st``'s CUDA device (made current), counted in
    ``mod.KERNEL_LAUNCHES``; returns what it returns.  State off the card
    raises ``ValueError`` once its arguments pass the checks."""
    dev = st.energy.device
    if dev.type != "cuda":
        mod.launch_segment(_OffCard(dev), st, *args, n_sm=1, **kw)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        out = mod.launch_segment(_build.load_library(), st, *args,
                                 n_sm=n_sm, stream=stream, **kw)
    mod.KERNEL_LAUNCHES += 1
    return out


def _choose(mod, st, *args, **kw):
    on_device(mod.__name__, st.energy.device, mod.segment_reference,
              functools.partial(launch, mod), st, *args, **kw)


def call(mod, st, step0: int, n_inner: int, spec, **kw) -> None:
    """One chunk of ``n_inner`` steps from global step ``step0`` on ``st``,
    in place, in an ``mcq.launch`` span: its betas (:func:`chunk_betas`),
    then the twin for CPU state or :func:`launch` for CUDA state."""
    with profiling.span("mcq.launch"):
        beta = chunk_betas(spec.schedule, step0, n_inner, st.energy.device)
        _choose(mod, st, step0, n_inner, spec, beta, **kw)


def call_scan(mod, st, start_outer: int, n_outer: int, spec):
    """A scan sampler's segment of ``n_outer`` history chunks from chunk
    ``start_outer``, as :func:`call`; returns its ``(n_outer, C)`` int32
    energy rows, allocated in the span."""
    dev, stride = st.energy.device, spec.history_stride
    with profiling.span("mcq.launch"):
        beta = chunk_betas(spec.schedule, start_outer * stride,
                           n_outer * stride, dev)
        ys = torch.empty((n_outer, st.energy.shape[0]), dtype=torch.int32,
                         device=dev)
        _choose(mod, st, ys, start_outer, n_outer, spec, beta)
    return ys


def run(mod, carry, start_outer: int, spec, n_outer: int, beta_scale=None,
        **kw):
    """``n_outer`` chunks of ``history_stride`` steps from chunk
    ``start_outer`` (:func:`call`, ``kw`` passed on) on a working state of
    ``carry``; returns it and the ``(n_outer, C)`` int32 energies after
    each chunk.  A ``beta_scale`` (tempered) scales chain ``c``'s beta."""
    if beta_scale is not None:
        kw["beta_scale"] = torch.as_tensor(
            beta_scale, dtype=torch.float32,
            device=carry.device).reshape(-1).contiguous()
    stride = spec.history_stride
    st = mod.segment_state(carry)
    ys = torch.empty((n_outer, st.energy.shape[0]), dtype=torch.int32,
                     device=st.energy.device)
    for o in range(n_outer):
        call(mod, st, (int(start_outer) + o) * stride, stride, spec, **kw)
        ys[o].copy_(st.energy)
    return st, ys

