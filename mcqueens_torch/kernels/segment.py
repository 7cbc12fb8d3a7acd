"""What the samplers' segment layers share.

Every sampler keeps its chains in a chains-major carry between segments and
runs a launch on a working state that its CUDA kernel and the kernel's
plain-torch twin both update in place.  This module holds the parts that do
not depend on the sampler: the transposes between a carry and a
chains-minor working state, the choice of the twin for CPU tensors and the
kernel for CUDA tensors, with no fallback between them, and the launch
layout of the shared-site kernels (a team of lanes a chain) with what an SM
holds of it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from mcqueens_torch.kernels import _build

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
