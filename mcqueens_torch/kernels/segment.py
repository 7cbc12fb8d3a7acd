"""What the samplers' segment layers share.

Every sampler keeps its chains in a chains-major carry between segments and
runs a launch on a working state that its CUDA kernel and the kernel's
plain-torch twin both update in place.  This module holds the parts that do
not depend on the sampler: the transposes between a carry and a
chains-minor working state, and the choice of the twin for CPU tensors and
the kernel for CUDA tensors, with no fallback between them.
"""

from __future__ import annotations

from typing import Callable


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
