"""Chain sharding over devices, port of :mod:`mcqueens.dist.mesh`.

A mesh is an ordered tuple of ``torch.device``s, one a shard of the
``chains`` axis.  Each shard owns a contiguous run of whole chain blocks: its
carry lives on its own device and its chunks launch on that device's current
stream, one after another shard by shard, with no synchronise between
shards; the host reads a segment's ``ys`` once every shard's launches of the
segment are enqueued, so the segments of several cards overlap.  Chains
never talk to each other inside a segment: cross-shard data is only the
segment's energy rows, the exchange of tempering and :func:`global_best_stats`.

A device may appear more than once.  Its shards then run one after the
other; that is how a CPU mesh of ``n`` shards (``[torch.device("cpu")] *
n``, the counterpart of JAX's ``jax_num_cpu_devices=n``) and ``n`` shards on
one card run the sharded code.

The mesh is semantic only through its shard count: :func:`pad_seeds_to_blocks`
sizes the chain block from one shard's share, as the JAX package does, and
the block decides which chains share a site stream.  Block seeds are global
(``seeds[0] + 7919 * b`` over the whole padded carry), so callers build the
whole carry once and split it with :func:`shard_chains`.  Launch layouts
follow each shard's own chain count and change nothing.

``init_distributed`` (multi-host JAX) is not ported: one process drives
every device of its host.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

CHAINS_AXIS = "chains"


def make_mesh(devices=None) -> tuple[torch.device, ...]:
    """A 1-D chains mesh over ``devices`` (any iterable of devices or device
    strings, repeats allowed), or over every visible CUDA device.

    Without ``devices`` it needs CUDA and raises ``RuntimeError`` if
    ``torch.cuda.is_available()`` is False (there is no CPU fallback).  A
    ``cuda`` device without an index means the current one.  Every device
    must be of one type, ``cpu`` or ``cuda``.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() spans the visible CUDA devices, "
                               "but torch.cuda.is_available() is False")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if isinstance(devices, (str, torch.device)) or not hasattr(
            devices, "__iter__"):
        raise TypeError(f"a mesh is a sequence of devices, got {devices!r}")
    mesh = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        mesh.append(d)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    types = {d.type for d in mesh}
    if len(types) > 1 or not types <= {"cpu", "cuda"}:
        raise ValueError(f"a mesh's devices are all cpu or all cuda, got "
                         f"{sorted(types)}")
    return tuple(mesh)


def mesh_for(device, shards=True) -> tuple[torch.device, ...]:
    """The mesh that ``--mesh`` (``shards=True``) or the config's
    ``tpu.mesh: n`` (``shards=n``) means on ``device``'s type.

    On CUDA: every visible card, or the first ``n`` of them (fewer if fewer
    are visible, as JAX's ``jax.devices()[:n]``).  On the CPU, which torch
    sees as one device: one shard, or ``n`` shards on it.
    """
    dev = torch.device(device)
    if isinstance(shards, bool):
        n = None
    else:
        n = int(shards)
        if n < 1:
            raise ValueError(f"a mesh of {shards!r} devices")
    if dev.type == "cpu":
        return make_mesh([dev] * (n or 1))
    if dev.type != "cuda":
        raise ValueError(f"no mesh on {dev}")
    mesh = make_mesh()
    return mesh if n is None else mesh[:n]


def check_mesh(mesh, device) -> tuple[torch.device, ...]:
    """``mesh`` as a tuple of devices (:func:`make_mesh`); ``ValueError``
    unless their type is ``device``'s."""
    mesh = make_mesh(mesh)
    dev = torch.device(device)
    if mesh[0].type != dev.type:
        raise ValueError(f"device {dev} and a mesh of {mesh[0].type} "
                         f"devices disagree")
    return mesh


def distinct(mesh) -> tuple[torch.device, ...]:
    """The mesh's devices, each once, in mesh order."""
    return tuple(dict.fromkeys(mesh))


def synchronize(devices) -> None:
    """Wait for the work queued on every CUDA device of ``devices``."""
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def pad_chains(n_chains: int, mesh) -> int:
    """Round the chain count up to a multiple of the mesh size."""
    if mesh is None:
        return n_chains
    d = len(mesh)
    return -(-n_chains // d) * d


def pad_seeds_to_blocks(seeds, mesh, block_size_fn: Callable[[int], int]):
    """Pad a seed list so every shard owns whole chain blocks.

    The block is sized from ONE shard's share (``block_size_fn(per_dev)``)
    and the total is rounded to ``n_dev * k * block`` with follow-on seeds
    ``seeds[-1] + 1 + arange`` (uint32; padded chains are discarded).
    Returns ``(padded_seeds, block)``.
    """
    seeds = np.asarray(seeds, dtype=np.uint32)
    n = seeds.shape[0]
    n_dev = len(mesh)
    per_dev = -(-n // n_dev)
    block = block_size_fn(per_dev)
    per_dev = -(-per_dev // block) * block
    total = per_dev * n_dev
    if total > n:
        pad = seeds[-1] + 1 + np.arange(total - n, dtype=np.uint32)
        seeds = np.concatenate([seeds, pad])
    return seeds, block


def _split(t: torch.Tensor, n: int, what: str):
    if t.shape[0] % n:
        raise ValueError(f"{what}: {t.shape[0]} rows do not split into {n} "
                         f"shards")
    return t.split(t.shape[0] // n)


def shard_chains(carry, mesh):
    """Split a carry (a dataclass of chains-major tensors) or one tensor on
    axis 0 into ``len(mesh)`` equal shards, shard ``s`` on ``mesh[s]``.

    A carry's ``block_seeds`` (one row a block) splits by blocks, so each
    shard keeps the global seeds of its own blocks; a ``None`` field stays
    ``None``.  Returns a tuple of carries (or tensors) in mesh order.
    """
    n = len(mesh)
    if isinstance(carry, torch.Tensor):
        return tuple(p.to(d).contiguous()
                     for p, d in zip(_split(carry, n, "tensor"), mesh))
    parts = {f.name: (None if getattr(carry, f.name) is None
                      else _split(getattr(carry, f.name), n, f.name))
             for f in dataclasses.fields(carry)}
    return tuple(
        type(carry)(**{name: None if p is None else p[s].to(d).contiguous()
                       for name, p in parts.items()})
        for s, d in enumerate(mesh))


def gather_chains(shards: Sequence, device=None):
    """Inverse of :func:`shard_chains`: the shards (carries or tensors)
    joined on axis 0 on ``device`` (default: the first shard's)."""
    first = shards[0]
    dev = first.device if device is None else torch.device(device)
    if isinstance(first, torch.Tensor):
        return torch.cat([s.to(dev) for s in shards])
    out = {}
    for f in dataclasses.fields(first):
        vals = [getattr(s, f.name) for s in shards]
        out[f.name] = (None if vals[0] is None
                       else torch.cat([v.to(dev) for v in vals]))
    return type(first)(**out)


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device inside the ``with`` body (a
    no-op for the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def run_sharded(fn, shards: Sequence, mesh, *rows):
    """``fn(shard, *row_parts)`` on each shard with its device current,
    shard by shard, where each ``fn`` returns ``(carry, ys)`` with ``ys``
    ``(n_outer, C_shard)``; ``rows`` are global ``(C,)`` rows split like the
    chains (tempering's beta scales).

    Returns the tuple of shard carries and ``ys`` joined on axis 1 (chains,
    shard order) on ``mesh[0]``: the ``out_specs P(None, CHAINS_AXIS)`` of
    the JAX package's ``shard_segment_fn``.  Nothing here waits for a
    device, so each card runs its shards while the host enqueues the next
    card's.
    """
    mesh = tuple(mesh)
    if len(shards) != len(mesh):
        raise ValueError(f"{len(shards)} shards on a mesh of {len(mesh)}")
    parts = [shard_chains(torch.as_tensor(r), mesh) for r in rows]
    carries, ys = [], []
    for s, (dev, shard) in enumerate(zip(mesh, shards)):
        with on_device(dev):
            c, y = fn(shard, *(p[s] for p in parts))
        carries.append(c)
        ys.append(y)
    return tuple(carries), torch.cat([y.to(mesh[0]) for y in ys], dim=1)


def global_best_stats(best_energy, energies):
    """The only cross-chain quantities: ``(min best energy, the first chain
    holding it, mean energy as float32)``.

    Each argument is one array or tensor of chains, or a sequence of shard
    tensors (chains in shard order); each shard reduces on its own device
    and the host combines the partial results.
    """
    def shards(x):
        parts = x if isinstance(x, (list, tuple)) else [x]
        return [torch.as_tensor(s).reshape(-1) for s in parts]

    gmin, gargmin, offset = None, None, 0
    for s in shards(best_energy):
        lo = int(s.min())
        if gmin is None or lo < gmin:
            gmin, gargmin = lo, offset + int(s.argmin())
        offset += s.shape[0]
    parts = shards(energies)
    total = sum(float(s.to(torch.float64).sum()) for s in parts)
    count = sum(s.shape[0] for s in parts)
    return gmin, gargmin, np.float32(total / count)
