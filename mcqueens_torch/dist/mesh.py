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

Several processes, on one host or many: each calls :func:`init_distributed`
(a ``gloo`` group over TCP, with JAX's keyword names) with the devices it
owns, its *local* shards; :func:`make_mesh` then returns the global mesh, a
:class:`ProcessMesh` of every process's shards in rank order, whose shard
count is what :func:`pad_chains` and :func:`pad_seeds_to_blocks` see.  Each
process runs only its own shards (:mod:`mcqueens_torch.tools.check_multihost`).
The runner, tempering and the CLIs stay one-process, as in the JAX package
(whose ``device_put`` refuses another process's devices): :func:`check_mesh`
raises ``ValueError`` for a mesh that holds another process's shards.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import ipaddress
import os
import re
from typing import Callable, Sequence

import numpy as np
import torch

from mcqueens_torch.utils import profiling

CHAINS_AXIS = "chains"


class ProcessMesh(tuple):
    """A chains mesh that spans processes: every process's shards in global
    order (rank by rank), ``owners[s]`` the rank that owns shard ``s`` and
    ``rank`` this process's.  Another process's devices are labels only
    (its ``cuda:0`` may be another card)."""

    def __new__(cls, devices, owners, rank: int):
        self = super().__new__(cls, devices)
        self.owners = tuple(int(o) for o in owners)
        self.rank = int(rank)
        if len(self.owners) != len(self):
            raise ValueError(f"{len(self.owners)} owners for {len(self)} "
                             f"shards")
        return self

    def __getitem__(self, i):
        if isinstance(i, slice):
            return ProcessMesh(tuple.__getitem__(self, i), self.owners[i],
                               self.rank)
        return tuple.__getitem__(self, i)

    def local_shards(self) -> tuple[int, ...]:
        """The global indices of this process's shards, in mesh order."""
        return tuple(s for s, o in enumerate(self.owners) if o == self.rank)


@dataclasses.dataclass(frozen=True)
class _World:
    rank: int
    size: int
    local: tuple[torch.device, ...]
    mesh: ProcessMesh


_WORLD: _World | None = None  # set by init_distributed


def _coordinator_host(address: str) -> str:
    """The host of ``host:port``, both checked without a name lookup: a
    host that is all digits and dots must be an IPv4 address."""
    host, sep, port = str(address).rpartition(":")
    host = host[1:-1] if host.startswith("[") and host.endswith("]") else host
    if not sep or not host or not port.isdigit() or not 0 < int(port) < 65536:
        raise ValueError(f"coordinator address {address!r} is not host:port")
    if re.fullmatch(r"[0-9.]+", host):
        ipaddress.IPv4Address(host)  # ValueError for 256.0.0.1 and the like
    return host


def _loopback(host: str) -> bool:
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, initialization_timeout: int = 300,
                     local_devices=None) -> None:
    """Join ``num_processes`` processes in a ``gloo`` group (torch's
    ``init_process_group`` over ``tcp://coordinator_address``, rank
    ``process_id``, every wait bounded by ``initialization_timeout``
    seconds) and record the global mesh: each process's ``local_devices``
    (default: every visible card, :func:`make_mesh`), rank by rank.

    A second call in a group of the same size and rank is a no-op; one of
    another size or rank raises ``RuntimeError``.  Every other failure
    propagates (a malformed or unreachable address, a timeout, mismatched
    counts): nothing carries on as one process.  Gloo carries the little
    that crosses processes (energies, two scalars); with a loopback
    coordinator it binds the loopback interface (``GLOO_SOCKET_IFNAME=lo``
    unless set).
    """
    import torch.distributed as dist

    global _WORLD
    host = _coordinator_host(coordinator_address)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} of {num_processes} "
                         f"processes")
    if not dist.is_initialized():
        _WORLD = None  # a group left without shutdown_distributed
    else:
        have = (dist.get_world_size(), dist.get_rank())
        if have != (num_processes, process_id):
            raise RuntimeError(
                f"the process group is initialised with {have[0]} processes "
                f"as rank {have[1]}, not {num_processes} as rank "
                f"{process_id}")
        if _WORLD is not None:
            if (local_devices is not None
                    and make_mesh(local_devices) != _WORLD.local):
                raise ValueError(f"local devices {local_devices} differ "
                                 f"from the group's {_WORLD.local}")
            return
    local = make_mesh(local_devices)
    if not dist.is_initialized():
        if _loopback(host):
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=initialization_timeout))
    shards = [None] * num_processes
    dist.all_gather_object(shards, [str(d) for d in local])
    devices = [torch.device(d) for part in shards for d in part]
    owners = [r for r, part in enumerate(shards) for _ in part]
    _WORLD = _World(process_id, num_processes, local,
                    ProcessMesh(devices, owners, process_id))


def shutdown_distributed() -> None:
    """Leave the group of :func:`init_distributed` (a no-op outside one)."""
    import torch.distributed as dist

    global _WORLD
    _WORLD = None
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank (0 outside a group), as ``jax.process_index``."""
    return 0 if _WORLD is None else _WORLD.rank


def process_count() -> int:
    """Processes in the group (1 outside one), as ``jax.process_count``."""
    return 1 if _WORLD is None else _WORLD.size


def local_device_count() -> int:
    """Shards this process owns: its ``local_devices`` in a group, else the
    visible cards (1, the CPU, without CUDA)."""
    if _WORLD is not None:
        return len(_WORLD.local)
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def device_count() -> int:
    """Shards of the global mesh, every process's, as
    ``jax.device_count``."""
    return local_device_count() if _WORLD is None else len(_WORLD.mesh)


def make_mesh(devices=None) -> tuple[torch.device, ...]:
    """A 1-D chains mesh over ``devices`` (any iterable of devices or device
    strings, repeats allowed), or over every visible CUDA device; after
    :func:`init_distributed`, the global :class:`ProcessMesh`.

    Without ``devices`` and a group it needs CUDA and raises
    ``RuntimeError`` if ``torch.cuda.is_available()`` is False (there is no
    CPU fallback).  A ``cuda`` device without an index means the current
    one.  Every device must be of one type, ``cpu`` or ``cuda``.  A
    :class:`ProcessMesh` is returned as it is.
    """
    if isinstance(devices, ProcessMesh):
        return devices
    if devices is None and _WORLD is not None:
        return _WORLD.mesh
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
    sees as one device: one shard, or ``n`` shards on it.  After
    :func:`init_distributed`: the global mesh, or its first ``n`` shards,
    which :func:`check_mesh` refuses where they hold another process's.
    """
    dev = torch.device(device)
    if isinstance(shards, bool):
        n = None
    else:
        n = int(shards)
        if n < 1:
            raise ValueError(f"a mesh of {shards!r} devices")
    if _WORLD is not None:
        return _WORLD.mesh if n is None else _WORLD.mesh[:n]
    if dev.type == "cpu":
        return make_mesh([dev] * (n or 1))
    if dev.type != "cuda":
        raise ValueError(f"no mesh on {dev}")
    mesh = make_mesh()
    return mesh if n is None else mesh[:n]


def check_mesh(mesh, device) -> tuple[torch.device, ...]:
    """``mesh`` as a tuple of devices (:func:`make_mesh`); ``ValueError``
    unless their type is ``device``'s, or if it holds shards of another
    process (a run here would silently cover only this process's chains)."""
    mesh = make_mesh(mesh)
    if isinstance(mesh, ProcessMesh):
        foreign = sorted(set(mesh.owners) - {mesh.rank})
        if foreign:
            raise ValueError(
                f"the mesh holds shards of process(es) {foreign}, and this "
                f"is process {mesh.rank}: a run drives one process's "
                f"devices (mcqueens_torch.tools.check_multihost runs each "
                f"process's own shards)")
        mesh = tuple(mesh)
    dev = torch.device(device)
    if mesh[0].type != dev.type:
        raise ValueError(f"device {dev} and a mesh of {mesh[0].type} "
                         f"devices disagree")
    return mesh


def distinct(mesh) -> tuple[torch.device, ...]:
    """The mesh's devices, each once, in mesh order."""
    return tuple(dict.fromkeys(mesh))


def synchronize(devices) -> None:
    """Wait for the work queued on every CUDA device of ``devices`` (span
    ``mcq.sync``)."""
    with profiling.span("mcq.sync"):
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
    joined on axis 0 on ``device`` (default: the first shard's); span
    ``mcq.mesh.gather``."""
    first = shards[0]
    dev = first.device if device is None else torch.device(device)
    with profiling.span("mcq.mesh.gather"):
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
    card's.  Each shard's enqueue is a ``mcq.mesh.shard`` span, the join of
    ``ys`` a ``mcq.mesh.gather``.
    """
    mesh = tuple(mesh)
    if len(shards) != len(mesh):
        raise ValueError(f"{len(shards)} shards on a mesh of {len(mesh)}")
    parts = [shard_chains(torch.as_tensor(r), mesh) for r in rows]
    carries, ys = [], []
    for s, (dev, shard) in enumerate(zip(mesh, shards)):
        with profiling.span("mcq.mesh.shard"), on_device(dev):
            c, y = fn(shard, *(p[s] for p in parts))
        carries.append(c)
        ys.append(y)
    with profiling.span("mcq.mesh.gather"):
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
