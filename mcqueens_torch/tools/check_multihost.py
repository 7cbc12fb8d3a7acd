#!/usr/bin/env python
"""Several processes, one chain batch: the multi-process path, exercised
(PyTorch port of ``python -m tools.check_multihost``).

Each process joins a ``gloo`` group (:func:`mcqueens_torch.dist.mesh.init_distributed`)
with the shards it owns, and the global mesh has every process's shards in
rank order.  Every process builds the threefry keys of all the chains from
the seeds, padded (follow-on seeds) to a multiple of the global shard
count, and runs only its own shards: the board ``tables`` scan
(``chain/board.py``; ``csrc/board_scan.cu`` on the card, its plain twin on
the CPU), one segment of ``--n-steps`` steps.  It then all-gathers the final
energies in global shard order, drops the padding, and all-reduces their
min and sum (int64).  Each chain's stream is keyed by its seed, not by where
it runs, so the result equals a one-process ``run_chains`` of the same seeds
bitwise (``tests/test_torch_multihost.py``).

Each process writes one JSON: the JAX tool's keys (``process_id``,
``n_devices``, ``n_local_devices``, ``n_processes``, ``final_energy``,
``min_energy``, ``sum_energy``) and ``kernel_launches``, ``devices`` and
``seconds`` (start-up from the process's start: the interpreter and
imports, the group, the CUDA context, the library load; each shard's init
and scan, and on the card its segment's CUDA-event time; the gather and
reduce).

Two processes on the CPU, four shards each (two shells)::

    python -m mcqueens_torch.tools.check_multihost --device cpu \\
        --local-shards 4 --coordinator localhost:9911 --num-processes 2 \\
        --process-id 0 --out /tmp/mh0.json

On one card, two shards of it a process: ``--local-shards 2``; on several,
each process its own cards: ``--devices cuda:0,cuda:1``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

_T0 = time.perf_counter()


def _origin() -> float:
    """The ``perf_counter`` time this process started at (from ``/proc``
    on Linux; elsewhere, when this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rpartition(")")[2].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return _T0
    return time.perf_counter() - (uptime - start / os.sysconf("SC_CLK_TCK"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--coordinator", required=True,
                        help="host:port of process 0's TCP store")
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--n", type=int, default=5)
    parser.add_argument("--n-steps", type=int, default=500)
    parser.add_argument("--n-chains", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the CUDA kernel) or cpu (its twin)")
    where = parser.add_mutually_exclusive_group()
    where.add_argument("--local-shards", type=int, default=1, metavar="K",
                       help="this process's shards: K shards of --device")
    where.add_argument("--devices", default=None,
                       help="this process's shards, one a device: "
                            "cuda:0,cuda:1")
    parser.add_argument("--timeout", type=int, default=300,
                        help="seconds any process may wait for the others")
    args = parser.parse_args(argv)
    if args.local_shards < 1:
        parser.error("--local-shards must be at least 1")

    import numpy as np
    import torch
    import torch.distributed as dist

    from mcqueens_torch.chain import board
    from mcqueens_torch.chain.spec import ChainSpec
    from mcqueens_torch.core import rng as rng_mod
    from mcqueens_torch.core.schedules import build_schedule
    from mcqueens_torch.dist import mesh as mesh_mod
    from mcqueens_torch.kernels import _build
    from mcqueens_torch.tools import device as checked_device

    origin = _origin()
    seconds = {"import": time.perf_counter() - origin}
    if args.devices is not None:
        local = [torch.device(d) for d in args.devices.split(",")]
    else:
        local = [checked_device(args.device)] * args.local_shards
    for d in local:
        checked_device(d)
    if {d.type for d in local} != {torch.device(args.device).type}:
        parser.error(f"--devices {args.devices} are not of --device "
                     f"{args.device}")

    t = time.perf_counter()
    mesh_mod.init_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        initialization_timeout=args.timeout,
        local_devices=local,
    )
    seconds["init_distributed"] = time.perf_counter() - t
    try:
        rank = mesh_mod.process_index()
        if mesh_mod.process_count() != args.num_processes:
            raise AssertionError(mesh_mod.process_count())
        mesh = mesh_mod.make_mesh()
        cuda = local[0].type == "cuda"
        if cuda:
            t = time.perf_counter()
            for d in mesh_mod.distinct(local):
                torch.zeros(1, device=d).cpu()
            seconds["cuda_context"] = time.perf_counter() - t
            # Rank 0 builds the library of a fresh checkout; the others
            # load it after the barrier (a build replaces it atomically).
            t = time.perf_counter()
            if rank == 0:
                _build.load_library()
            dist.barrier()
            _build.load_library()
            seconds["library_load"] = time.perf_counter() - t
        seconds["startup"] = time.perf_counter() - origin

        spec = ChainSpec(
            N=args.n,
            n_steps=args.n_steps,
            schedule=build_schedule("linear_annealing", args.n_steps,
                                    beta_start=0.5, beta_end=3.0),
            init_mode="random",
            mcmc_type="board",
            kernel="tables",
            history_stride=args.n_steps,
        )
        seeds = np.arange(args.n_chains, dtype=np.uint32)
        n_padded = mesh_mod.pad_chains(args.n_chains, mesh)
        if n_padded > args.n_chains:
            seeds = np.concatenate([seeds, seeds[-1] + 1 + np.arange(
                n_padded - args.n_chains, dtype=np.uint32)])
        keys = rng_mod.chain_keys_from_seeds(seeds, "cpu")
        per = n_padded // len(mesh)
        mine = mesh.local_shards()
        launches0 = board.KERNEL_LAUNCHES
        energies, shard_s, shard_ms = [], [], []
        for s in mine:
            dev = mesh[s]
            t = time.perf_counter()
            with mesh_mod.on_device(dev):
                carry = board.init_carry_batch(
                    keys[s * per:(s + 1) * per].to(dev), spec, device=dev)
                if cuda:
                    events = [torch.cuda.Event(enable_timing=True)
                              for _ in range(2)]
                    events[0].record()
                carry, _ = board.run_segment(carry, 0, spec, 1)
                if cuda:
                    events[1].record()
                energies.append(carry.energy.reshape(-1).cpu())
            shard_s.append(time.perf_counter() - t)
            if cuda:
                shard_ms.append(events[0].elapsed_time(events[1]))
        seconds["shards"] = shard_s
        # The card's time in each shard's segment (CUDA events; the first
        # also holds the process's first load of the kernel).
        seconds["shard_segment_ms"] = shard_ms

        # Global shard order: rank by rank, each rank's shards in mesh
        # order; a buffer as long as the largest rank's share.
        t = time.perf_counter()
        counts = [mesh.owners.count(r) for r in range(args.num_processes)]
        buf = torch.zeros(max(counts) * per, dtype=torch.int32)
        if mine:
            buf[:len(mine) * per] = torch.cat(energies)
        parts = [torch.empty_like(buf) for _ in range(args.num_processes)]
        dist.all_gather(parts, buf)
        energy = torch.cat([p[:c * per] for p, c in zip(parts, counts)])
        energy = energy[:args.n_chains]
        seconds["gather"] = time.perf_counter() - t

        t = time.perf_counter()
        own = [e[:max(0, min(per, args.n_chains - s * per))]
               for s, e in zip(mine, energies)]
        real = torch.cat(own + [torch.zeros(0, dtype=torch.int32)]).to(
            torch.int64)
        emin = torch.tensor(int(real.min()) if real.numel()
                            else torch.iinfo(torch.int64).max)
        esum = real.sum()
        dist.all_reduce(emin, op=dist.ReduceOp.MIN)
        dist.all_reduce(esum, op=dist.ReduceOp.SUM)
        seconds["reduce"] = time.perf_counter() - t
        seconds["wall"] = time.perf_counter() - origin
        out = {
            "process_id": args.process_id,
            "n_devices": mesh_mod.device_count(),
            "n_local_devices": mesh_mod.local_device_count(),
            "n_processes": mesh_mod.process_count(),
            "final_energy": energy.tolist(),
            "min_energy": int(emin),
            "sum_energy": int(esum),
            "devices": [str(d) for d in local],
            "kernel_launches": board.KERNEL_LAUNCHES - launches0,
            "seconds": seconds,
        }
    finally:
        mesh_mod.shutdown_distributed()
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"[check_multihost] process {args.process_id}: OK {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
