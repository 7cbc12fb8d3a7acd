#!/usr/bin/env python3
"""Time the scan samplers, the shared-site board sampler and the slice copy
of one checkout of the port on one CUDA GPU, so that two commits can be
compared in one run:

    python3 pair_scan_slice.py --root DIR [--label NAME] [--json PATH]

``DIR`` is the root of a checkout: its ``mcqueens_torch`` is imported and
its kernels are built under ``DIR/build``.  To compare a commit with its
parent, unpack the parent with ``git archive`` into a git-ignored directory
and run parent, change, change, parent in one session on one card.  Only
public functions that both sides have are called.  Phases:

  * ``config.yaml`` as committed (compare_beta_end: N 12 and 18, 10 runs,
    1M steps, stride 1, kernel tables) through
    ``drivers.run_from_config(plot=False)``: wall time, after one tiny run
    that loads the kernel;
  * ``config.yaml``'s beta_start_end_pairs section (N=12, three linear
    pairs, 10 runs, 1M steps, stride 1, kernel tables) as full_3d (Q=144)
    through ``drivers.run_beta_start_end_pairs(plot=False)``: wall time;
  * each scan kernel alone at those configurations' launch shape (10
    chains, stride 1, 100000 steps from step 0; board N=12 and 18, full-3D
    N=12, Q=144 with the first pair's schedule): microseconds per step;
  * each scan kernel alone at 4096 chains, tables and naive, one 16384-step
    chunk after a first one (board N=16, linear 1->5 over 2^24 steps;
    full-3D N=12, Q=144, linear 0.5->3 over 1M steps): proposed moves/s;
  * the shared-site board kernel (``kernels/board_shared.py``) alone, each
    launch on a fresh state behind a spin kernel, three times, after one
    untimed launch of the same shape: the main-path chunk (N=16, 32768
    chains, 48 steps from step 0, linear 1->3 over 50000 steps), the
    tempered chunk (the same at beta 1 with a 16-rung ladder 1->3) and the
    freeze chunk (horizons inside chunk 10, track_best off): ms;
  * the same kernel at ``bench.py``'s configuration (N=16, linear 1->5
    over 2^24 steps, the second 32768-step chunk) at 32768 and 4096 chains:
    ms and proposed moves/s;
  * the board competition CLI (N=16, 32768 runs, 50000 steps, kernel
    pallas_shared), plain and with a 16-level ladder (``--tempering 16``),
    and the recover slice at that configuration (``run_segment`` with
    track_best on, off, then ``recover_best_heights``): wall time, and the
    moves/s each CLI reports;
  * the tempered search's round at the tempered CLI's size (N=16, 32768
    chains, 48-step rounds, a 16-rung ladder 1->3): ``run_tempered`` over
    200 rounds (init included) per round, and each piece of a round timed
    alone, synchronised, 50 times: ``segment_state``, the kernel's launch,
    ``carry_of``, ``chunk_betas``, the exchange and the energies' copy to
    the host: ms;
  * the slice copy (``kernels/probes_mem.py``) at the slice tool's
    card-filling shape, (256, 67584) int32, 16 rows at row 240 (load) and
    48 (store), beside ``torch.narrow_copy`` and ``Tensor.index_fill``,
    each timed behind a spin kernel so that no launch waits for the host;
  * the shared-site full-3D kernel (``kernels/full3d_shared.py``) alone,
    each launch on a fresh state behind a spin kernel, three times after
    one untimed launch: the floors launch (N=15, Q=225, 65536 chains, 44
    steps from step 0 at beta 1 with a 16-rung ladder 0.8->7) and the Q_max
    launch (N=8, Q=48, 4096 chains, 4096 steps from step 0, linear 0.5->5
    over 2^18 steps): ms; and the campaign chunk (N=15, Q=225, linear
    0.8->7 over 8M steps, the second 62500-step chunk) at 65536 and 4096
    chains: ms and proposed moves/s;
  * the full-3D floors search (the competition CLI: N=15, 65536 runs,
    125000 steps, stride 62500, a 16-level ladder 0.8->7, seed 31337) and
    the Q_max search (``runner.run_chains``: N=8, Q=48, 4096 chains, 2^18
    steps, stride 4096): wall time.

  * the per-chain board kernel (``kernels/metropolis_pallas.py``) alone,
    each launch on a fresh state behind a spin kernel, three times after
    one untimed launch: the pod-scale launch (N=20, 4096 chains, the second
    16384-step chunk of linear 1->5 over 5M), the beyond-reference launch
    (128 chains, 62500 steps from step 0, linear 1->5.5 over 8M) at N=16
    and N=32, and the bench chunk (N=16, linear 1->5 over 2^24 steps, the
    second 32768-step chunk) at 32768 and 4096 chains: ms; where the module
    has a layout rule (``metropolis_pallas.layout``), the same launches at
    each team size, one launch each: ms;
  * ``configs/pod_scale.yaml``'s run (``runner.run_experiment``: N=20,
    4096 runs, cut to 2^19 steps, stride 16384, kernel pallas) and
    ``configs/beyond_reference.yaml``'s sweep
    (``drivers.measure_min_energy_vs_n``: 10 N, random and klarner, 128
    runs, cut to 62500 steps), as ``chip_smoke.py`` runs them: wall time.

  * the per-chain full-3D kernel (``kernels/full3d_pallas.py``) alone,
    each launch on a fresh state behind a spin kernel, three times after
    one untimed launch: the beta pairs' launch (N=12, Q=144, 4096 chains,
    16384 steps of linear 0.5->3 over 2^17, seed 42) from step 0 and from
    step 65536, the N=15 chunk (Q=225, linear 0.8->7 over 8M, the second
    8192-step chunk) at 65536 and 4096 chains, and the compare shape
    (N=12, Q=144, 4096 chains, 256 steps from step 0): ms; where the module
    has a layout rule (``full3d_pallas.layout``), the same launches at each
    team size, one launch each, and the rule's layout: ms; the compiler's
    registers and spills of each of its instances;
  * ``config.yaml``'s beta_start_end_pairs section as full_3d with kernel
    pallas (N=12, 4096 runs, 2^17 steps, stride 16384), as ``chip_smoke.py``
    runs it: wall time, twice.

  * (``--only probes``, never run by default) kernel A
    (``kernels/probes.py:vpu_doubling``) and the reduce
    (``kernels/probes_mem.py:sublane_reduce``) alone through their
    launchers, each launch behind a spin kernel, three times after one
    untimed launch, each launch's words equal to the plain twin's (so
    parent and change give the same words): kernel A at the roofline's
    timing shape ((8, 135168) ones, 8 chains x 2048 x 16 doublings) and the
    pass cost's ((8, 135168) ones, one chain of 8192 doublings), the reduce
    at the slice tool's card-filling shape ((64, 1081344) ones, 512 steps):
    ms, with a digest of the words; the PRNG draws (``prng_draws``) at the
    slice tool's timing shape ((8, 135168), 512 draws) in both generators
    and the gather chain (``gather_chain``) at the gather tool's shapes
    ((4224, 256) axis 1 and (256, 135168) axis 0, 512 steps and none, a
    random index from a seeded generator), the same way; a digest of the scan samplers'
    SASS (``chip_smoke.scan_sass_digest``), which include ``threefry.cuh``;
    and ``mcqueens_torch.tools.roofline``, ``probe_gather`` and
    ``probe_slice`` ``--quick`` as wall time, with the roofline's int32 add
    rate and the slice tool's reduce and draw costs.

``--only board_shared`` (never run by default) times the shared-site
board kernel alone, each launch on a fresh state behind a spin kernel,
three times after one untimed launch: the main-path, tempered and freeze
chunks above, the bench chunk at 32768 and 4096 chains, the anneal cell's
launch (N=16, 1024 steps of linear 1->5 over 2^20) after 1 and 900
chunks at 32768 chains and after 1 at 4096, and the same launch at N=14
and N=32 (4096 chains): ms; the 4096-chain launch at each team size the
rule may give; the anneal cell's 1024 launches back to back from step 0 at
32768 chains (the betas made beforehand): ms, with the launches counted
and the mean best energy; and each instance's SASS loop mix by pipe and
registers.  ``--only full3d`` runs the full-3D shared kernel's items
alone, ``--only metropolis`` the per-chain board kernel's, ``--only full3d_pallas`` the
per-chain full-3D kernel's.  ``--only full3d_pallas_variants`` (never run
by default) builds the variants of ``csrc/full3d_pallas.cu`` in
:data:`F3P_VARIANTS` beside the committed source, each into a library of
its own under ``DIR/build``, and times each at the rule's layout of the
launches above, after one untimed launch of each, in the order committed,
variants, variants reversed, committed; each launch's every field must
equal the committed kernel's.
It also prints each build's registers and spills, and the SASS opcodes of
each instance's pass (its largest innermost loop, one LDS a queen row) by
the pipe they issue on.  ``--only vpu_variants`` (never run by default)
builds the variants of kernel A's ``csrc/probe_alu.cu`` in
:data:`VPU_VARIANTS` the same way and times each at the roofline's two
launches and the pass cost's, in the order committed, variants, variants
reversed, committed, each launch's words equal to the committed kernel's
(and on random words under 32 doublings), with each instance's hot-loop
opcodes.  ``--only prng_variants`` and ``--only gather_variants`` (never
run by default) do the same for the threefry draws
(``csrc/probe_slice.cu``, :data:`PRNG_VARIANTS`: each round's pipe, the
words a thread) at the slice tool's timing shape and for the gather chain
(``csrc/probe_gather.cu``, :data:`GATHER_VARIANTS`: the tile's size, no
layout, no schedule; and at 0 steps :data:`GATHER_PROLOGUE_VARIANTS`, the
prologue's parts) at the gather tool's axis-1 shape, each launch's words
equal to the committed kernel's, with each instance's hot-loop opcodes by
pipe.  ``--only sass`` (never run by default) prints the SASS digest of
each instance of the full-3D shared kernel at hold 8 in the checkout's
build (:func:`full3d_sass_digests`; a checkout from before the hold was a
template parameter has only those), so two checkouts' hold-8 kernels can
be held to each other.  ``--only mesh`` (never run by default) runs the
checkout's ``chip_smoke.py`` mesh phase alone, after the pod-scale slice it
compares with (``pod_scale_slice``, ``mesh_slice``), over every visible
card: each path unsharded, on 2 and 4 shards of ``cuda:0`` and, with more
than one card, over all of them, walls and each card's busy time printed
(on a host of several cards, the mesh over distinct cards).  Prints one
JSON line
with the card's name and power limit; exits non-zero without a CUDA GPU.
"""

import argparse
import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time


def full3d_phases():
    """The shared-site full-3D kernel's phases (module docstring)."""
    import numpy as np
    import torch

    from mcqueens_torch.chain.spec import ChainSpec
    from mcqueens_torch.cli import competition
    from mcqueens_torch.core.schedules import build_schedule, chunk_betas
    from mcqueens_torch.dist import runner
    from mcqueens_torch.kernels import full3d_shared
    from mcqueens_torch.search.tempering import geometric_ladder

    def spec_of(N, n_steps, stride, schedule, **kw):
        return ChainSpec(N=N, n_steps=n_steps, schedule=schedule,
                         kernel="pallas_shared", history_stride=stride,
                         mcmc_type="full_3d", **kw)

    def events_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(5_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def state(spec, chains, seed0, ladder=None, chunks=0):
        carry = full3d_shared.init_carry_batch(
            seed0 + np.arange(chains, dtype=np.uint32), spec, device="cuda")
        if chunks:
            carry, _ = full3d_shared.run_segment(carry, 0, spec, chunks)
        st = full3d_shared.segment_state(carry)
        scale = ()
        if ladder is not None:
            C = st.energy.shape[0]
            scale = (torch.from_numpy(np.tile(ladder, -(-C // 16))[:C]
                                      .copy()).cuda(),)
        return st, scale

    def launch_ms(spec, chains, seed0, ladder=None, reps=3, chunks=0):
        step0, n = chunks * spec.history_stride, spec.history_stride
        beta = chunk_betas(spec.schedule, step0, n, "cuda")
        times = []
        for rep in range(reps + 1):  # the first loads the kernel: not kept
            st, scale = state(spec, chains, seed0, ladder, chunks)
            ms = events_ms(lambda: full3d_shared.segment_cuda(
                st, step0, n, spec, beta, *scale))
            if rep:
                times.append(ms)
        return times

    const = build_schedule("constant", 125000, beta_const=1.0)
    lin = lambda n, b0, b1: build_schedule(  # noqa: E731
        "linear_annealing", n, beta_start=b0, beta_end=b1)
    ladder = geometric_ladder(0.8, 7.0, 16)
    out = {"full3d_shared_launch_ms": {
        "floors": launch_ms(spec_of(15, 125000, 44, const), 65536, 31337,
                            ladder),
        "qmax": launch_ms(spec_of(8, 1 << 18, 4096, lin(1 << 18, 0.5, 5.0),
                                  Q=48), 4096, 0),
    }}
    camp = spec_of(15, 8_000_000, 62500, lin(8_000_000, 0.8, 7.0))
    out["full3d_shared_campaign_chunk"] = {}
    for chains in (65536, 4096):
        (ms,) = launch_ms(camp, chains, 0, reps=1, chunks=1)
        out["full3d_shared_campaign_chunk"][f"C={chains}"] = {
            "ms": ms, "moves_per_s": 62500 * chains / ms * 1e3}

    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            competition.main([
                "--n", "15", "--mcmc-type", "full_3d", "--n-runs", "65536",
                "--kernel", "pallas_shared", "--tempering", "16",
                "--history-stride", "62500", "--n-steps", "125000",
                "--beta-start", "0.8", "--beta-end", "7", "--seed", "31337",
                "--device", "cuda", "--outdir", d])
        torch.cuda.synchronize()
        out["full3d_floors_search_s"] = time.perf_counter() - t0
    qspec = spec_of(8, 1 << 18, 4096, lin(1 << 18, 0.5, 5.0), Q=48)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = runner.run_chains(np.arange(4096, dtype=np.uint32), qspec,
                            device="cuda")
    torch.cuda.synchronize()
    out["qmax_search_s"] = time.perf_counter() - t0
    out["qmax_best_energy"] = int(np.min(res.best_energy))
    return out


def board_shared_sass(so):
    """``{instance: {loop: {pipe: instructions}}}`` of each instance of
    ``board_shared_kernel<L, SMEM>`` in the library ``so``
    (``cuobjdump -sass``): its largest innermost loop (``inner``, the cells
    of one offset or one word of a row) and the smallest loop around it
    (``step``, one step of the walk, counting ``inner`` once); pipes as
    ``chip_smoke.pipe_mix`` puts them (IMAD and float arithmetic FMA,
    shared memory and shuffles MIO, branches, barriers, loads, stores and
    the uniform datapath apart, the rest ALU)."""
    import collections

    from torch.utils.cpp_extension import CUDA_HOME

    text = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(so)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = re.search(r"19board_shared_kernelILi(\d+)ELb([01])E", line)
            cur = (f"L={m.group(1)} {'shared' if m.group(2) == '1' else 'device'}"
                   if m else None)
            if cur:
                funcs[cur] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m and cur:
            funcs[cur].append((int(m.group(1), 16), m.group(2), m.group(3)))

    def mix(ins, lo, hi):
        pipes = collections.Counter()
        for a, op, _ in ins:
            if lo <= a <= hi:
                pipes["FMA" if op.startswith(("IMAD", "FFMA", "FADD", "FMUL"))
                      else "MIO" if op.startswith(("LDS", "STS", "SHFL"))
                      else "other" if op.startswith((
                          "BRA", "EXIT", "NOP", "BSSY", "BSYNC", "BAR",
                          "WARPSYNC", "LD", "ST", "S2R", "CS2R", "U"))
                      else "ALU"] += 1
        return dict(sorted(pipes.items()))

    out = {}
    for key, ins in sorted(funcs.items()):
        loops = []
        for addr, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) <= addr:
                loops.append((int(t.group(1), 16), addr))
        inner = max((lp for lp in loops if not any(
            o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)),
            key=lambda lp: lp[1] - lp[0])
        lo, hi = min((lp for lp in loops if lp[0] <= inner[0]
                      and inner[1] <= lp[1] and lp != inner),
                     key=lambda lp: lp[1] - lp[0], default=inner)
        out[key] = {"inner": mix(ins, *inner), "step": mix(ins, lo, hi),
                    "opcodes": dict(collections.Counter(
                        op.split(".")[0] for a, op, _ in ins
                        if lo <= a <= hi).most_common())}
    return out


def board_shared_phases():
    """The shared-site board kernel's phases (module docstring)."""
    import numpy as np
    import torch

    from mcqueens_torch.chain.spec import ChainSpec
    from mcqueens_torch.core.schedules import build_schedule, chunk_betas
    from mcqueens_torch.kernels import _build
    from mcqueens_torch.kernels import board_shared as bs
    from mcqueens_torch.search.tempering import geometric_ladder

    def spec_of(N, n_steps, stride, b0, b1, sched="linear_annealing"):
        kw = (dict(beta_start=b0, beta_end=b1) if sched == "linear_annealing"
              else dict(beta_const=b0))
        return ChainSpec(N=N, n_steps=n_steps, history_stride=stride,
                         kernel="pallas_shared",
                         schedule=build_schedule(sched, n_steps, **kw))

    def events_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(5_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    main = spec_of(16, 50000, 48, 1.0, 3.0)
    flat = spec_of(16, 50000, 48, 1.0, None, "constant")
    bench = spec_of(16, 2 ** 24, 32768, 1.0, 5.0)
    cell = spec_of(16, 2 ** 20, 1024, 1.0, 5.0)
    ladder = geometric_ladder(1.0, 3.0, 16)
    # name -> (spec, chains, chunks run before the timed one, seed0, mode)
    launches = {
        "main_path_C32768": (main, 32768, 0, 42, "main"),
        "tempered_C32768": (flat, 32768, 0, 42, "tempered"),
        "freeze_C32768": (main, 32768, 10, 42, "freeze"),
        "bench_chunk_C32768": (bench, 32768, 1, 0, "main"),
        "bench_chunk_C4096": (bench, 4096, 1, 0, "main"),
        "anneal_launch_C32768_chunk1": (cell, 32768, 1, 7, "main"),
        "anneal_launch_C32768_chunk900": (cell, 32768, 900, 7, "main"),
        "anneal_launch_C4096_chunk1": (cell, 4096, 1, 7, "main"),
        "N14_C4096_chunk1": (spec_of(14, 2 ** 20, 1024, 1.0, 5.0), 4096, 1,
                             7, "main"),
        "N32_C4096_chunk1": (spec_of(32, 2 ** 20, 1024, 1.0, 5.0), 4096, 1,
                             7, "main"),
    }

    def launch_ms(spec, chains, chunks, seed0, mode, reps, forced=None):
        carry = bs.init_carry_batch(seed0 + np.arange(chains, dtype=np.uint32),
                                    spec, device="cuda")
        if chunks:
            carry, _ = bs.run_segment(carry, 0, spec, chunks)
        step0, n = chunks * spec.history_stride, spec.history_stride
        beta = chunk_betas(spec.schedule, step0, n, "cuda")
        C = carry.energy.shape[0]
        args, kw = (), {}
        if mode == "tempered":
            args = (torch.from_numpy(np.tile(ladder, -(-C // 16))[:C]
                                     .copy()).cuda(),)
        if mode == "freeze":
            kw = dict(freeze=torch.as_tensor(np.random.default_rng(7).integers(
                step0, step0 + n, C), dtype=torch.int32, device="cuda"),
                track_best=False)
        if forced is not None:
            kw["forced"] = forced
        times = []
        for rep in range(reps + 1):  # the first loads the kernel: not kept
            st = bs.segment_state(carry)
            ms = events_ms(lambda: bs.segment_cuda(st, step0, n, spec, beta,
                                                   *args, **kw))
            if rep:
                times.append(ms)
        return times

    out = {"board_shared_launch_ms": {
        key: launch_ms(*args, reps=3) for key, args in launches.items()}}
    out["board_shared_layouts"] = {
        key: str(bs.layout(spec.N, chains, n_sm, mode != "freeze"))
        for key, (spec, chains, _, _, mode) in launches.items()}
    # The team sizes the rule may give, forced at 4096 chains (N=16).
    out["board_shared_C4096_by_lanes_ms"] = {}
    for lanes in (2, 4, 8):
        cpb = 32 * 8 // lanes if lanes < 8 else 32
        forced = bs.Layout(lanes, cpb, bs.cta_smem_bytes(16, cpb, True))
        out["board_shared_C4096_by_lanes_ms"][f"L={lanes} cpb={cpb}"] = (
            launch_ms(cell, 4096, 1, 7, "main", reps=1, forced=forced))
    # The anneal cell's search on the card alone: 1024 launches of 1024
    # steps at 32768 chains from step 0, the betas made beforehand.
    carry = bs.init_carry_batch(7 + np.arange(32768, dtype=np.uint32), cell,
                                device="cuda")
    st = bs.segment_state(carry)
    betas = [chunk_betas(cell.schedule, o * 1024, 1024, "cuda")
             for o in range(cell.n_outer)]
    launches0, packed0 = bs.KERNEL_LAUNCHES, getattr(bs, "PACKED_LAUNCHES", 0)

    def search():
        for o, beta in enumerate(betas):
            bs.segment_cuda(st, o * 1024, 1024, cell, beta)

    out["board_shared_anneal_search_kernels_ms"] = events_ms(search)
    out["board_shared_anneal_search_launches"] = [
        bs.KERNEL_LAUNCHES - launches0,
        getattr(bs, "PACKED_LAUNCHES", 0) - packed0]
    out["board_shared_anneal_search_mean_best"] = float(
        st.best_energy.float().mean())
    out["board_shared_sass"] = board_shared_sass(_build.library_path())
    if _build.library_path().with_suffix(".log").exists():
        out["board_shared_registers"] = {
            entry: use for entry, use in _build.ptxas_usage().items()
            if "board_shared_kernel" in entry}
    return out


def metropolis_phases():
    """The per-chain board kernel's phases (module docstring)."""
    import numpy as np
    import torch

    from mcqueens_torch.chain.spec import ChainSpec
    from mcqueens_torch.core.schedules import build_schedule, chunk_betas
    from mcqueens_torch.dist import runner
    from mcqueens_torch.experiments import drivers
    from mcqueens_torch.kernels import metropolis_pallas as mp

    def spec_of(N, n_steps, stride, b1):
        return ChainSpec(N=N, n_steps=n_steps, history_stride=stride,
                         kernel="pallas", schedule=build_schedule(
                             "linear_annealing", n_steps, beta_start=1.0,
                             beta_end=b1))

    def events_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(5_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    launches = {
        "pod_scale_N20_C4096": (spec_of(20, 5_000_000, 16384, 5.0), 4096, 1,
                                42),
        "beyond_reference_N16_C128": (spec_of(16, 8_000_000, 62500, 5.5),
                                      128, 0, 4242),
        "beyond_reference_N32_C128": (spec_of(32, 8_000_000, 62500, 5.5),
                                      128, 0, 4242),
        "bench_chunk_C32768": (spec_of(16, 2 ** 24, 32768, 5.0), 32768, 1,
                               0),
        "bench_chunk_C4096": (spec_of(16, 2 ** 24, 32768, 5.0), 4096, 1, 0),
    }

    def launch_ms(spec, chains, chunks, seed0, reps, **kw):
        carry = mp.init_carry_batch(seed0 + np.arange(chains, dtype=np.uint32),
                                    spec, device="cuda")
        if chunks:
            carry, _ = mp.run_segment(carry, 0, spec, chunks)
        step0, n = chunks * spec.history_stride, spec.history_stride
        beta = chunk_betas(spec.schedule, step0, n, "cuda")
        times = []
        for rep in range(reps + 1):  # the first loads the kernel: not kept
            st = mp.segment_state(carry)
            ms = events_ms(lambda: mp.segment_cuda(st, step0, n, spec, beta,
                                                   **kw))
            if rep:
                times.append(ms)
        return times

    out = {"metropolis_launch_ms": {
        key: launch_ms(*args, reps=3) for key, args in launches.items()}}
    if hasattr(mp, "layout"):
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        out["metropolis_layouts"] = {
            key: {"rule": str(mp.layout(spec.N, chains, n_sm)), **{
                f"L={L}": launch_ms(spec, chains, chunks, seed0, reps=1,
                                    forced=mp.layout(spec.N, chains, n_sm,
                                                     L))[0]
                for L in mp.LANES}}
            for key, (spec, chains, chunks, seed0) in launches.items()}

    # configs/pod_scale.yaml, cut to 2^19 steps (chip_smoke.py:
    # pod_scale_slice), and configs/beyond_reference.yaml cut to 62500 steps
    # (chip_smoke.py: beyond_reference_slice).
    n_steps = 1 << 19
    sched = build_schedule("linear_annealing", n_steps, beta_start=1.0,
                           beta_end=5.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        runner.run_experiment(
            N=20, n_steps=n_steps, init_mode="random", schedule=sched,
            n_runs=4096, base_seed=42, device="cuda", mcmc_type="board",
            early_stop_patience=None, verbose=True, history_stride=16384,
            kernel="pallas", n_bins=100)
    torch.cuda.synchronize()
    out["pod_scale_slice_s"] = time.perf_counter() - t0

    from mcqueens_torch.experiments.config import parse_config

    n_steps = 62500
    cfg = parse_config({
        "experiment_type": "measure_min_energy_vs_N",
        "common": {"n_steps": n_steps, "n_runs": 128, "verbose": False,
                   "initialization": "random", "mcmc_type": "board",
                   "early_stop_patience": "None",
                   "betta_scheduling": {"type": "linear_annealing",
                                        "base_seed": 4242, "beta_start": 1.0,
                                        "beta_end": 5.5},
                   "output_path": "min_energy_vs_N_beyond_reference.png"},
        "measure_min_energy_vs_N": {
            "Ns": [16, 17, 19, 20, 23, 24, 28, 29, 31, 32],
            "init_modes": ["random", "klarner"]},
        "tpu": {"kernel": "pallas", "history_stride": 62500}})
    params = cfg.section("measure_min_energy_vs_N")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = drivers.measure_min_energy_vs_n(
        Ns=params["Ns"], n_steps=n_steps, schedule=build_schedule(
            "linear_annealing", n_steps, beta_start=1.0, beta_end=5.5),
        init_modes=params["init_modes"], n_runs=cfg.n_runs, base_seed=4242,
        verbose=False, plot=False, mcmc_type=cfg.mcmc_type,
        early_stop_patience=cfg.early_stop_patience, tpu=cfg.tpu,
        device="cuda")
    torch.cuda.synchronize()
    out["beyond_reference_slice_s"] = time.perf_counter() - t0
    out["beyond_reference_random_mean_best"] = [
        float(x) for x in res["results"]["random"]["mean_min_energies"]]
    return out


def full3d_pallas_phases():
    """The per-chain full-3D kernel's phases (module docstring)."""
    import numpy as np
    import torch

    from mcqueens_torch.chain.spec import ChainSpec
    from mcqueens_torch.core.schedules import build_schedule, chunk_betas
    from mcqueens_torch.experiments import drivers
    from mcqueens_torch.experiments.config import parse_config
    from mcqueens_torch.kernels import _build
    from mcqueens_torch.kernels import full3d_pallas as fp

    def spec_of(N, n_steps, stride, b0, b1):
        return ChainSpec(N=N, n_steps=n_steps, history_stride=stride,
                         kernel="pallas", mcmc_type="full_3d",
                         schedule=build_schedule(
                             "linear_annealing", n_steps, beta_start=b0,
                             beta_end=b1))

    def events_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(5_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    pairs = spec_of(12, 1 << 17, 16384, 0.5, 3.0)
    n15 = spec_of(15, 8_000_000, 8192, 0.8, 7.0)
    # name -> (spec, chains, chunks run before the timed one, seed0)
    launches = {
        "pairs_launch_from_0": (pairs, 4096, 0, 42),
        "pairs_launch_from_65536": (pairs, 4096, 4, 42),
        "n15_chunk_C65536": (n15, 65536, 1, 0),
        "n15_chunk_C4096": (n15, 4096, 1, 0),
        "compare_shape_N12_C4096_256": (spec_of(12, 1 << 17, 256, 0.5, 3.0),
                                        4096, 0, 42),
    }

    def launch_ms(spec, chains, chunks, seed0, reps, **kw):
        carry = fp.init_carry_batch(seed0 + np.arange(chains, dtype=np.uint32),
                                    spec, device="cuda")
        if chunks:
            carry, _ = fp.run_segment(carry, 0, spec, chunks)
        step0, n = chunks * spec.history_stride, spec.history_stride
        beta = chunk_betas(spec.schedule, step0, n, "cuda")
        times = []
        for rep in range(reps + 1):  # the first loads the kernel: not kept
            st = fp.segment_state(carry)
            ms = events_ms(lambda: fp.segment_cuda(st, step0, n, spec, beta,
                                                   **kw))
            if rep:
                times.append(ms)
        return times

    out = {"full3d_pallas_launch_ms": {
        key: launch_ms(*args, reps=3) for key, args in launches.items()}}
    if hasattr(fp, "layout"):
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        out["full3d_pallas_layouts"] = {
            key: {"rule": str(fp.layout(spec.N, spec.q_eff, chains, n_sm)),
                  **{f"L={L}": launch_ms(
                      spec, chains, chunks, seed0, reps=1,
                      forced=fp.layout(spec.N, spec.q_eff, chains, n_sm,
                                       L))[0]
                     for L in fp.LANES}}
            for key, (spec, chains, chunks, seed0) in launches.items()}
    log = _build.library_path().with_suffix(".log").read_text().splitlines()
    out["full3d_pallas_ptxas"] = [
        " ".join(ln.split()) for i, ln in enumerate(log)
        if "full3d_pallas_kernel" in "".join(log[max(0, i - 2):i + 1])
        and ("registers" in ln or "spill" in ln)]

    # config.yaml's beta_start_end_pairs section as full_3d, kernel pallas
    # (chip_smoke.py: full3d_pairs_slice).
    n_steps = 1 << 17
    cfg = parse_config({
        "experiment_type": "beta_start_end_pairs",
        "common": {"n_steps": n_steps, "n_runs": 4096, "verbose": False,
                   "initialization": "random", "mcmc_type": "full_3d",
                   "early_stop_patience": "None",
                   "betta_scheduling": {"type": "exponential_annealing",
                                        "base_seed": 42, "beta_const": 5.0,
                                        "beta_start": 1.0, "beta_end": 3.0},
                   "output_path": "figures/energy_history_N3to15.png"},
        "beta_start_end_pairs": {
            "N": 12, "beta_start_ends": [[0.5, 3.0], [0.1, 5.0], [1.0, 5.0]],
            "annealing_type": "linear_annealing"},
        "tpu": {"kernel": "pallas", "history_stride": 16384}})
    params = cfg.section("beta_start_end_pairs")
    out["beta_pairs_full3d_pallas_slice_s"] = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drivers.run_beta_start_end_pairs(
            N=params["N"], n_steps=n_steps,
            beta_start_ends=params["beta_start_ends"],
            annealing_type=params["annealing_type"],
            init_mode=cfg.init_mode, n_runs=cfg.n_runs,
            base_seed=cfg.sched_cfg["base_seed"], verbose=False, plot=False,
            mcmc_type=cfg.mcmc_type,
            early_stop_patience=cfg.early_stop_patience, tpu=cfg.tpu,
            device="cuda")
        torch.cuda.synchronize()
        out["beta_pairs_full3d_pallas_slice_s"].append(
            time.perf_counter() - t0)
    return out


def probes_phases(root):
    """Kernel A, the reduce, the PRNG draws and the gather chain alone, the
    scan samplers' SASS digest, and three tools' walls (module
    docstring)."""
    import hashlib

    import torch

    from mcqueens_torch import tools
    from mcqueens_torch.kernels import probes, probes_mem
    from mcqueens_torch.tools import probe_gather, probe_slice, roofline

    def events_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(5_000_000)
        start.record()
        got = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), got

    W, T = tools.ALU_WIDTH, tools.TIMING_THREADS
    ones = torch.ones((8, W), dtype=torch.int32, device="cuda")
    launches = {
        f"A_roofline_(8,{W})_k8_2048x16": (
            probes.vpu_doubling_cuda, probes.vpu_doubling_reference, ones,
            dict(independent=True, n_iter=2048, k=8, inner=16)),
        f"A_pass_cost_(8,{W})_one_chain_8192": (
            probes.vpu_doubling_cuda, probes.vpu_doubling_reference, ones,
            dict(independent=False, n_iter=1, k=1, inner=8192)),
        f"reduce_(64,{T})_512_steps": (
            probes_mem.sublane_reduce_cuda,
            probes_mem.sublane_reduce_reference,
            torch.ones((64, T), dtype=torch.int32, device="cuda"),
            dict(n_iter=512)),
    }
    for mode in probes_mem.PRNG_MODES:
        launches[f"prng_{mode}_(8,{W})_512_draws"] = (
            probes_mem.prng_draws_cuda, probes_mem.prng_draws_reference,
            (8, W), dict(mode=mode, n_iter=512, device="cuda"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    for S, L, axis in ((T // 256, 256, 1), (256, T // 8, 0)):
        idx = torch.randint(0, L if axis == 1 else S, (S, L),
                            dtype=torch.int32, device="cuda", generator=gen)
        x = torch.arange(S * L, dtype=torch.int32,
                         device="cuda").reshape(S, L) % 7
        # 0 steps: the fill, the drain and (axis 1) the schedule's prologue
        for n in (512, 0):
            launches[f"gather_chain_({S},{L})_axis{axis}_{n}_steps"] = (
                lambda x, idx=idx, axis=axis, **kw:
                    probes_mem.gather_chain_cuda(x, idx, axis, **kw),
                lambda x, idx=idx, axis=axis, **kw:
                    probes_mem.gather_chain_reference(x, idx, axis, **kw),
                x, dict(n_iter=n))
    out = {"probe_launch_ms": {}, "probe_words_sha256": {}}
    for key, (launcher, twin, x, kw) in launches.items():
        want = twin(x, **kw)
        times = []
        for rep in range(4):  # the first loads the kernel: not kept
            ms, got = events_ms(lambda: launcher(x, **kw))
            if not torch.equal(got, want):
                raise AssertionError(f"{key}: the kernel's words differ from "
                                     f"the twin's")
            if rep:
                times.append(ms)
        out["probe_launch_ms"][key] = times
        out["probe_words_sha256"][key] = hashlib.sha256(
            want.cpu().numpy().tobytes()).hexdigest()[:16]
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke

    out["scan_sass_sha256"], out["scan_sass_instances"] = (
        chip_smoke.scan_sass_digest(chip_smoke.sass_text()))
    if not chip_smoke._build.__file__.startswith(root):
        raise AssertionError("the SASS digest read another checkout")
    with tempfile.TemporaryDirectory() as d:
        for mod in (roofline, probe_gather, probe_slice):
            name = mod.__name__.rsplit(".", 1)[1]
            path = os.path.join(d, f"{name}.json")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = mod.main(["--quick", "--json", path])
            out[f"{name}_quick_s"] = time.perf_counter() - t0
            with open(path) as f:
                res = json.load(f)
            if rc != 0:
                raise AssertionError(f"{name} --quick: rc {rc}, {res}")
            if mod is roofline:
                out["roofline_int32_add_ops_per_s"] = res[
                    "int32_add_ops_per_s"]
            elif mod is probe_gather:
                out["probe_gather_chain"] = {
                    k: v["result"] for k, v in res["probes"].items()
                    if "gather cost" in k}
            else:
                out["probe_slice_reduce_and_draws"] = {
                    k: v["result"] for k, v in res["probes"].items()
                    if "reduce" in k or "prng" in k}
    return out


# Variants of csrc/full3d_pallas.cu timed beside it (--only
# full3d_pallas_variants): the attack test in int32, as the same identity
# and as the JAX kernel's squared form (8 at distance 0, so the mover's own
# row is cancelled with 8), and the pass's registers held to 80 and to 64
# by __launch_bounds__(256, 3) and (256, 4).  Each is the same function:
# the phase checks every field against the committed kernel.
_F3P_INT_CELL = """__device__ __forceinline__ int coord(uint32_t w, int k) {
  return (int)((w >> (8 * k)) & 0xFFu);
}

struct Cell {
  int x, y, z;
};

__device__ __forceinline__ Cell cell_of(uint32_t w) {
  return {coord(w, 0), coord(w, 1), coord(w, 2)};
}

"""
F3P_VARIANTS = {
    "committed": {},
    "int32 identity": {"attack": _F3P_INT_CELL + """\
__device__ __forceinline__ bool hits(const Cell& q, const Cell& t) {
  const int rx = q.x - t.x, ry = q.y - t.y, rz = q.z - t.z;
  const int ax = abs(rx), ay = abs(ry), az = abs(rz);
  return max(ax, max(ay, az)) * (ax + ay + az) ==
         rx * rx + ry * ry + rz * rz;
}

"""},
    "int32 squared (JAX form)": {"self_row": 8, "attack": _F3P_INT_CELL + """\
__device__ __forceinline__ int hits(const Cell& q, const Cell& t) {
  const int rx = q.x - t.x, ry = q.y - t.y, rz = q.z - t.z;
  const int p2 = rx * rx, q2 = ry * ry, r2 = rz * rz;
  const int m = max(p2, max(q2, r2));
  return ((p2 == 0) + (p2 == m)) * ((q2 == 0) + (q2 == m)) *
         ((r2 == 0) + (r2 == m));
}

"""},
    "__launch_bounds__(256, 3)": {"min_ctas": 3},
    "__launch_bounds__(256, 4)": {"min_ctas": 4},
}
# Where SASS opcodes issue on an SM sub-partition of sm_90, as NVIDIA's
# throughput tables put them (an attribution, not a measurement): FP32
# arithmetic on the FMA pipes at one warp instruction a clock, IMAD on the
# heavy FMA pipe at half that, shared-memory accesses and shuffles through
# MIO, branches and barriers apart, the rest on the ALU pipe at half rate.
_PIPES = {"FADD": "FP32", "FMUL": "FP32", "FFMA": "FP32", "IMAD": "IMAD",
          "LDS": "MIO", "STS": "MIO", "SHFL": "MIO", "BRA": "branch",
          "BSSY": "branch", "BSYNC": "branch", "WARPSYNC": "branch",
          "NOP": "branch", "BAR": "branch", "EXIT": "branch",
          "ATOMS": "MIO"}


def f3p_variant_source(text, attack=None, self_row=None, min_ctas=None):
    """``csrc/full3d_pallas.cu``'s text with a variant's pieces swapped in:
    ``attack`` for the packed cell's coordinates and the attack test,
    ``self_row`` for the constant that cancels the mover's own row,
    ``min_ctas`` for __launch_bounds__' second argument."""
    def swap(old, new):
        if text.count(old) != 1:
            raise AssertionError(f"variant: {old!r} not found once")
        return text.replace(old, new)

    if attack:
        i = text.index("__device__ __forceinline__ float coord(")
        j = text.index("// attack(queen, new) - attack(queen, old)")
        text = text[:i] + attack + text[j:]
    if self_row:
        text = swap("- (int)hits(o, n) + 1;",
                    f"- (int)hits(o, n) + {self_row};")
    if min_ctas:
        text = swap("constexpr int kMinCtasPerSm = 2;",
                    f"constexpr int kMinCtasPerSm = {min_ctas};")
    return text


def hot_loops(so, kernel):
    """``{first template argument: [opcodes]}`` of each instance of
    ``kernel`` in the library ``so``: its largest innermost loop, a loop
    being the instructions from a backward branch's target to the branch
    (``cuobjdump -sass``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    text = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(so)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(rf"Function : \S*{len(kernel)}{kernel}ILi(\d+)E", line)
        if m or "Function :" in line:
            cur = int(m.group(1)) if m else None
            if cur is not None:
                funcs[cur] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m and cur is not None:
            funcs[cur].append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for key, ins in sorted(funcs.items()):
        loops = []
        for addr, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) <= addr:
                loops.append((int(t.group(1), 16), addr))
        inner = [lp for lp in loops if not any(
            o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        lo, hi = max(inner, key=lambda lp: lp[1] - lp[0])
        out[key] = [op for a, op, _ in ins if lo <= a <= hi]
    return out


def pass_mix(so):
    """``{L: {pipe: instructions a queen row}}`` of each instance of the
    kernel in the library ``so``: its pass (the largest innermost loop, a
    queen row one 32-bit word loaded)."""
    import collections

    out = {}
    for L, body in hot_loops(so, "full3d_pallas_kernel").items():
        # A queen row is one 32-bit word: LDS.64 and LDS.128 load 2 and 4.
        rows = sum({"64": 2, "128": 4}.get(op.split(".")[-1], 1)
                   for op in body if op.startswith("LDS")) or 1
        ops = collections.Counter(op.split(".")[0] for op in body)
        pipes = collections.Counter()
        for op, n in ops.items():
            pipes[_PIPES.get(op, "ALU")] += n
        out[L] = {"rows": rows,
                  **{k: v / rows for k, v in sorted(pipes.items())},
                  "opcodes": dict(ops.most_common())}
    return out


def full3d_pallas_variants():
    """The variants of the per-chain full-3D kernel (module docstring)."""
    import ctypes

    import numpy as np
    import torch

    from mcqueens_torch.chain.spec import ChainSpec
    from mcqueens_torch.core.schedules import build_schedule, chunk_betas
    from mcqueens_torch.kernels import _build
    from mcqueens_torch.kernels import full3d_pallas as fp

    def spec_of(N, n_steps, stride, b0, b1):
        return ChainSpec(N=N, n_steps=n_steps, history_stride=stride,
                         kernel="pallas", mcmc_type="full_3d",
                         schedule=build_schedule(
                             "linear_annealing", n_steps, beta_start=b0,
                             beta_end=b1))

    src = (_build.SOURCES[0].parent / "full3d_pallas.cu").read_text()
    out_dir = _build.BUILD_DIR.parent / "full3d_pallas_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, kw) in enumerate(F3P_VARIANTS.items()):
        cu, so = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        cu.write_text(f3p_variant_source(src, **kw))
        procs[name] = so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs, out = {}, {"full3d_pallas_variants": {}}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = lib.mcq_full3d_pallas_segment
        fn.argtypes = _build.ENTRY_POINTS["mcq_full3d_pallas_segment"]
        fn.restype = ctypes.c_int
        libs[name] = lib
        out["full3d_pallas_variants"][name] = {
            "registers": sorted({int(v) for v in re.findall(
                r"Used (\d+) registers", log)}),
            "spill_bytes": sum(int(v) for v in re.findall(
                r"(\d+) bytes spill", log)),
            "pass_mix": pass_mix(so)}

    pairs = spec_of(12, 1 << 17, 16384, 0.5, 3.0)
    n15 = spec_of(15, 8_000_000, 8192, 0.8, 7.0)
    # name -> (spec, chains, chunks run before the timed one, seed0)
    launches = {
        "pairs_launch_from_0": (pairs, 4096, 0, 42),
        "pairs_launch_from_65536": (pairs, 4096, 4, 42),
        "n15_chunk_C65536": (n15, 65536, 1, 0),
        "n15_chunk_C4096": (n15, 4096, 1, 0),
        "compare_shape_N12_C4096_256": (spec_of(12, 1 << 17, 256, 0.5, 3.0),
                                        4096, 0, 42),
    }
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    order = [*F3P_VARIANTS, *reversed(F3P_VARIANTS)]
    times = out["full3d_pallas_variant_ms"] = {}
    for key, (spec, chains, chunks, seed0) in launches.items():
        carry = fp.init_carry_batch(seed0 + np.arange(chains, dtype=np.uint32),
                                    spec, device="cuda")
        if chunks:
            carry, _ = fp.run_segment(carry, 0, spec, chunks)
        step0, n = chunks * spec.history_stride, spec.history_stride
        beta = chunk_betas(spec.schedule, step0, n, "cuda")
        stream = torch.cuda.current_stream().cuda_stream
        row = times[key] = {name: [] for name in F3P_VARIANTS}
        want = None
        # One untimed launch of each first: it loads the kernel.
        for i, name in enumerate([*F3P_VARIANTS, *order]):
            st = fp.segment_state(carry)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(5_000_000)
            start.record()
            fp.launch_segment(libs[name], st, step0, n, spec, beta,
                              n_sm=n_sm, stream=stream)
            end.record()
            torch.cuda.synchronize()
            if want is None:
                want = st
            bad = [f for f, v in vars(st).items()
                   if not torch.equal(v, getattr(want, f))]
            if bad:
                raise AssertionError(f"variant {name} on {key}: fields "
                                     f"{bad} differ from the committed "
                                     f"kernel's")
            if i >= len(F3P_VARIANTS):
                row[name].append(start.elapsed_time(end))
        row["layout"] = str(fp.layout(spec.N, spec.q_eff, chains, n_sm))
    return out


# Variants of kernel A (csrc/probe_alu.cu) timed beside it (--only
# vpu_variants): the loop over inner restarted every iteration, as before
# the loops were merged; every chain alternating its two forms along
# itself; the IMAD without its runtime addend; 8 pairs a trip.  Each
# computes the same words: the phase checks them against the committed
# kernel's.
_VPU_FLAT = """  const int total = n_iter * inner;
  // doublings r - 1 and r (r odd); 16 trips unrolled: 32 doublings a
  // chain, so the loop's own three instructions cost one chain under 10%
#pragma unroll 16
  for (int r = 1; r < total; r += 2) {
    if constexpr (K == 1) {
      acc[0] = double_add(acc[0], zero);
      acc[0] = double_mad(acc[0], two, zero);
    } else {
      double_chains<K>(acc, two, zero);
      double_chains<K>(acc, two, zero);
    }
  }
  if (total & 1) {  // doubling total - 1, whose index is even
    if constexpr (K == 1) {
      acc[0] = double_add(acc[0], zero);
    } else {
      double_chains<K>(acc, two, zero);
    }
  }
"""
_VPU_NESTED = """  for (int t = 0; t < n_iter; ++t) {
#pragma unroll 16
    for (int r = 1; r < inner; r += 2) {
      if constexpr (K == 1) {
        acc[0] = double_add(acc[0], zero);
        acc[0] = double_mad(acc[0], two, zero);
      } else {
        double_chains<K>(acc, two, zero);
        double_chains<K>(acc, two, zero);
      }
    }
    if (inner & 1) {
      if constexpr (K == 1) {
        acc[0] = double_add(acc[0], zero);
      } else {
        double_chains<K>(acc, two, zero);
      }
    }
  }
"""
VPU_VARIANTS = {
    "committed": {},
    "nested loops": {_VPU_FLAT: _VPU_NESTED},
    # half of each round in each form, every chain alternating along itself
    "every chain alternating": {
        """      double_chains<K>(acc, two, zero);
      double_chains<K>(acc, two, zero);
""": """#pragma unroll
      for (int i = 0; i < K; i += 2) {
        acc[i] = double_mad(acc[i], two, zero);
        acc[i + 1] = double_add(acc[i + 1], zero);
      }
#pragma unroll
      for (int i = 0; i < K; i += 2) {
        acc[i] = double_add(acc[i], zero);
        acc[i + 1] = double_mad(acc[i + 1], two, zero);
      }
"""},
    # a * two: IMAD with RZ as its addend
    "IMAD without addend": {'asm volatile("mad.lo.u32 %0, %0, %1, %2;"':
                            'asm volatile("mul.lo.u32 %0, %0, %1;"'},
    "8 pairs a trip": {"#pragma unroll 16\n  for (int r = 1; r < total":
                       "#pragma unroll 8\n  for (int r = 1; r < total"},
}


def vpu_variants():
    """Kernel A's variants (module docstring)."""
    import collections
    import ctypes

    import torch

    from mcqueens_torch import tools
    from mcqueens_torch.kernels import _build

    fns, out = {}, {"vpu_variants": {}}
    for name, so in build_variants("probe_alu.cu", VPU_VARIANTS,
                                   "vpu_variants").items():
        fn = ctypes.CDLL(str(so)).mcq_probe_vpu
        fn.argtypes = _build.ENTRY_POINTS["mcq_probe_vpu"]
        fn.restype = ctypes.c_int
        fns[name] = fn
        loops = hot_loops(so, "vpu_probe_kernel")
        out["vpu_variants"][name] = {
            f"K={k}": {"opcodes": dict(collections.Counter(
                op.split(".")[0] for op in body)),
                       "first_32": " ".join(op.split(".")[0]
                                            for op in body[:32])}
            for k, body in loops.items()}

    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    r = torch.randint(-2 ** 31, 2 ** 31, (8, 1024), dtype=torch.int32,
                      device="cuda", generator=gen)
    # under 32 doublings, so the random words do not wrap to 0
    for k, n_iter, inner in ((8, 1, 19), (4, 3, 5), (1, 3, 5), (1, 1, 19)):
        outs = {name: torch.empty_like(r) for name in VPU_VARIANTS}
        for name, got in outs.items():
            if fns[name](r.data_ptr(), got.data_ptr(), r.numel(), k, n_iter,
                         inner, 2, 0, stream):
                raise RuntimeError(f"variant {name}: launch failed")
        torch.cuda.synchronize()
        if not all(torch.equal(v, outs["committed"]) for v in outs.values()):
            raise AssertionError(f"a variant's words differ at k={k}, "
                                 f"n_iter={n_iter}, inner={inner}")

    W = tools.ALU_WIDTH
    x = torch.ones((8, W), dtype=torch.int32, device="cuda")
    holder = {}

    def args(k, n_iter, inner):
        # (chains, iterations, doublings an iteration), as
        # probes.vpu_doubling_cuda passes them
        def make():
            holder["out"] = torch.empty_like(x)
            return (x.data_ptr(), holder["out"].data_ptr(), x.numel(), k,
                    n_iter, inner, 2, 0, stream)
        return make

    def check(name, key, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"variant {name} on {key}: words differ "
                                 f"from the committed kernel's")

    out["vpu_variant_ms"] = time_variants(
        fns, {f"roofline_(8,{W})_k8_2048x16": args(8, 2048, 16),
              f"roofline_dependent_(8,{W})_16384x16": args(1, 16384, 16),
              f"pass_cost_(8,{W})_one_chain_8192": args(1, 1, 8192)},
        lambda: holder["out"], check)
    return out


def variant_sources(source, variants):
    """``{name: text}``: ``csrc/<source>`` with each ``{name: {old text:
    new text}}`` variant's substitutions (each old text must occur once)."""
    from mcqueens_torch.kernels import _build

    src = (_build.SOURCES[0].parent / source).read_text()
    texts = {}
    for name, swaps in variants.items():
        text = src
        for old, new in swaps.items():
            if text.count(old) != 1:
                raise AssertionError(f"variant {name}: {old!r} not found "
                                     f"once")
            text = text.replace(old, new)
        texts[name] = text
    return texts


def build_variants(source, variants, out_name):
    """Build each variant of ``csrc/<source>`` (:func:`variant_sources`)
    into a library of its own under ``build/<out_name>`` (one nvcc each,
    all started together); returns ``{name: path}``."""
    from mcqueens_torch.kernels import _build

    texts = variant_sources(source, variants)
    out_dir = _build.BUILD_DIR.parent / out_name
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu, so = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        cu.write_text(text)
        procs[name] = so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I",
             str(_build.SOURCES[0].parent), "-shared", "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    out = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        out[name] = so
    return out


def pipe_opcodes(body):
    """``{pipe: count}`` and ``{opcode: count}`` of a hot loop's opcodes."""
    import collections

    ops = collections.Counter(op.split(".")[0] for op in body)
    pipes = collections.Counter(_PIPES.get(op, "ALU") for op in ops.elements())
    return dict(pipes), dict(ops)


def time_variants(fns, launches, out_of, check):
    """Time ``fns[name](*args)`` for each launch in the order committed,
    variants, variants reversed, committed, after one untimed launch of
    each, behind a spin kernel; ``out_of(args)`` is the output ``check``
    compares with the committed kernel's.  Returns ``{launch: {name:
    [ms, ms]}}``."""
    import torch

    names = list(fns)
    order = [*names, *reversed(names)]
    times = {}
    for key, args in launches.items():
        row = times[key] = {name: [] for name in names}
        want = None
        for i, name in enumerate([*names, *order]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            call_args = args()
            torch.cuda.synchronize()
            torch.cuda._sleep(5_000_000)
            start.record()
            err = fns[name](*call_args)
            end.record()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"variant {name}: cudaError {err}")
            got = out_of().clone()
            want = got if want is None else want
            check(name, key, got, want)
            if i >= len(names):
                row[name].append(start.elapsed_time(end))
    return times


# Variants of the threefry draws (csrc/probe_slice.cu, prng_probe_kernel<1>)
# timed beside it (--only prng_variants): which rounds' adds, rotates and
# key injections issue on the FMA pipe as IMAD, and the words a thread.
# Each is the same function.
_FMA_LINES = ("constexpr uint32_t kFmaAdds = 0xFFFFFu;\n"
              "constexpr uint32_t kFmaRotates = 0u;\n"
              "constexpr bool kFmaInjections = true;\n")


def _fma(adds, rotates, injections):
    return {_FMA_LINES: f"constexpr uint32_t kFmaAdds = {adds:#x}u;\n"
                        f"constexpr uint32_t kFmaRotates = {rotates:#x}u;\n"
                        f"constexpr bool kFmaInjections = "
                        f"{'true' if injections else 'false'};\n"}


def _words(n):
    return {"constexpr int kDrawWords = 4;": f"constexpr int kDrawWords = {n};"}


PRNG_VARIANTS = {
    "committed": {},
    "every pipe left to ptxas": _fma(0, 0, False),
    "x0 injections in the round's IADD3": _fma(0xFFFFF, 0, False),
    "1 in 4 rotates on the FMA pipe": _fma(0xFFFFF, 0x88888, True),
    "every other rotate on the FMA pipe": _fma(0xFFFFF, 0xAAAAA, True),
    "2 words a thread": _words(2),
    "8 words a thread": _words(8),
}
PRNG_VARIANT_WORDS = {"2 words a thread": 2, "8 words a thread": 8}


def prng_variants():
    """The threefry draws' variants (module docstring)."""
    import ctypes

    import torch

    from mcqueens_torch import tools
    from mcqueens_torch.kernels import _build, probes_mem

    libs = build_variants("probe_slice.cu", PRNG_VARIANTS, "prng_variants")
    fns, out = {}, {"prng_variants": {}}
    stream = torch.cuda.current_stream().cuda_stream
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).mcq_probe_prng
        fn.argtypes = _build.ENTRY_POINTS["mcq_probe_prng"]
        fn.restype = ctypes.c_int
        fns[name] = fn
        body = hot_loops(so, "prng_probe_kernel")[1]
        pipes, ops = pipe_opcodes(body)
        out["prng_variants"][name] = {"pipes_per_draw": {
            k: v / PRNG_VARIANT_WORDS.get(name, 4) for k, v in pipes.items()},
            "opcodes": ops}
    holder = {}

    def args(n, n_iter, step0):
        def make():
            holder["out"] = torch.empty(n, dtype=torch.int32, device="cuda")
            return (holder["out"].data_ptr(), n, 1, n_iter,
                    probes_mem.PRNG_SEED, step0, 1, stream)
        return make

    def check(name, key, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"variant {name} on {key}: words differ "
                                 f"from the committed kernel's")

    # every variant on a ragged count and steps wrapping past 2^32, then
    # the slice tool's timing shape, timed
    W = tools.ALU_WIDTH
    time_variants(fns, {"ragged": args(3 * 333, 130, -100)},
                  lambda: holder["out"], check)
    out["prng_variant_ms"] = time_variants(
        fns, {f"threefry_(8,{W})_512_draws": args(8 * W, 512,
                                                  probes_mem.PRNG_STEP0)},
        lambda: holder["out"], check)
    return out


# Variants of the gather chain (csrc/probe_gather.cu, axis 1) timed beside it
# (--only gather_variants): tiles of 256 and 2048 words (the wrapper's rule
# passes the tile), words left at their own positions (no layout), and
# elements in their own order (no schedule: the parent's order on the
# committed layout).  Each is the same function.
GATHER_VARIANTS = {
    "committed": {},
    "no layout (words at their own positions)": {
        "      mypos[j] = q * 32 + b;": "      mypos[j] = w;"},
    "no schedule (elements in order)": {
        "    const uint32_t v = sched[(j * kChainWarps + warp) * 32 + lane];":
        "    const int w = (j * kChainWarps + warp) * 32 + lane;\n"
        "    const uint32_t v = j < E && w < T ? pos[src[j < E ? j : 0]] | "
        "(uint32_t)pos[w] << 16 : kNoElement;"},
}
# Timed at 0 steps only (the prologue, fill and drain), where every
# variant's words are x: the prologue without the assignment, and without
# anything but the fill.
GATHER_PROLOGUE_VARIANTS = {
    "no assignment (0 steps only)": {
        "  if (warp == 0) {\n    // in rounds":
        "  if (false) {\n    // in rounds"},
    "fill only (0 steps only)": {
        "    build_schedule<E>(buf, x, idx, g0, L, T, ld, st, live, mypos);":
        "    for (int j = 0; j < E; ++j) {\n"
        "      const int w = tid + j * kChainThreads;\n"
        "      mypos[j] = w;\n"
        "      if (w < T) buf[w] = (uint32_t)x[g0 + w];\n"
        "    }\n"
        "    __syncthreads();\n"
        "    live = 0;"},
}
GATHER_TILES = {"committed": 1024, "tile of 256 words": 256,
                "tile of 2048 words": 2048}


def gather_variants():
    """The gather chain's variants (module docstring)."""
    import ctypes

    import torch

    from mcqueens_torch import tools
    from mcqueens_torch.kernels import _build, probes_mem

    libs = build_variants("probe_gather.cu", {**GATHER_VARIANTS,
                                              **GATHER_PROLOGUE_VARIANTS},
                          "gather_variants")
    stream = torch.cuda.current_stream().cuda_stream
    fns, out = {}, {"gather_variants": {}}
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).mcq_probe_gather_chain
        fn.argtypes = _build.ENTRY_POINTS["mcq_probe_gather_chain"]
        fn.restype = ctypes.c_int
        for tile_name, tile in GATHER_TILES.items():
            if name != "committed" and tile_name != "committed":
                continue
            key = name if tile_name == "committed" else tile_name
            fns[key] = (fn, tile)
        loops = hot_loops(so, "gather_chain_probe_kernel")
        out["gather_variants"][name] = {
            f"E={e}": pipe_opcodes(body) for e, body in loops.items()}
    T = tools.TIMING_THREADS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    S, L = T // 256, 256
    idx = torch.randint(0, L, (S, L), dtype=torch.int32, device="cuda",
                        generator=gen)
    x = torch.arange(S * L, dtype=torch.int32, device="cuda").reshape(S, L)
    got = torch.empty_like(x)

    def launcher(fn, tile):
        rows = tile // L
        e = next(e for e in probes_mem.CHAIN_ES if 256 * e >= tile)
        return lambda n_iter: fn(x.data_ptr(), idx.data_ptr(),
                                 got.data_ptr(), None, S, L, 1, rows, L, e,
                                 n_iter, stream)

    calls = {name: launcher(*ft) for name, ft in fns.items()}
    stepped = {n: c for n, c in calls.items()
               if n not in GATHER_PROLOGUE_VARIANTS}
    want = probes_mem.gather_chain_reference(x, idx, 1, n_iter=5)
    for name, call in stepped.items():
        err = call(5)
        torch.cuda.synchronize()
        if err or not torch.equal(got, want):
            raise AssertionError(f"gather variant {name}: cudaError {err} "
                                 f"or words that differ from the twin's")

    def check(name, key, g, w):
        if not torch.equal(g, w):
            raise AssertionError(f"variant {name} on {key}: words differ "
                                 f"from the committed kernel's")

    out["gather_variant_ms"] = {
        **time_variants({name: (lambda call=call: call(512))
                         for name, call in stepped.items()},
                        {f"({S},{L})_axis1_512_steps": lambda: ()},
                        lambda: got, check),
        **time_variants({name: (lambda call=call: call(0))
                         for name, call in calls.items()},
                        {f"({S},{L})_axis1_0_steps": lambda: ()},
                        lambda: got, check)}
    return out


def full3d_sass_digests(text, hold=8):
    """{(lanes, shared memory): sha256 (16 hex digits) of the instructions}
    of the full-3D shared kernel's instances at ``hold``; an instance named
    without a hold (a checkout before the hold was a template parameter) is
    hold 8.  Names are left out of the hash (nvcc names an anonymous
    namespace after the source's path, which differs between checkouts),
    so a pair run can hold the two checkouts' instances to each other."""
    out, h = {}, None
    pat = re.compile(r"full3d_shared_kernelILi(\d+)ELb([01])E(?:Li(\d+)E)?E")
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inst = pat.search(m.group(1))
            h = None
            if inst and int(inst[3] or 8) == hold:
                h = hashlib.sha256()
                out[int(inst[1]), inst[2] == "1"] = h
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", line)
        if h is not None and ins:
            h.update(re.sub(r"_Z\w+", "_Z", ins.group(1)).encode())
    return {k: v.hexdigest()[:16] for k, v in sorted(out.items())}


def sass_digests(root):
    """The full-3D shared kernel's hold-8 instances' SASS digests of the
    checkout's build (module docstring); needs nothing of ``chip_smoke``,
    whose imports a checkout from before them may lack."""
    from torch.utils.cpp_extension import CUDA_HOME

    from mcqueens_torch.kernels import _build

    if not _build.__file__.startswith(root):
        raise AssertionError("the SASS digest read another checkout")
    text = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
         str(_build.build())], capture_output=True, text=True, check=True,
        timeout=300).stdout
    return {"full3d_hold8_sass_sha256": {
        f"L={lanes} {'shared' if smem else 'device'}": d
        for (lanes, smem), d in full3d_sass_digests(text).items()}}


def mesh_phases():
    """The checkout's ``chip_smoke.py`` mesh phase alone (module
    docstring); returns each kernel's launches in its sharded runs."""
    import chip_smoke

    _, pod = chip_smoke.pod_scale_slice()
    launches = chip_smoke.mesh_slice(pod)
    return {"mesh_launches": {chip_smoke.KERNELS[mod]["name"]: n
                              for mod, n in launches.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="root of the checkout whose port is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--json", default=None, help="also write the line here")
    ap.add_argument("--only", choices=["board_shared", "full3d",
                                       "metropolis",
                                       "full3d_pallas",
                                       "full3d_pallas_variants", "probes",
                                       "vpu_variants", "prng_variants",
                                       "gather_variants", "sass",
                                       "mesh"],
                    default=None,
                    help="time only one kernel's phases")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("pair_scan_slice: no CUDA GPU")
    from mcqueens_torch.chain import board, full3d
    from mcqueens_torch.chain.spec import ChainSpec
    from mcqueens_torch.core import rng
    from mcqueens_torch.core.schedules import build_schedule, chunk_betas
    from mcqueens_torch.experiments import drivers
    from mcqueens_torch.experiments.config import load_config
    from mcqueens_torch.cli import competition
    from mcqueens_torch.kernels import board_shared, probes_mem
    from mcqueens_torch.search.tempering import geometric_ladder

    if not board.__file__.startswith(root):
        raise SystemExit(f"imported {board.__file__}, not from {root}")

    def events_ms(fn, reps=1, spin=False):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if spin:
            torch.cuda._sleep(5_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def spec_of(N, n_steps, stride, schedule, kernel, **kw):
        return ChainSpec(N=N, n_steps=n_steps, schedule=schedule,
                         kernel=kernel, history_stride=stride, **kw)

    def scan_state(mod, spec, chains, start_outer):
        keys = rng.chain_keys_from_seeds(np.arange(chains, dtype=np.uint32),
                                         "cuda")
        carry = mod.init_carry_batch(keys, spec, device="cuda")
        if start_outer:
            carry, _ = mod.run_segment(carry, 0, spec, start_outer)
        return mod.segment_state(carry)

    def scan_ms(mod, spec, chains, start_outer, n_outer):
        st = scan_state(mod, spec, chains, start_outer)
        stride = spec.history_stride
        beta = chunk_betas(spec.schedule, start_outer * stride,
                           n_outer * stride, "cuda")
        ys = torch.empty((n_outer, chains), dtype=torch.int32, device="cuda")
        return events_ms(lambda: mod.segment_cuda(st, ys, start_outer,
                                                  n_outer, spec, beta))

    out = {"label": args.label, "root": root,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip().splitlines()[0]}

    # Load the kernel library and every kernel this run launches.
    flat = build_schedule("constant", 64, beta_const=1.0)
    for kern in ("tables", "naive"):
        scan_ms(board, spec_of(4, 64, 1, flat, kern), 4, 0, 8)
        scan_ms(full3d, spec_of(3, 64, 1, flat, kern, mcmc_type="full_3d"),
                4, 0, 8)

    if args.only is None:
        cfg = load_config(os.path.join(root, "config.yaml"))
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d, \
                contextlib.redirect_stdout(io.StringIO()):
            drivers.run_from_config(cfg, outdir=d, device="cuda", plot=False)
        torch.cuda.synchronize()
        out["config_yaml_slice_s"] = time.perf_counter() - t0

        pairs = cfg.section("beta_start_end_pairs")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            drivers.run_beta_start_end_pairs(
                N=pairs["N"], n_steps=cfg.n_steps,
                beta_start_ends=pairs["beta_start_ends"],
                annealing_type=pairs["annealing_type"],
                init_mode=cfg.init_mode, n_runs=cfg.n_runs,
                base_seed=cfg.sched_cfg["base_seed"], verbose=cfg.verbose,
                plot=False, mcmc_type="full_3d",
                early_stop_patience=cfg.early_stop_patience, tpu=cfg.tpu,
                device="cuda")
        torch.cuda.synchronize()
        out["beta_pairs_as_full3d_s"] = time.perf_counter() - t0

        n, steps = 10 ** 6, 100_000
        out["board_scan_us_per_step_c10"] = {}
        for N, beta_end in ((12, 3.0), (18, 5.0)):
            spec = spec_of(N, n, 1, build_schedule(
                "exponential_annealing", n, beta_start=1.0, beta_end=beta_end),
                "tables")
            ms = scan_ms(board, spec, 10, 0, steps)
            out["board_scan_us_per_step_c10"][f"N={N}"] = ms * 1e3 / steps
        spec = spec_of(12, n, 1, build_schedule(
            "linear_annealing", n, beta_start=0.5, beta_end=3.0), "tables",
            mcmc_type="full_3d")
        out["full3d_scan_us_per_step_c10"] = {
            "N=12": scan_ms(full3d, spec, 10, 0, steps) * 1e3 / steps}

        stride, chains = 16384, 4096
        for mod, key, N, horizon, b0, b1, kw in (
                (board, "board_scan_4096_moves_per_s", 16, 2 ** 24, 1.0, 5.0,
                 {}),
                (full3d, "full3d_scan_4096_moves_per_s", 12, 10 ** 6, 0.5, 3.0,
                 dict(mcmc_type="full_3d"))):
            out[key] = {}
            for kern in ("tables", "naive"):
                spec = spec_of(N, horizon, stride, build_schedule(
                    "linear_annealing", horizon, beta_start=b0, beta_end=b1),
                    kern, **kw)
                ms = scan_ms(mod, spec, chains, 1, 1)
                out[key][kern] = stride * chains / ms * 1e3

        # The shared-site board kernel.
        def shared_state(spec, chains, seed0):
            carry = board_shared.init_carry_batch(
                seed0 + np.arange(chains, dtype=np.uint32), spec,
                device="cuda")
            return carry, board_shared.segment_state(carry)

        def shared_chunk_ms(spec, chains, seed0, start_outer=0, ladder=None,
                            freeze=None):
            stride = spec.history_stride
            beta = chunk_betas(spec.schedule, start_outer * stride, stride,
                               "cuda")
            times = []
            for rep in range(4):  # the first loads the kernel: not kept
                carry, st = shared_state(spec, chains, seed0)
                C = st.energy.shape[0]
                args, mode = (), {}
                if ladder is not None:
                    args = (torch.from_numpy(np.tile(ladder, -(-C // 16))[:C]
                                             .copy()).cuda(),)
                if freeze is not None:
                    mode = dict(freeze=torch.as_tensor(
                        freeze(C), dtype=torch.int32, device="cuda"),
                        track_best=False)
                ms = events_ms(lambda: board_shared.segment_cuda(
                    st, start_outer * stride, stride, spec, beta, *args,
                    **mode),
                    spin=True)
                if rep:
                    times.append(ms)
            return times

        lin = lambda n, b0, b1: build_schedule(  # noqa: E731
            "linear_annealing", n, beta_start=b0, beta_end=b1)
        main_spec = spec_of(16, 50000, 48, lin(50000, 1.0, 3.0),
                            "pallas_shared")
        rs = np.random.default_rng(7)
        out["board_shared_chunk_ms"] = {
            "main_path": shared_chunk_ms(main_spec, 32768, 42),
            "tempered": shared_chunk_ms(
                spec_of(16, 50000, 48, build_schedule(
                    "constant", 50000, beta_const=1.0), "pallas_shared"),
                32768, 42, ladder=geometric_ladder(1.0, 3.0, 16)),
            "freeze": shared_chunk_ms(main_spec, 32768, 42, start_outer=10,
                                      freeze=lambda C: rs.integers(
                                          480, 528, C)),
        }
        bench = spec_of(16, 2 ** 24, 32768, lin(2 ** 24, 1.0, 5.0),
                        "pallas_shared")
        out["board_shared_bench_chunk"] = {}
        for chains in (32768, 4096):
            carry, _ = shared_state(bench, chains, 0)
            carry, _ = board_shared.run_segment(carry, 0, bench, 1)
            st = board_shared.segment_state(carry)
            beta = chunk_betas(bench.schedule, 32768, 32768, "cuda")
            ms = events_ms(lambda: board_shared.segment_cuda(
                st, 32768, 32768, bench, beta), spin=True)
            out["board_shared_bench_chunk"][f"C={chains}"] = {
                "ms": ms, "moves_per_s": 32768 * chains / ms * 1e3}

        def cli_s(extra):
            with tempfile.TemporaryDirectory() as d:
                buf = io.StringIO()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    competition.main(["--n", "16", "--n-runs", "32768",
                                      "--n-steps", "50000", "--kernel",
                                      "pallas_shared", "--device", "cuda",
                                      "--outdir", d] + extra)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            rate = re.search(r"= ([0-9.e+]+) moves/s", buf.getvalue())
            return {"wall_s": wall,
                    "moves_per_s_reported": float(rate.group(1))}

        out["board_cli"] = cli_s([])
        out["board_tempered_cli"] = cli_s(["--tempering", "16"])
        seeds = 42 + np.arange(32768, dtype=np.uint32)
        recover = {}
        for track in (True, False):
            carry = board_shared.init_carry_batch(seeds, main_spec,
                                                  device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry, _ = board_shared.run_segment(carry, 0, main_spec,
                                                main_spec.n_outer,
                                                track_best=track)
            torch.cuda.synchronize()
            recover["track_best_on_s" if track else "track_best_off_s"] = (
                time.perf_counter() - t0)
        t0 = time.perf_counter()
        board_shared.recover_best_heights(carry, main_spec)
        torch.cuda.synchronize()
        recover["replay_s"] = time.perf_counter() - t0
        out["board_recover"] = recover

        from mcqueens_torch.search import tempering

        def sync_ms(fn, reps=50):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3

        rounds, ladder = 200, geometric_ladder(1.0, 3.0, 16)
        tspec = spec_of(16, 48 * rounds, 48, lin(48 * rounds, 1.0, 3.0),
                        "pallas_shared")
        tempering.run_tempered(seeds[:4096], tspec, ladder, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tempering.run_tempered(seeds, tspec, ladder, device="cuda")
        torch.cuda.synchronize()
        split = {"run_tempered_per_round": (time.perf_counter() - t0) / rounds
                 * 1e3}
        carry, st = shared_state(tspec, 32768, 42)
        scale = torch.from_numpy(np.tile(ladder, 2048)).cuda()
        beta = chunk_betas(tspec.schedule, 480, 48, "cuda")
        energies = carry.energy.reshape(-1)
        split["segment_state"] = sync_ms(
            lambda: board_shared.segment_state(carry))
        split["kernel_launch"] = sync_ms(lambda: board_shared.segment_cuda(
            st, 480, 48, tspec, beta, scale))
        split["carry_of"] = sync_ms(lambda: board_shared.carry_of(st))
        split["chunk_betas"] = sync_ms(lambda: chunk_betas(
            tspec.schedule, 480, 48, "cuda"))
        split["exchange"] = sync_ms(lambda: tempering.exchange(
            scale, energies, tempering.round_key(0, 3), 16, 1))
        split["energies_to_host"] = sync_ms(lambda: energies.cpu().numpy())
        out["tempered_round_ms"] = split

        S, C, width = 256, 67584, 16
        x = torch.arange(S * C, dtype=torch.int32, device="cuda").reshape(S, C)
        out["slice_copy_ms"] = {}
        for mode, row in (("load", 240), ("store", 48)):
            off = torch.tensor([row], dtype=torch.int32, device="cuda")
            if mode == "load":
                kernel = lambda: probes_mem.slice_load_cuda(x, off, width)
                want = probes_mem.slice_load_reference(x, off, width)
                library = lambda: torch.narrow_copy(x, 0, row, width)
                name = "narrow_copy"
            else:
                rows = torch.arange(row, row + width, device="cuda")
                kernel = lambda: probes_mem.slice_store_cuda(x, off, width)
                want = probes_mem.slice_store_reference(x, off, width)
                library = lambda: x.index_fill(0, rows, 7)
                name = "index_fill"
            if not (torch.equal(kernel(), want)
                    and torch.equal(library(), want)):
                raise AssertionError(
                    f"slice {mode}: kernel or {name} is wrong")
            out["slice_copy_ms"][mode] = {
                "kernel": events_ms(kernel, 10, spin=True),
                name: events_ms(library, 10, spin=True)}
    if args.only == "board_shared":
        out.update(board_shared_phases())
    if args.only in (None, "full3d"):
        out.update(full3d_phases())
    if args.only in (None, "metropolis"):
        out.update(metropolis_phases())
    if args.only in (None, "full3d_pallas"):
        out.update(full3d_pallas_phases())
    if args.only == "full3d_pallas_variants":
        out.update(full3d_pallas_variants())
    if args.only == "probes":
        out.update(probes_phases(root))
    if args.only == "vpu_variants":
        out.update(vpu_variants())
    if args.only == "prng_variants":
        out.update(prng_variants())
    if args.only == "gather_variants":
        out.update(gather_variants())
    if args.only == "sass":
        out.update(sass_digests(root))
    if args.only == "mesh":
        out.update(mesh_phases())
    line = json.dumps(out)
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
