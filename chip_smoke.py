#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``mcqueens_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines with its seconds; any failure raises
and the script exits non-zero without printing a result:

1. device: CUDA must be available (no CPU fallback); prints the card,
   ``nvidia-smi``'s name and power limit, and the torch/CUDA versions.
2. build: compiles every ``mcqueens_torch/kernels/csrc/*.cu`` (one nvcc per
   source, in parallel, linked into one library) and prints each kernel's
   registers and spills, the full-3D shared kernel's at each of its holds
   (8, 16 and 32: a template parameter).
3a. probes: the measurement tools' four probe kernels
   (``kernels/probes.py``: A int32 doublings, B the attack test in three
   forms, C mul/add chains, D the production-shaped sweep) against their
   twins on the card, bitwise, at the JAX tools' parity shapes (small
   n_iter, random words too) and at the shapes the tools launch; the SASS
   of each template instance's hot loop (``cuobjdump -sass``), which must
   issue at least half as many int32 instructions per evaluation as the
   TPU source has operations; the time under twice the trip count (must be
   1.8-2.2x: the least of 5 alternated pairs of launches of each trip
   count, each pair behind its own spin kernel, with the spread of each).
   Each probe's bound counts the TPU source's operations.
   The gather and slice tools' kernels (``kernels/probes_mem.py``: the
   gather and the gather chain, ``csrc/probe_gather.cu``; the slice copy in
   load and store mode, the slice loop, the reduce and the PRNG draws in
   both generators, ``csrc/probe_slice.cu``; kernel A with every doubling
   in its inner loop, one chain and eight) go through the same checks, one
   table (``PROBES``) driving all of them: the JAX tools' parity shapes with
   their own inputs, random words with ragged tiles and every gather-chain
   instance, and the tools' card-filling shapes; the one-pass gather and
   slice copy have no loop, so no SASS check and no scaling, and are timed
   beside torch.gather, narrow_copy and index_fill, which compute the same
   words; the slice copy also at a C that is not a multiple of 4, on a view
   4 bytes past 16-byte alignment (its int32 path) and at the last legal
   offset.  The gather chain also at indices that defeat a bank schedule
   (all zeros, one bank, identity, permutations), and the PRNG draws at
   1, 33 and 4097 steps, ragged word counts and steps wrapping past 2^32.
   Every probe is checked through its public wrapper and timed
   through its launcher on the card alone (a spin kernel ahead of the
   launches, so no launch waits for the host).  A shared-memory kernel's
   hot loop is its largest loop that touches no device memory (the gather
   chain's: one with a barrier).  A bound
   adds shared-memory bytes (32 banks x 4 B per SM per clock) to
   device-memory bytes and int32 operations; the gather chain's prints the
   bank schedule the card built beside it (instructions and wavefronts a
   256-word row).  Each hot loop's instructions are printed by pipe; kernel
   A's and the threefry draws' must issue at least 40% of their int32
   instructions on each (IADD3, SHF, LOP3 on the ALU pipe, IMAD on the FMA
   pipe).  The scan samplers' SASS digest is printed (the threefry probe
   shares their header), and the digest of each of the full-3D shared
   kernel's hold-8 instances (``pair_scan_slice.py --only sass`` prints the
   same for a parent checkout).
   Kernel A runs at every instance in both modes, with odd and even inner
   counts, and the reduce at both its instances (the column in registers
   up to 64 rows, the staged strip above); the reduce's bound counts the
   function's operations, and the staged kernel's shared-memory words,
   its earlier bound, are printed beside it.
3. kernel vs twin: one launch through each CUDA kernel and one through its
   plain-torch twin (``segment_reference``), both on the card from the same
   ``init_carry_batch`` state, betas and beta scales; every state field must
   be equal (``torch.equal``, tolerance none), and each side is timed alone.
   Board shapes: the main-path chunk (N=16, 32768 chains, 48 steps), N=16
   at 4096 chains for 2048 steps, N=5 with patience early-stop, N=11
   klarner at beta=100, a chunk past step 2^24, and the tempered mode (N=16,
   32768 chains, 48 steps, 16-level ladder).  Full-3D shapes: the floors
   slice's launch (N=15, Q=225, 65536 chains, 16-level ladder 0.8->7, 44
   steps: the last mover chunk is 4 steps), the Q_max launch (N=8, Q=48,
   4096 chains, 4096 steps), N=5/Q=13 with patience at a cold beta, N=3/Q=26
   (nearly every candidate occupied), and a launch past step 2^24.
   Per-chain board (metropolis) shapes: the pod-scale chunk (N=20, 4096
   chains, 256 steps), the bench shape (N=16, 32768 chains, 48 steps), N=32
   (128 chains, 512 steps), N=5 with patience, N=11 klarner at beta=100,
   N=2, 1000 chains (padded to 1024) and a launch past step 2^24 with 50
   bins; and the redesigned kernel's edges (kernels/metropolis_pallas.py:
   layout, printed on each compare line; a team of L lanes a chain drawing
   a batch of L steps ahead): each team size forced at the pod-scale width,
   stops and bin edges inside a batch (a whole warp forced, and by the
   rule, where teams of one warp stop at different steps), segments of 1,
   31 and 33 steps (a whole warp forced, and by the rule), N=170 (the
   largest N it takes), C=4099 (not whole blocks) by the rule and with a
   ragged last CTA of 3 chains, and the pod-scale launch (the second
   16384-step chunk, 4096 chains) and the beyond-reference launch at its
   largest N (62500 steps from step 0, 128 chains, N=32) in full, held
   against the twin on a sample of 64 and 16 chains (the twin's time is
   ~1.2-1.6 ms a step whatever the chains).  Each of its instances' registers
   must stay within the 64 its layout rule reckons with.  Per-chain
   full-3D shapes: N=12/Q=144 and N=15/Q=225 at 4096 chains, N=3/Q=26
   (attempt runs past 32), N=2/Q=7, N=5/Q=13 with patience, N=11 klarner
   at beta=100 and a launch past step 2^24; and the redesigned kernel's
   edges (kernels/full3d_pallas.py:layout, printed on each compare line; a
   team of L lanes a chain drawing a batch of L steps' proposals and first
   two rejection attempts ahead): each team size forced at the beta pairs'
   width (N=12, Q=144, 4096 chains, 256 steps), N=3/Q=26 at each team size
   (nearly every step takes rounds of attempts past the two drawn ahead),
   C=4099 by the rule and with a ragged last CTA of 3 chains, and, held
   against the twin on a sample of 64 chains, the beta pairs' launch (linear
   0.5->3 over 2^17, 4096 chains) in full from step 0 (16384 steps) and its
   first 2048 steps from step 65536, and the first 1024 steps of the
   N=15/Q=225 chunk from step 8192 at 65536 chains (the twin takes ~2 ms a
   step whatever the chains, so only fewer steps shorten it).  Each of its
   instances' registers must stay within the 80 its layout rule reckons
   with.
   Board freeze mode (track_best off, a per-chain step horizon), against the
   twin: horizons inside the chunk (N=16, 32768 chains), all at 0, past
   n_steps on the tail chunk, with patience, and 1000 chains padded to 1024.
   The board kernel's layouts (kernels/board_shared.py:layout; every board
   compare line prints its lanes a chain, chains a CTA and shared or device
   memory): each team size forced at N=16, 4096 chains, 48 steps from step
   0; the device-memory instance forced there and picked by the rule at
   N=128 (256 chains, 16 steps); tempered with 1000 chains padded to 1024;
   horizons at 0 for half of 32768 chains; patience stops at different
   steps inside one warp and inside a batch of draws (N=5, 4096 chains);
   and a Klarner warm start at the least energy (N=11, beta 0.5), where no
   chain may improve and no best board may be written.  Every instance is
   loaded before the first timed launch, each kernel is timed behind a spin
   kernel (so a launch never waits for the host), and each board instance's
   registers must stay within the 64 its layout rule reckons with.
   The full-3D shared kernel's layouts (kernels/full3d_shared.py:layout;
   every full-3D compare line prints its layout too): each team size (1 to
   32 lanes) forced at the floors launch's width (N=15, Q=225, 4096 chains,
   44 steps from step 0, 16-level ladder); the device-memory instance
   forced there and picked by the rule at N=31, Q=29100 (no CTA's slot fits
   shared memory; 128 chains, 16 steps); tempered with 1000 chains padded to
   1024; patience stops at different steps inside one warp and inside a
   chunk (N=5, Q=13, 4096 chains); best planes far behind the live ones
   (N=6, Q=36, 4096 chains, 2048 steps at beta 0.3 from a cold start); a
   Klarner warm start at the least energy (N=11, beta 0.5), where no chain
   may improve and no best plane may be written; and the campaign chunk's
   shape (N=15, Q=225, 65536 chains, one 62500-step launch from step 6.25M),
   held against the twin on a sample of 128 chains.  Each instance's
   registers must stay within the 128 its layout rule reckons with.  The
   hold: one 1024-step launch (N=15, Q=225, 4096 chains, launch 2 of the
   campaign's schedule) at each hold, ``_HOLD`` set as the probe of the
   hold sets it, every field equal to the twin's, the kernel's time beside
   its bound; a hold of 12, and hold 16 on a 44-step launch, must raise.
   Scan samplers (kernels/csrc/board_scan.cu, full3d_scan.cu), each shape
   in both modes (tables and naive) against the twin over a whole segment
   of several chunks, and tables == naive on the card: config.yaml's cells
   (N=12 and N=18, 10 chains, stride 1), N=2 with a stride tail past
   n_steps, patience, a warm start and wider batches; the board kernel
   draws 32 steps ahead, a warp per chain, so also stops inside a batch,
   segments of 1, 31 and 33 steps, start_outer > 0 with stride 13, 4099
   chains, and N=48 (8 chains), whose table stays in device memory while
   naive keeps its boards in shared memory (each compare line prints the
   layout of chain/board.py:scan_layout); full-3D: config.yaml's
   beta pairs cell as full_3d (N=12/Q=144, 10 chains, stride 1), N=12/Q=144
   at 4096 chains, N=2/Q=7 with a tail, N=5/Q=13 with patience, N=3/Q=26
   and a warm start; the full-3D kernel is a warp per chain too, drawing 32
   steps and two rejection attempts ahead, so also stops inside a batch,
   segments of 1, 31 and 33 steps, start_outer > 0 with stride 13, 4099
   chains, N=2/Q=7 and N=3/Q=26 over more than a batch at stride 1, and
   N=36/Q=1296 (4 chains), whose table stays in device memory while naive
   keeps its state in shared memory (chain/full3d.py:scan_layout, printed
   on each compare line).  Each bound counts only the work its launch did: the
   bins its steps fall in, the cells and table words its proposals read,
   its accepted moves, and best states only where a chain improved (none
   with track_best off).
4. the main paths end to end, each with the launch counts zeroed just
   before it and read just after (each must equal the launches it ran):
   the board CLI (N=16, 32768 runs, 50000 steps); the board tempered CLI
   (16 levels); the full-3D floors-campaign search cut to 125000 steps (N=15,
   65536 runs, 16 levels 0.8->7, stride 62500); the Q_max certificate
   search through the port's ``tools.qmax.search`` (N=8, Q=48, 4096 chains,
   2^18 steps), which must reach energy 0, and ``tools.qmax_frontier.main``
   from Q=48 (its root a temporary directory), which must bank a lower
   bound >= 48 whose certificate ``tools.verify_board`` and
   ``core.energy`` on the card both score 0; the tempered certificate push
   of ``tools.qmax_push.push`` at its full width (N=24, Q=403, 65536
   chains, 16 levels 0.8->9, stride 62500, warm from the committed Q=402
   certificate, re-scored first) cut to 125000 steps (two rounds), run
   uninterrupted, killed right after round 1's checkpoint and resumed from
   it: the resumed result must equal the uninterrupted one in every array,
   launch only round 2 and leave no checkpoint behind (each run prints the
   checkpoint's npz bytes and save and restore seconds); the floors
   campaign ``tools.full3d_floors_campaign.main`` (its root a temporary
   directory) at N=15 (65536 chains, Q=225, fresh, confirm and one
   refinement of 125000 steps) and the board refinement at N=14 from the
   committed board floor, every exported board re-scored by
   ``verify_board`` and each floor equal to the least re-score; every
   committed ``artifacts/qmax/qmax_N*_Q*.txt`` scored 0 on the card with Q
   distinct cells; ``configs/pod_scale.yaml``'s run (N=20, 4096 runs,
   kernel pallas) cut to 2^19 steps, then again with its
   ``checkpoint_dir`` (a temporary directory) through
   ``drivers.run_single_n``, killed right after 5 of its 10 segments and
   resumed: equal to the first run in every array, the resume launching
   only the 5 remaining segments; then the mesh
   (``mcqueens_torch/dist/mesh.py``), its launches counted apart:
   ``configs/pod_scale.yaml`` as written (``mesh: true``: every visible
   card; its ``checkpoint_dir`` a temporary directory) through
   ``drivers.run_from_config``, cut to 2^19 steps, equal to the unsharded
   run in every ChainResult array; and each sampler's path unsharded and
   on 2 and 4 shards over ``cuda:0``, every sharded result equal to the
   unsharded one and every shard's launches counted: the board CLI's main
   path (N=16, 32768 runs, 50000 steps, stride 48), the board tempered
   CLI's width cut to 4800 steps, the full-3D floors search as the floors
   slice runs it (N=15, Q=225, 65536 chains, 16 levels, two 62500-step
   chunks), the per-chain board at pod scale (N=20, 4096 runs, 2^17 steps),
   the per-chain full-3D beta pair 0.5->3 (N=12, Q=144, 4096 runs, 2^17
   steps) and config.yaml's first cell on each scan (10 chains, padded by
   the 4-shard mesh to 12; 1M steps, stride 1); where more than one card is
   visible, each path again over all of them, with each card's busy time
   (CUDA events around its segments), else a line saying one card was
   visible; then several processes
   (``python -m mcqueens_torch.tools.check_multihost``: a gloo group over
   localhost, the global mesh spanning both processes), two processes each
   with 2 shards of ``cuda:0`` (and, where more than one card is visible,
   each with its own cards) running the board scan at N=16, 4096 chains,
   65536 steps: both JSONs must equal the same seeds' one-process
   ``run_chains`` on the card in final_energy, min and sum (each process's
   start-up, shard scans, gather and reduce printed); then the invariant
   battery ``python -m mcqueens_torch.tools.verify_gpu`` into a temporary
   directory: all six checks must pass (tables == naive, incremental ==
   oracle for seven kernel/mode pairs, card == twin streams, Klarner 0,
   recover == tracked, init at C=65536 == oracle) and the file must name
   the card and its power limit; both processes' launches are counted
   into the kernels line (``multihost_launches``, ``verify_launches``);
   ``configs/beyond_reference.yaml``'s
   sweep through ``drivers.measure_min_energy_vs_n`` (10 N, random and
   klarner, 128 runs) cut to 62500 steps, where klarner at N = 17, 19, 23,
   29, 31 must report 0; and ``config.yaml``'s beta_start_end_pairs section
   through ``drivers.run_beta_start_end_pairs`` as full_3d with kernel
   pallas (N=12, 4096 runs, 2^17 steps).  Then the freeze-mode path: the
   board CLI configuration (N=16, 32768 chains, 50000 steps, linear 1->3,
   stride 48) through ``board_shared.run_segment`` with track_best on and
   off, and ``recover_best_heights`` on the untracked run (one launch of the
   replayed steps; first, every schedule kind's betas over a run must equal
   its chunks' betas on the card), whose boards must equal the tracked ones
   bitwise and score their best energies; and the
   scan samplers' paths: ``config.yaml`` as committed (compare_beta_end, N
   12 and 18, 10 runs, 1M steps, exponential, stride 1, kernel tables)
   through ``drivers.run_from_config``, and its beta_start_end_pairs
   section as full_3d with kernel tables (N=12, 10 runs, 1M steps), both
   uncut.  Configs are dicts through ``parse_config`` (config.yaml through
   ``load_config``); every reported best state is re-scored by the oracle.
   Then the trace: ``runner.run_chains`` (board, pallas_shared, N=16, 4096
   chains, two 2048-step chunks) without ``profile_dir`` and twice with it,
   every result array equal; the trace must name the board kernel among the
   card's kernels (its walls printed: the trace's cost).
5. throughput: proposed moves/s of the board kernel by
   ``mcqueens_torch.bench._measure`` (``bench.py``'s configuration: N=16,
   linear 1->5 over 2^24 steps, 32768-step chunks, 3 s) at 32768 and 4096
   chains, beside the kernel alone on a chunk (at 32768 chains the bench
   must reach 0.95 of the rate the chunk implies), and of the full-3D
   kernel at the campaign's (N=15, Q=225, linear 0.8->7 over 8M steps,
   62500-step chunks), each at two chain counts; then the per-chain kernels
   at the same board configuration (``bench._measure --kernel pallas``)
   and at N=15, Q=225 with 8192-step chunks, the per-chain board kernel
   first alone at the main paths' launches (the pod-scale launch and the beyond-reference
   launches at N=16 and N=32, three times each on a fresh state behind a
   spin kernel), each with its share of the bound; then each scan kernel alone at config.yaml's
   launch shape (10 chains, stride 1, 100000 steps, from step 0 and
   900000: microseconds per step; board N=12 and 18, full-3D the beta
   pairs' N=12/Q=144); then both scan kernels, in both
   modes, at 4096 chains (board N=16 over 2^24 steps, full-3D N=12/Q=144
   over 1M).  Then ``python -m mcqueens_torch.bench --quick`` for each
   ``--kernel``, a process each, the four at once: each last line must
   parse, with a positive rate.
6. the measurement tools: ``main(["--quick", "--json", tmp])`` of
   ``mcqueens_torch.tools.probe_full3d_cap``, ``probe_full3d_alternatives``,
   ``probe_swar_sweep`` (both reading this run's fit), ``roofline``,
   ``probe_gather`` and ``probe_slice`` (every probe must say OK and
   correct), the probe launch counts zeroed before and read after; prints
   each JSON.  The memory bandwidth and int32 rates they measured must stay
   below the constants the bounds divide by.  Then ``probe_hold.main`` at
   holds 8, 16 and 32 (1 s each; every hold's energies exact) and
   ``probe_largeN.main`` at N=24 and N=32 (2 s each; the oracle checks), the
   launches counted.

Then one JSON line describing the kernels (the six, the board kernel's
freeze mode on a row of its own, and thirteen probe rows: kernel A's split
between the roofline and the gather and slice tools' three sites, the PRNG
kernel's by generator; their "sites" account for all fifteen
``pallas_call`` sites of the tools; every probe must run at no more than
1.05 of its bound, and none faster than the shared-memory rate), the
``nvidia-smi`` name/power line, and last ``{"ok": true, "device":
{...}}``.
"""

import sys

_PRELOADED = set(sys.modules)

import collections  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mcqueens_torch import bench  # noqa: E402
from mcqueens_torch.chain import board as board_chain  # noqa: E402
from mcqueens_torch.chain import full3d as full3d_chain  # noqa: E402
from mcqueens_torch.chain.spec import ChainSpec  # noqa: E402
from mcqueens_torch.cli import competition  # noqa: E402
from mcqueens_torch.core import fastinit, rng, tables  # noqa: E402
from mcqueens_torch.core.energy import board_energy, full3d_energy  # noqa: E402
from mcqueens_torch.core.schedules import (build_schedule,  # noqa: E402
                                           chunk_betas)
from mcqueens_torch.dist import mesh as mesh_mod  # noqa: E402
from mcqueens_torch.dist import runner  # noqa: E402
from mcqueens_torch.experiments import drivers  # noqa: E402
from mcqueens_torch.experiments.config import load_config, parse_config  # noqa: E402
from mcqueens_torch import tools as port_tools  # noqa: E402
from mcqueens_torch.kernels import (_build, board_shared, full3d_pallas,  # noqa: E402
                                    full3d_shared, metropolis_pallas, probes,
                                    probes_mem)
from mcqueens_torch.tools import (probe_full3d_alternatives,  # noqa: E402
                                  probe_full3d_cap, probe_gather,
                                  probe_slice, probe_swar_sweep, roofline)
from mcqueens_torch.tools import (full3d_floors_campaign,  # noqa: E402
                                  qmax_frontier, qmax_push, verify_board)
from mcqueens_torch.tools import probe_hold, probe_largeN  # noqa: E402
from mcqueens_torch.tools import verify_gpu  # noqa: E402
from mcqueens_torch.tools import qmax as qmax_tool  # noqa: E402
from mcqueens_torch.search import tempering  # noqa: E402
from mcqueens_torch.search.tempering import geometric_ladder  # noqa: E402
from mcqueens_torch.utils import profiling  # noqa: E402
from mcqueens_torch.utils.checkpoint import Checkpointer  # noqa: E402
from pair_scan_slice import full3d_sass_digests  # noqa: E402

KERNELS = {
    board_shared: dict(
        name="board_shared_kernel",
        source="mcqueens_torch/kernels/csrc/board_shared.cu",
        replaces="mcqueens/kernels/board_shared.py:176"),
    full3d_shared: dict(
        name="full3d_shared_kernel",
        source="mcqueens_torch/kernels/csrc/full3d_shared.cu",
        replaces="mcqueens/kernels/full3d_shared.py:135"),
    metropolis_pallas: dict(
        name="metropolis_kernel",
        source="mcqueens_torch/kernels/csrc/metropolis.cu",
        replaces="mcqueens/kernels/metropolis_pallas.py:152"),
    full3d_pallas: dict(
        name="full3d_pallas_kernel",
        source="mcqueens_torch/kernels/csrc/full3d_pallas.cu",
        replaces="mcqueens/kernels/full3d_pallas.py:158"),
    # The scan samplers have no Pallas kernel: JAX compiles them as one XLA
    # scan; "replaces" names the step that scan runs.
    board_chain: dict(
        name="board_scan_kernel",
        source="mcqueens_torch/kernels/csrc/board_scan.cu",
        replaces="mcqueens/chain/board.py:91"),
    full3d_chain: dict(
        name="full3d_scan_kernel",
        source="mcqueens_torch/kernels/csrc/full3d_scan.cu",
        replaces="mcqueens/chain/full3d.py:113"),
}
FREEZE_ROW = dict(name="board_shared_kernel (freeze mode)",
                  source="mcqueens_torch/kernels/csrc/board_shared.cu",
                  replaces="mcqueens/kernels/board_shared.py:176")
SCAN = (board_chain, full3d_chain)
REPO = os.path.dirname(os.path.abspath(__file__))
# The per-chain samplers keep their state chains major, (C, n_bins) bins.
PER_CHAIN = (metropolis_pallas, full3d_pallas)
# int32 lanes an SM issues per clock on both its int32 pipes: kernel C's
# add + or chains (IMAD beside LOP3) ran at 1.8x the ALU pipe's 64 lanes, so
# a bound at one pipe's rate is beatable.
INT32_LANES_PER_SM = port_tools.INT32_ISSUE_LANES_PER_SM
# One threefry2x32 in threefry.cuh: 20 rounds of add, rotate (one funnel
# shift on sm_90) and xor, 5 key injections of 2 adds (IADD3 folds the
# constant), and 3 to set up the key and counter.
THREEFRY_OPS = 20 * 3 + 5 * 2 + 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SMEM_BYTES_PER_SM_CLOCK = 32 * 4  # 32 banks of 4-byte words


nvidia_smi = port_tools.nvidia_smi


def mangled(name):
    """``name`` as a mangled C++ symbol spells it (length, then name), so
    that ``op_probe_kernel`` does not match ``slice_loop_probe_kernel``."""
    return f"{len(name)}{name}"


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


@contextlib.contextmanager
def timed(name):
    t0 = time.perf_counter()
    yield
    phase(name, f"phase took {time.perf_counter() - t0:.1f} s")


def spec_of(N, n_steps, stride, schedule, kernel="pallas_shared", **kw):
    return ChainSpec(N=N, n_steps=n_steps, schedule=schedule,
                     kernel=kernel, history_stride=stride, **kw)


def pspec_of(N, n_steps, stride, schedule, **kw):
    """A spec of the per-chain (independent chains) samplers."""
    return spec_of(N, n_steps, stride, schedule, kernel="pallas", **kw)


def lin(n, b0, b1):
    return build_schedule("linear_annealing", n, beta_start=b0, beta_end=b1)


def const(n, b):
    return build_schedule("constant", n, beta_const=b)


def device_ms(fn, reps=10):
    """Milliseconds per call of ``fn`` on the card alone: a spin kernel of
    about 2.5 ms keeps the card busy while the host queues the events and
    the ``reps`` launches, so no launch waits for the host (a probe of a few
    microseconds takes less than the host needs to launch it)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(5_000_000)
    return cuda_ms(fn, reps, sync=False)


def cuda_ms(fn, reps=1, sync=True):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if sync:
        torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Bounds:
    """Least time the card could take for a launch's work: the largest of
    its bytes (each input read once, each output written once) over the HBM
    rate, its int32 operations over the int32 instruction rate, and the
    shared-memory bytes a kernel that keeps its working set there must load
    and store (each gathered or loaded word and each stored word once) over
    the shared-memory rate: 32 banks x 4 bytes per SM per clock."""

    def __init__(self):
        props = torch.cuda.get_device_properties(0)
        mhz = float(nvidia_smi("clocks.max.sm").split()[0])
        self.int_ops_per_s = props.multi_processor_count * (
            INT32_LANES_PER_SM * mhz * 1e6)
        self.bytes_per_s = HBM_BYTES_PER_S
        self.smem_bytes_per_s = props.multi_processor_count * (
            SMEM_BYTES_PER_SM_CLOCK * mhz * 1e6)
        phase("bound", f"{props.multi_processor_count} SMs x "
              f"{INT32_LANES_PER_SM} int32 lanes x {mhz:.0f} MHz = "
              f"{self.int_ops_per_s:.4e} int32 ops/s; HBM "
              f"{HBM_BYTES_PER_S:.3e} B/s; shared memory "
              f"{props.multi_processor_count} SMs x {SMEM_BYTES_PER_SM_CLOCK}"
              f" B x {mhz:.0f} MHz = {self.smem_bytes_per_s:.4e} B/s")

    def terms(self, ops, nbytes, smem_bytes=0):
        """{term: ms} of the three times."""
        return {"operations": ops / self.int_ops_per_s * 1e3,
                "bytes": nbytes / self.bytes_per_s * 1e3,
                "shared-memory bytes": smem_bytes / self.smem_bytes_per_s
                * 1e3}

    def of(self, ops, nbytes, smem_bytes=0):
        """(bound ms, what bounds it: "operations" or "bytes", the latter
        for device or shared memory)."""
        t = self.terms(ops, nbytes, smem_bytes)
        key = max(t, key=t.get)
        return t[key], "operations" if key == "operations" else "bytes"


def line_cells(N):
    """Off-site cells on the row, column and both diagonals of a site,
    averaged over the N^2 sites (both board kernels draw sites uniformly)."""
    cells = 0
    for i in range(N):
        for j in range(N):
            cells += 2 * (N - 1)
            for x in range(N):
                d = x - i
                cells += (d != 0 and 0 <= j + d < N) + (
                    d != 0 and 0 <= j - d < N)
    return cells / (N * N)


def touched_bins(spec, step0, n):
    """Bins that the steps ``step0 .. step0 + n - 1`` before n_steps fall
    in (a step's bin is monotone in the step)."""
    last = min(step0 + n, spec.n_steps) - 1
    if last < step0:
        return 0

    def bin_of(s):
        return min(s * spec.n_bins // spec.n_steps, spec.n_bins - 1)

    return bin_of(last) - bin_of(step0) + 1


@dataclasses.dataclass
class Launch:
    """What one launch did, read off its state before and after it; the
    bounds count only this work."""

    spec: ChainSpec
    step0: int              # first global step of the launch
    n_steps: int            # steps it covers
    active: torch.Tensor    # (C,) int64 proposals of each chain
    accepted: int           # accepted moves, all chains
    improved: int           # chains that found a new best
    track_best: bool = True
    freeze: bool = False    # a (C,) step-horizon row was read
    n_outer: int = 1        # (n_outer, C) energy rows written (scan kernels)

    @property
    def C(self):
        return int(self.active.shape[0])

    @property
    def proposals(self):
        return int(self.active.sum())

    def common_words(self, scalars):
        """int32 words every launch moves: ``scalars`` per-chain words read
        and written by each chain that steps, a stop/done word of every
        chain (and its freeze horizon), the accept and total words of the
        bins its steps fall in (read and written), the betas."""
        moving = int((self.active > 0).sum())
        bins = touched_bins(self.spec, self.step0, self.n_steps)
        return (2 * scalars * moving + self.C * (1 + self.freeze)
                + 4 * bins * moving + self.n_steps)


def snapshot(st, chains_major):
    """Per-chain (proposals, accepted moves, best step) of a carry or
    segment state, copied; ``chains_major``: its bins are (C, n_bins)."""
    axis = 1 if chains_major else 0
    return (st.total_bins.sum(axis).to(torch.int64),
            st.accept_bins.sum(axis).to(torch.int64),
            st.best_step.reshape(-1).clone())


def launch_of(spec, before, after, step0, n_steps, **mode):
    """The :class:`Launch` between two :func:`snapshot` s."""
    return Launch(spec=spec, step0=step0, n_steps=n_steps,
                  active=after[0] - before[0],
                  accepted=int((after[1] - before[1]).sum()),
                  improved=int((after[2] != before[2]).sum()), **mode)


def board_bytes(ln):
    """Bytes a board launch must move: the cells of each chain's board
    that its proposals read (the site and its lines, at most N^2), one
    word per accepted move, the N^2 best board of each chain that improved
    (track_best only), and the common words with 6 per-chain scalars."""
    N2 = ln.spec.N ** 2
    cells = torch.clamp(ln.active * int(line_cells(ln.spec.N) + 1),
                        max=N2)
    words = (int(cells.sum()) + min(ln.accepted, N2 * ln.C)
             + ln.track_best * ln.improved * N2 + ln.common_words(6))
    return 4 * words


def board_work(ln):
    """(int32 ops, bytes) of one shared-site board launch: 12 ops per
    scored line cell (the site's row, column and both diagonals, averaged
    over the N^2 sites the site hash draws uniformly) plus 32 for the four
    hashes of a step."""
    return ln.proposals * (12 * line_cells(ln.spec.N) + 32), board_bytes(ln)


def metropolis_work(ln):
    """(int32 ops, bytes) of one per-chain board launch, counted from
    ``csrc/metropolis.cu``: 12 ops per scored line cell (the same lines as
    the shared-site kernel), 24 for the three hashes of a step and 16 for
    its site, height and bin arithmetic."""
    return ln.proposals * (12 * line_cells(ln.spec.N) + 40), board_bytes(ln)


def full3d_bytes(ln, occ_words):
    """Bytes a full-3D launch must move: the 3Q coordinates of each chain
    that steps (every proposal scores against all queens), 3 words per
    accepted move, the 3Q best coordinates of each chain that improved,
    ``occ_words`` occupancy words per chain that steps, and the common
    words with 6 per-chain scalars."""
    Q = ln.spec.q_eff
    moving = int((ln.active > 0).sum())
    words = (3 * Q * moving + min(3 * ln.accepted, 3 * Q * ln.C)
             + 3 * Q * ln.improved + occ_words * moving
             + ln.common_words(6))
    return 4 * words


def full3d_pallas_work(ln, per_pair=13, per_queen=3):
    """(ops, bytes) of one per-chain full-3D launch: for each of the Q-1
    other queens, ``per_queen`` ops to unpack its coordinates and
    ``per_pair`` for each of its two targets (the new and the old cell),
    40 for the step's hashes and bookkeeping, and 12 per rejection attempt,
    N^3 / (N^3 - Q) attempts expected; its state holds the occupancy
    bitfield.  The default counts the fewest ops known for the attack test:
    the identity sum r^2 == max|r| * sum|r| (``csrc/full3d_pallas.cu``:
    hits) takes 3 differences, 3 for sum r^2, 2 for sum |r| and 2 maxima
    (abs an operand modifier), the fused product and difference, the
    compare and the count, 13 float32 and int32 ops that the instruction
    rate bounds alike.  ``full3d_pallas_work(ln, 22, 0)`` is the JAX
    kernel's count (:func:`full3d_pallas_jax_ops`)."""
    N, Q = ln.spec.N, ln.spec.q_eff
    attempts = N ** 3 / (N ** 3 - Q)
    ops = ln.proposals * ((2 * per_pair + per_queen) * (Q - 1) + 40
                          + 12 * attempts)
    return ops, full3d_bytes(ln, -(-N ** 3 // 32))


def full3d_pallas_jax_ops(ln):
    """The JAX kernel's count of a per-chain full-3D launch: 22 int32 ops
    a (queen, target) pair, the form of mcqueens/kernels/full3d_pallas.py;
    a second figure beside :func:`full3d_pallas_work`'s bound."""
    return full3d_pallas_work(ln, 22, 0)[0]


def full3d_work(ln):
    """(int32 ops, bytes) of one shared-site full-3D launch: ~22 int32 ops
    per (queen, target) pair, with the targets of a chain the candidates of
    its active steps plus the mover's cell once per chunk of the hold's
    steps (``full3d_shared._HOLD`` as the launch ran; the JAX kernel's
    count, ``docs/DESIGN.md``); occupancy is read off the coordinates."""
    a, hold = ln.active, full3d_shared._HOLD
    targets = int((a + (a + hold - 1) // hold).sum())
    return targets * ln.spec.q_eff * 22, full3d_bytes(ln, 0)


WORK = {board_shared: board_work, full3d_shared: full3d_work,
        metropolis_pallas: metropolis_work,
        full3d_pallas: full3d_pallas_work}


def jax_count_note(mod, ln, bounds, kernel_ms):
    """For the per-chain full-3D kernel, the bound by the JAX kernel's
    count beside the one printed before it; nothing for the others."""
    if mod is not full3d_pallas:
        return ""
    ms = bounds.terms(full3d_pallas_jax_ops(ln), 0)["operations"]
    return (f"; by the JAX kernel's 22 ops a pair {ms:.4f} ms = "
            f"{ms / kernel_ms:.3f}")


def shared_layout(spec, C, track_best, forced=None):
    """The board kernel's layout of a launch of C chains on this card
    (kernels/board_shared.py:layout), or the forced one."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return forced or board_shared.layout(spec.N, C, n_sm, track_best)


def full3d_layout(st, spec, forced=None):
    """The full-3D shared kernel's layout of a launch on ``st`` on this card
    (kernels/full3d_shared.py:layout), or the forced one."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    C = int(st.energy.shape[0])
    return forced or full3d_shared.layout(
        spec.N, spec.q_eff, C, C // int(st.block_seeds.shape[0]), n_sm)


def metropolis_layout(spec, C, forced=None):
    """The per-chain board kernel's layout of a launch of C chains on this
    card (kernels/metropolis_pallas.py:layout), or the forced one."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return forced or metropolis_pallas.layout(spec.N, C, n_sm)


def metropolis_forced(N, lanes, cpb=None):
    """A forced layout of the per-chain board kernel: ``lanes`` lanes a
    chain, ``cpb`` chains a CTA (by default a warp's chains)."""
    cpb = cpb or max(1, 32 // lanes)
    return metropolis_pallas.Layout(
        lanes, cpb, metropolis_pallas.cta_smem_bytes(N, cpb))


def full3d_pallas_layout(spec, C, forced=None):
    """The per-chain full-3D kernel's layout of a launch of C chains on this
    card (kernels/full3d_pallas.py:layout), or the forced one."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return forced or full3d_pallas.layout(spec.N, spec.q_eff, C, n_sm)


def full3d_pallas_forced(spec, lanes, cpb=None):
    """A forced layout of the per-chain full-3D kernel: ``lanes`` lanes a
    chain, ``cpb`` chains a CTA (by default a warp's chains)."""
    cpb = cpb or max(1, 32 // lanes)
    return full3d_pallas.Layout(lanes, cpb, full3d_pallas.cta_smem_bytes(
        spec.q_eff, spec.N, lanes, cpb))


PER_CHAIN_LAYOUT = {metropolis_pallas: metropolis_layout,
                    full3d_pallas: full3d_pallas_layout}


def shared_note(lay):
    """A shared-site kernel's layout, for the compare lines."""
    where = (f"shared memory, {lay.smem_bytes} B a CTA" if lay.in_shared
             else "device memory")
    return (f"; L={lay.lanes} lanes a chain, {lay.chains_per_cta} chains a "
            f"CTA in {where}")


def compare_case(mod, name, spec, n_chains, start_outer=0, seed0=0,
                 ladder=None, freeze=None, forced=None, warm=None):
    """One launch through the kernel and through the twin, on the card, from
    one ``init_carry_batch`` state and one beta tensor; returns a dict with
    max_abs_err, both times, the kernel's state and the launch's work.
    ``freeze`` (board_shared only) maps the padded chain count to the
    chains' step horizons and runs the freeze mode with track_best off;
    ``forced`` (the shared-site kernels) is a layout to launch with instead
    of the rule's; ``warm`` maps the chain count to warm-start states.  The
    kernel is timed on the card alone (behind a spin kernel)."""
    seeds = seed0 + np.arange(n_chains, dtype=np.uint32)
    kw = {} if warm is None else {"initial_states": warm(n_chains)}
    carry = mod.init_carry_batch(seeds, spec, device="cuda", **kw)
    C = int(carry.energy.shape[0])
    step0, n_inner = start_outer * spec.history_stride, spec.history_stride
    beta = chunk_betas(spec.schedule, step0, n_inner, carry.device)
    scale = None
    if ladder is not None:
        scale = torch.from_numpy(np.tile(ladder, -(-C // len(ladder)))[:C]
                                 ).to(carry.device)
    extra = () if scale is None else (scale,)
    mode = {}
    if freeze is not None:
        mode = dict(freeze=torch.as_tensor(
            freeze(C), dtype=torch.int32, device=carry.device),
            track_best=False)
    kmode = dict(mode) if forced is None else dict(mode, forced=forced)
    k_st, t_st = mod.segment_state(carry), mod.segment_state(carry)
    launches = mod.KERNEL_LAUNCHES
    kernel_ms = device_ms(lambda: mod.segment_cuda(
        k_st, step0, n_inner, spec, beta, *extra, **kmode), reps=1)
    # Comparison launches are not the main path's: take this one back.
    mod.KERNEL_LAUNCHES = launches
    twin_ms = cuda_ms(lambda: mod.segment_reference(
        t_st, step0, n_inner, spec, beta, *extra, **mode))
    # The energy after the launch is its history point, so the state fields
    # cover the history too.
    err = 0
    for field in vars(k_st):
        a, b = getattr(k_st, field), getattr(t_st, field)
        if not torch.equal(a, b):
            err = max(err, int((a.long() - b.long()).abs().max()))
            phase("compare", f"{name}: field {field} differs "
                  f"({int((a != b).sum())} entries)")
    if err:
        raise AssertionError(f"kernel != twin on {name}: max abs err {err}")
    ln = launch_of(spec, snapshot(carry, True),
                   snapshot(k_st, mod in PER_CHAIN), step0, n_inner,
                   track_best=freeze is None, freeze=freeze is not None)
    work = WORK[mod](ln)
    lay, note = None, ""
    if mod is board_shared:
        lay = shared_layout(spec, C, freeze is None, forced)
        note = shared_note(lay)
    elif mod is full3d_shared:
        lay = full3d_layout(k_st, spec, forced)
        note = shared_note(lay)
    elif mod in PER_CHAIN:
        lay = PER_CHAIN_LAYOUT[mod](spec, C, forced)
        note = shared_note(lay)
    phase("compare", f"{name}: kernel == twin on all {len(vars(k_st))} "
          f"state fields; {ln.proposals} proposals, {ln.accepted} "
          f"accepted, {ln.improved} chains improved; kernel "
          f"{kernel_ms:.3f} ms, twin {twin_ms:.1f} ms{note}")
    return dict(err=err, kernel_ms=kernel_ms, twin_ms=twin_ms, st=k_st,
                spec=spec, work=work, n_chains=n_chains, layout=lay,
                init=carry, ln=ln)


def check_layout_case(name, res, kw):
    """What each of the board kernel's layout cases is there to show."""
    st, lay, spec = res["st"], res["layout"], res["spec"]
    C = int(st.energy.shape[0])
    if "forced" in kw and lay != kw["forced"]:
        raise AssertionError(f"{name}: launched as {lay}")
    if "device memory" in name and lay.in_shared:
        raise AssertionError(f"{name}: boards in shared memory")
    if "padding" in name and C != 1024:
        raise AssertionError(f"{name}: not padded to 1024")
    if "frozen" in name or "at 0 for half" in name:
        if int(st.total_bins[:, ::2].sum()):
            raise AssertionError(f"{name}: a chain frozen at 0 moved")
    if "patience" in name:
        stops = st.stop_step.cpu().numpy()
        teams = 32 // lay.lanes  # chains a warp
        stopped = stops < spec.n_steps
        warps = {}
        for c in np.flatnonzero(stopped):
            warps.setdefault(c // teams, set()).add(int(stops[c]))
        mixed = sum(len(v) > 1 for v in warps.values())
        inside = int(((stops[stopped] % lay.lanes) != lay.lanes - 1).sum())
        if not mixed or not inside:
            raise AssertionError(f"{name}: {mixed} warps with stops at "
                                 f"different steps, {inside} inside a batch")
        phase("compare", f"{name}: {int(stopped.sum())} chains stopped, "
              f"{mixed} warps with stops at different steps, {inside} "
              f"stops inside a batch of {lay.lanes} draws")
    if "least energy" in name:
        init = res["init"]
        if int(st.best_step.max()) or not torch.equal(
                st.best_heights, init.best_heights.t()):
            raise AssertionError(f"{name}: a chain improved or a best "
                                 f"board was written")
        if not int(st.accept_bins.sum()):
            raise AssertionError(f"{name}: no move was accepted")


def check_full3d_case(name, res, kw):
    """What each of the full-3D shared kernel's layout cases is there to
    show."""
    st, lay, spec = res["st"], res["layout"], res["spec"]
    C = int(st.energy.shape[0])
    if "forced" in kw and lay != kw["forced"]:
        raise AssertionError(f"{name}: launched as {lay}")
    if "device memory" in name and lay.in_shared:
        raise AssertionError(f"{name}: queens in shared memory")
    if "padding" in name and C != 1024:
        raise AssertionError(f"{name}: not padded to 1024")
    if "patience" in name:
        stops = st.stop_step.cpu().numpy()
        teams = 32 // lay.lanes  # chains a warp
        stopped = stops < spec.n_steps
        warps = {}
        for c in np.flatnonzero(stopped):
            warps.setdefault(c // teams, set()).add(int(stops[c]))
        mixed = sum(len(v) > 1 for v in warps.values())
        inside = int(((stops[stopped] % 8) != 7).sum())
        if not mixed or not inside:
            raise AssertionError(f"{name}: {mixed} warps with stops at "
                                 f"different steps, {inside} inside a chunk")
        phase("compare", f"{name}: {int(stopped.sum())} chains stopped, "
              f"{mixed} warps with stops at different steps, {inside} "
              f"stops inside an 8-step chunk")
    if "far behind" in name:
        n = spec.history_stride
        early = int(((st.best_step > 0) & (st.best_step <= n // 2)).sum())
        last = int((st.best_step == n).sum())
        behind = int((st.best_qi != st.qi).any(0).sum())
        if not early or not behind:
            raise AssertionError(f"{name}: {early} chains with their best in "
                                 f"the first half, {behind} behind")
        phase("compare", f"{name}: {early} chains with their best in the "
              f"first half of the launch, {behind} with best planes behind "
              f"the live ones, {last} improved on its last step")
    if "least energy" in name:
        init = res["init"]
        if int(st.best_step.max()) or not torch.equal(
                st.best_qi, init.best_qi.t()):
            raise AssertionError(f"{name}: a chain improved or a best "
                                 f"plane was written")
        if not int(st.accept_bins.sum()):
            raise AssertionError(f"{name}: no move was accepted")


def campaign_chunk_case(bounds):
    """The campaign chunk's shape (N=15, Q=225, 65536 chains, linear 0.8->7
    over 8M steps) at one full 62500-step launch from step 6.25M, the kernel
    alone; its state is checked against the twin on a sample of 128 chains,
    the first 64 of blocks 0 and 31 (the twin of all 65536 chains would take
    hours on the card).  Returns the kernel's ms and the launch's bound."""
    stride, start_outer = 62500, 100
    spec = spec_of(15, 8_000_000, stride, lin(8_000_000, 0.8, 7.0),
                   mcmc_type="full_3d")
    carry = full3d_shared.init_carry_batch(
        np.arange(65536, dtype=np.uint32), spec, device="cuda")
    st = full3d_shared.segment_state(carry)
    step0 = start_outer * stride
    beta = chunk_betas(spec.schedule, step0, stride, "cuda")
    blk = 65536 // int(st.block_seeds.shape[0])
    cols = torch.cat([torch.arange(64), 31 * blk + torch.arange(64)]).cuda()
    sample = full3d_shared.SegmentState(**{
        name: (t.index_select(-1, cols) if name != "block_seeds"
               else t[[0, 31]].clone())
        for name, t in vars(st).items()})
    before = snapshot(st, False)
    launches = full3d_shared.KERNEL_LAUNCHES
    k_ms = device_ms(lambda: full3d_shared.segment_cuda(
        st, step0, stride, spec, beta), reps=1)
    full3d_shared.KERNEL_LAUNCHES = launches
    t0 = time.perf_counter()
    full3d_shared.segment_reference(sample, step0, stride, spec, beta)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    name = "full3d campaign chunk N=15 Q=225 C=65536 62500 steps from 6.25M"
    err = 0
    for field, want in vars(sample).items():
        got = getattr(st, field)
        got = got.index_select(-1, cols) if field != "block_seeds" else \
            got[[0, 31]]
        if not torch.equal(got, want):
            err = max(err, int((got.long() - want.long()).abs().max()))
            phase("compare", f"{name}: field {field} differs on the sample")
    if err:
        raise AssertionError(f"kernel != twin on {name}: max abs err {err}")
    ln = launch_of(spec, before, snapshot(st, False), step0, stride)
    bound_ms, bound_by = bounds.of(*full3d_work(ln))
    phase("compare", f"{name}: kernel == twin on all {len(vars(st))} state "
          f"fields of 128 sampled chains (twin {twin_s:.1f} s); "
          f"{ln.proposals} proposals, {ln.accepted} accepted, {ln.improved} "
          f"chains improved; kernel {k_ms:.1f} ms = "
          f"{stride * 65536 / k_ms * 1e3:.4e} moves/s; bound {bound_ms:.1f} "
          f"ms ({bound_by}) = {bound_ms / k_ms:.3f} of the kernel's time"
          f"{shared_note(full3d_layout(st, spec))}")
    return dict(err=err, kernel_ms=k_ms, bound_ms=bound_ms)


def per_chain_case(mod, name, spec, n_chains, step0=0, seed0=0, forced=None,
                   prior=0, sample=None):
    """One launch of a per-chain kernel (``mod``: ``metropolis_pallas`` or
    ``full3d_pallas``) over ``history_stride`` steps from ``step0``,
    against the twin on the card from one state: the first ``n_chains``
    chains of an ``init_carry_batch`` carry (so C need not be whole
    blocks), first advanced by the kernel over ``prior`` steps from step 0
    when given.  ``sample`` evenly spaced chains are held against the twin
    instead of all (the twin's time is per step, not per chain).  The kernel
    is timed on the card alone (behind a spin kernel); returns a dict like
    :func:`compare_case`'s, with the sample's states."""
    seeds = seed0 + np.arange(n_chains, dtype=np.uint32)
    carry = mod.init_carry_batch(seeds, spec, device="cuda")
    st = mod.SegmentState(**{
        k: v[:n_chains].contiguous()
        for k, v in vars(mod.segment_state(carry)).items()})
    launches = mod.KERNEL_LAUNCHES
    if prior:
        mod.segment_cuda(st, 0, prior, spec,
                         chunk_betas(spec.schedule, 0, prior, "cuda"))
    n = spec.history_stride
    beta = chunk_betas(spec.schedule, step0, n, "cuda")
    idx = torch.arange(n_chains, device="cuda")
    if sample is not None:
        idx = torch.linspace(0, n_chains - 1, sample, device="cuda").long()
    twin = mod.SegmentState(**{
        k: v.index_select(0, idx).contiguous() for k, v in vars(st).items()})
    init = mod.SegmentState(**{k: v.clone() for k, v in vars(twin).items()})
    before = snapshot(st, True)
    kernel_ms = device_ms(lambda: mod.segment_cuda(
        st, step0, n, spec, beta, forced=forced), reps=1)
    # Comparison launches are not the main path's: take them back.
    mod.KERNEL_LAUNCHES = launches
    t0 = time.perf_counter()
    mod.segment_reference(twin, step0, n, spec, beta)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    got = mod.SegmentState(**{
        k: v.index_select(0, idx) for k, v in vars(st).items()})
    err = 0
    for field, want in vars(twin).items():
        a = getattr(got, field)
        if not torch.equal(a, want):
            err = max(err, int((a.long() - want.long()).abs().max()))
            phase("compare", f"{name}: field {field} differs "
                  f"({int((a != want).sum())} entries)")
    if err:
        raise AssertionError(f"kernel != twin on {name}: max abs err {err}")
    ln = launch_of(spec, before, snapshot(st, True), step0, n)
    lay = PER_CHAIN_LAYOUT[mod](spec, n_chains, forced)
    held = "all" if sample is None else f"{sample} sampled"
    phase("compare", f"{name}: kernel == twin on all {len(vars(st))} state "
          f"fields of {held} chains; {ln.proposals} proposals, "
          f"{ln.accepted} accepted, {ln.improved} chains improved; kernel "
          f"{kernel_ms:.3f} ms, twin {twin_ms:.1f} ms{shared_note(lay)}")
    return dict(err=err, kernel_ms=kernel_ms, twin_ms=twin_ms, st=got,
                spec=spec, work=WORK[mod](ln), n_chains=n_chains,
                layout=lay, init=init, step0=step0, ln=ln)


def check_per_chain_case(name, res, kw):
    """What each of the per-chain kernels' design cases is there to show."""
    st, lay, spec = res["st"], res["layout"], res["spec"]
    if "forced" in kw and lay != kw["forced"]:
        raise AssertionError(f"{name}: launched as {lay}")
    if "C=4099" in name and (
            4099 % lay.chains_per_cta == 0 or st.energy.shape[0] != 4099):
        raise AssertionError(f"{name}: no ragged CTA")
    if "inside a batch" in name:
        t = (st.stop_step - res["step0"]).cpu().numpy()
        stopped = st.stop_step.cpu().numpy() < spec.n_steps
        teams = 32 // lay.lanes
        warps = {}
        for c in np.flatnonzero(stopped):
            warps.setdefault(c // teams, set()).add(int(t[c]))
        mixed = sum(len(v) > 1 for v in warps.values())
        inside = int(((t[stopped] % lay.lanes) != lay.lanes - 1).sum())
        bins = int(((st.total_bins - res["init"].total_bins) > 0).sum(1)
                   .max())
        if not inside or (teams > 1 and not mixed) or bins < 2:
            raise AssertionError(f"{name}: {inside} stops inside a batch, "
                                 f"{mixed} mixed warps, {bins} bins")
        phase("compare", f"{name}: {int(stopped.sum())} chains stopped, "
              f"{inside} inside a batch of {lay.lanes} draws, {mixed} warps "
              f"with stops at different steps; up to {bins} bins a chain")
    if "170" in name and spec.N != 170:
        raise AssertionError(f"{name}: N={spec.N}")
    if "long attempt runs" in name:
        share = float(st.accept_bins.sum() / st.total_bins.sum())
        phase("compare", f"{name}: accept share {share:.4f} (1 of 27 cells "
              f"is free: nearly every step takes rounds of attempts past "
              f"the two drawn ahead)")


def run_cli(argv):
    """``competition.main(argv)`` into a fresh directory; returns (stdout,
    the exported i,j,k rows)."""
    with tempfile.TemporaryDirectory() as outdir:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = competition.main(argv + ["--device", "cuda", "--outdir",
                                          outdir])
        (path,) = [os.path.join(root, f) for root, _, files in
                   os.walk(outdir) for f in files]
        rows = np.loadtxt(path, delimiter=",", dtype=np.int64, ndmin=2)
    if rc != 0:
        raise AssertionError(f"competition.main returned {rc}")
    return buf.getvalue(), rows


def reported_best(text):
    return int(re.search(r"Best energies: \[(-?\d+)", text).group(1))


@contextlib.contextmanager
def held(hold):
    """``full3d_shared._HOLD`` set to ``hold`` in the body (the launcher
    and the twin read it at each launch, as the probe of the hold sets
    it)."""
    before = full3d_shared._HOLD
    full3d_shared._HOLD = hold
    try:
        yield
    finally:
        full3d_shared._HOLD = before


def zero_launches():
    for mod in KERNELS:
        mod.KERNEL_LAUNCHES = 0
    board_shared.FREEZE_LAUNCHES = 0
    for counts in (probes.LAUNCHES, probes_mem.LAUNCHES):
        for key in counts:
            counts[key] = 0


def warm_up():
    """One tiny uncounted launch of every kernel, so that no timed launch
    pays for loading its kernel (CUDA loads a kernel lazily at its first
    launch)."""
    t0 = time.perf_counter()
    for mod in KERNELS:
        board = mod in (board_shared, metropolis_pallas, board_chain)
        kernel = ("tables" if mod in SCAN else "pallas_shared"
                  if mod in (board_shared, full3d_shared) else "pallas")
        spec = spec_of(4, 8, 8, const(8, 1.0), kernel=kernel,
                       mcmc_type="board" if board else "full_3d")
        seeds = np.arange(4, dtype=np.uint32)
        init = rng.chain_keys_from_seeds(seeds, "cuda") if mod in SCAN \
            else seeds
        mod.run_segment(mod.init_carry_batch(init, spec, device="cuda"), 0,
                        spec, 1)
    # The board kernel has an instance for each team size, in shared and in
    # device memory: load each one.
    spec = spec_of(4, 8, 8, const(8, 1.0))
    st = board_shared.segment_state(board_shared.init_carry_batch(
        np.arange(4, dtype=np.uint32), spec, device="cuda"))
    beta = chunk_betas(spec.schedule, 0, 8, "cuda")
    for lanes in board_shared.LANES:
        cpb = 32 // lanes
        for smem in (board_shared.cta_smem_bytes(4, cpb, True), 0):
            board_shared.segment_cuda(st, 0, 8, spec, beta,
                                      forced=board_shared.Layout(lanes, cpb,
                                                                 smem))
    # So has the per-chain board kernel, one a team size.
    spec = pspec_of(4, 8, 8, const(8, 1.0))
    st = metropolis_pallas.segment_state(metropolis_pallas.init_carry_batch(
        np.arange(4, dtype=np.uint32), spec, device="cuda"))
    for lanes in metropolis_pallas.LANES:
        metropolis_pallas.segment_cuda(st, 0, 8, spec, beta,
                                       forced=metropolis_forced(4, lanes))
    # So has the per-chain full-3D kernel.
    spec = pspec_of(4, 8, 8, const(8, 1.0), mcmc_type="full_3d")
    st = full3d_pallas.segment_state(full3d_pallas.init_carry_batch(
        np.arange(4, dtype=np.uint32), spec, device="cuda"))
    for lanes in full3d_pallas.LANES:
        full3d_pallas.segment_cuda(
            st, 0, 8, spec, beta, forced=full3d_pallas_forced(spec, lanes))
    # So has the full-3D shared kernel, with six team sizes.
    spec = spec_of(4, 8, 8, const(8, 1.0), mcmc_type="full_3d")
    st = full3d_shared.segment_state(full3d_shared.init_carry_batch(
        np.arange(4, dtype=np.uint32), spec, device="cuda"))
    for lanes in full3d_shared.LANES:
        cpb = max(1, 32 // lanes)
        for smem in (full3d_shared.cta_smem_bytes(spec.q_eff, lanes, cpb), 0):
            full3d_shared.segment_cuda(
                st, 0, 8, spec, beta,
                forced=full3d_shared.Layout(lanes, cpb, smem))
    # and one a team size at each longer hold, on a launch long enough for
    # it
    n = full3d_shared.LONG_LAUNCH
    spec = spec_of(4, n, n, const(n, 1.0), mcmc_type="full_3d")
    st = full3d_shared.segment_state(full3d_shared.init_carry_batch(
        np.arange(4, dtype=np.uint32), spec, device="cuda"))
    beta = chunk_betas(spec.schedule, 0, n, "cuda")
    for hold in full3d_shared.HOLDS[1:]:
        with held(hold):
            for lanes in full3d_shared.LANES:
                cpb = max(1, 32 // lanes)
                for smem in (full3d_shared.cta_smem_bytes(spec.q_eff, lanes,
                                                          cpb), 0):
                    full3d_shared.segment_cuda(
                        st, 0, n, spec, beta,
                        forced=full3d_shared.Layout(lanes, cpb, smem))
    torch.cuda.synchronize()
    zero_launches()
    phase("build", f"one warm-up launch of every kernel: "
          f"{time.perf_counter() - t0:.2f} s")


def check_launches(path, want):
    """The launches of each kernel since :func:`zero_launches` must be the
    ones the path ran (``want``: module -> count, absent means 0)."""
    got = {mod: mod.KERNEL_LAUNCHES for mod in KERNELS}
    for mod, n in got.items():
        if n != want.get(mod, 0):
            raise AssertionError(f"{path}: {KERNELS[mod]['name']} launched "
                                 f"{n} times, expected {want.get(mod, 0)}")
    return got


def board_slice():
    n_runs, n_steps = 32768, 50000
    stride = max(1, n_steps // 1024)
    n_segs, seg_outer = runner.plan_segments(-(-n_steps // stride), n_runs,
                                             stride, min_segments=10)
    zero_launches()
    text, rows = run_cli(["--n", "16", "--n-runs", str(n_runs), "--n-steps",
                          str(n_steps), "--kernel", "pallas_shared"])
    got = check_launches("board slice", {board_shared: n_segs * seg_outer})
    best = np.zeros((16, 16), np.int64)
    best[rows[:, 0], rows[:, 1]] = rows[:, 2]
    reported = reported_best(text)
    rescored = int(board_energy(torch.from_numpy(best)))
    if rescored != reported:
        raise AssertionError(f"exported board scores {rescored}, CLI "
                             f"reported {reported}")
    rate = re.search(r"= ([0-9.e+]+) moves/s", text).group(1)
    phase("slice", f"board competition N=16 runs={n_runs} steps={n_steps} "
          f"stride={stride}: best energy {reported} (oracle re-score "
          f"{rescored}); {got[board_shared]} kernel launches; {rate} "
          f"moves/s reported by the CLI")
    return got[board_shared]


def board_tempered_slice():
    n_runs, n_steps = 32768, 50000
    n_outer = -(-n_steps // max(1, n_steps // 1024))
    zero_launches()
    text, rows = run_cli(["--n", "16", "--n-runs", str(n_runs), "--n-steps",
                          str(n_steps), "--tempering", "16", "--kernel",
                          "pallas_shared"])
    got = check_launches("board tempered slice", {board_shared: n_outer})
    best = np.zeros((16, 16), np.int64)
    best[rows[:, 0], rows[:, 1]] = rows[:, 2]
    reported = reported_best(text)
    rescored = int(board_energy(torch.from_numpy(best)))
    if rescored != reported:
        raise AssertionError(f"tempered board scores {rescored}, CLI "
                             f"reported {reported}")
    rate = re.search(r"= ([0-9.e+]+) moves/s", text).group(1)
    phase("slice", f"board tempered competition N=16 runs={n_runs} "
          f"steps={n_steps} ladder 16: best energy {reported} (oracle "
          f"re-score {rescored}); {got[board_shared]} kernel launches; "
          f"{rate} moves/s reported by the CLI")


def full3d_slice():
    """The floors campaign's fresh search (tools/full3d_floors_campaign.py),
    cut only in steps: 8M -> 125000 (two rounds and one exchange sweep)."""
    N, n_runs, n_steps, stride = 15, 65536, 125000, 62500
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    text, rows = run_cli([
        "--n", str(N), "--mcmc-type", "full_3d", "--n-runs", str(n_runs),
        "--kernel", "pallas_shared", "--tempering", "16",
        "--history-stride", str(stride), "--n-steps", str(n_steps),
        "--beta-start", "0.8", "--beta-end", "7", "--seed", "31337"])
    got = check_launches("full3d slice",
                         {full3d_shared: -(-n_steps // stride)})
    if rows.shape != (N * N, 3) or len({tuple(r) for r in rows}) != N * N:
        raise AssertionError(f"export is not {N * N} distinct cells")
    if rows.min() < 0 or rows.max() >= N:
        raise AssertionError("export has a coordinate outside [0, N)")
    reported = reported_best(text)
    rescored = int(full3d_energy(torch.from_numpy(rows)))
    if rescored != reported:
        raise AssertionError(f"exported placement scores {rescored}, CLI "
                             f"reported {reported}")
    rate = re.search(r"= ([0-9.e+]+) moves/s", text).group(1)
    phase("slice", f"full_3d floors search N={N} runs={n_runs} "
          f"steps={n_steps} stride={stride} ladder 16 (0.8->7): best energy "
          f"{reported} (oracle re-score {rescored}, {N * N} distinct cells); "
          f"{got[full3d_shared]} kernel launches; {rate} moves/s reported "
          f"by the CLI; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    return got[full3d_shared]


def qmax_search():
    """tools/qmax.py's first budget at N=8, Q=48 through the port's
    ``tools.qmax.search`` (the TPU run certified Q_max(8,3) >= 48 with it):
    energy 0 must be reached.  Then ``qmax_frontier.main`` from Q=48 with its
    root in a temporary directory: it must bank a lower bound >= 48 whose
    certificate both oracles score 0."""
    N, Q, n_steps = 8, 48, 1 << 18
    n_outer = 64  # history_stride = n_steps // 64
    zero_launches()
    t0 = time.perf_counter()
    e, best, wall, props = qmax_tool.search(N, Q, n_steps, 5.0)
    got = check_launches("qmax search", {full3d_shared: n_outer})
    rescored = int(full3d_energy(torch.from_numpy(best).cuda()))
    if e != 0 or rescored != 0 or len({tuple(q) for q in best.tolist()}) != Q:
        raise AssertionError(f"Q_max search N={N} Q={Q}: best energy {e}, "
                             f"oracle {rescored}: no certificate")
    phase("slice", f"Q_max search N={N} Q={Q} 4096 chains {n_steps} steps "
          f"(tools.qmax.search): best energy 0 (oracle re-score 0, {Q} "
          f"distinct cells); {got[full3d_shared]} kernel launches; "
          f"{props / wall:.4e} moves/s; wall "
          f"{time.perf_counter() - t0:.3f} s")

    searches, real_search = [], qmax_frontier.search

    def counted(*args, **kw):
        searches.append(args[:4])
        return real_search(*args, **kw)

    with tempfile.TemporaryDirectory() as root:
        qmax_frontier.OUTDIR, qmax_frontier.search = root, counted
        try:
            zero_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as log:
                qmax_frontier.main(["--n", str(N), "--start", str(Q)])
            wall = time.perf_counter() - t0
            got = check_launches("qmax frontier",
                                 {full3d_shared: n_outer * len(searches)})
            with open(os.path.join(root, f"qmax_frontier_N{N}.json")) as f:
                out = json.load(f)
            bound = out["lower_bound"]
            if bound is None or bound < Q:
                raise AssertionError(f"qmax frontier N={N} banked "
                                     f"{bound}, not >= {Q}")
            cert = os.path.join(root, f"qmax_N{N}_Q{bound}.txt")
            rec = verify_board.verify(cert)
            rows = np.loadtxt(cert, delimiter=",", dtype=np.int64, ndmin=2)
            on_card = int(full3d_energy(torch.from_numpy(rows).cuda()))
            if (rec["oracle_energy"], on_card, rec["queens"]) != (0, 0, bound) \
                    or not rec["distinct_cells"]:
                raise AssertionError(f"qmax frontier certificate {rec}, "
                                     f"card re-score {on_card}")
        finally:
            qmax_frontier.OUTDIR, qmax_frontier.search = (qmax_tool.OUTDIR,
                                                          real_search)
    phase("slice", f"Q_max frontier N={N} from Q={Q}: lower_bound {bound}, "
          f"probes_complete {out['probes_complete']}; {len(searches)} "
          f"searches {[a[1:3] for a in searches]}; {got[full3d_shared]} "
          f"kernel launches; certificate re-scored 0 by verify_board and by "
          f"core.energy on the card; wall {wall:.3f} s; "
          f"{log.getvalue().strip().splitlines()[-1]}")


class Killed(Exception):
    """A run stopped on purpose right after a checkpoint was written."""


@contextlib.contextmanager
def checkpoint_probe(kill_at=None):
    """Time every ``Checkpointer`` save that writes (with the npz's bytes)
    and every restore (with the segment it returned, None if refused); with
    ``kill_at``, raise :class:`Killed` right after that segment's save."""
    log = {"saves": [], "restores": []}
    real_save, real_restore = Checkpointer.save, Checkpointer.restore

    def save(self, carry, segments_done, chunks, **kw):
        before = self._last_save_t
        t0 = time.perf_counter()
        real_save(self, carry, segments_done, chunks, **kw)
        if self._last_save_t != before:
            log["saves"].append((segments_done, time.perf_counter() - t0,
                                 os.path.getsize(self.path)))
        if segments_done == kill_at:
            raise Killed(f"killed after segment {segments_done}")

    def restore(self, template, *args, **kw):
        t0 = time.perf_counter()
        out = real_restore(self, template, *args, **kw)
        log["restores"].append((None if out is None else out[1],
                                time.perf_counter() - t0))
        return out

    Checkpointer.save, Checkpointer.restore = save, restore
    try:
        yield log
    finally:
        Checkpointer.save, Checkpointer.restore = real_save, real_restore


def ckpt_note(log):
    saves = ", ".join(f"segment {seg}: {nbytes} B in {dt:.3f} s"
                      for seg, dt, nbytes in log["saves"]) or "none"
    restores = ", ".join(f"{'refused' if seg is None else f'segment {seg}'} "
                         f"in {dt:.3f} s" for seg, dt in log["restores"])
    return f"saves [{saves}]; restores [{restores or 'none'}]"


def qmax_push_slice():
    """tools/qmax_push.py at its full width (N=24, Q=403, 65536 chains, 16
    levels 0.8->9, stride 62500, warm from the committed Q=402 certificate),
    cut only in steps: 8M -> 125000, two rounds.  Run uninterrupted, killed
    right after round 1's checkpoint, and resumed from it: the resumed
    search must equal the uninterrupted one in every array and launch only
    round 2."""
    N, Q, n_steps = 24, 403, 125000
    cert = os.path.join(REPO, "artifacts", "qmax", f"qmax_N{N}_Q{Q - 1}.txt")
    rec = verify_board.verify(cert)
    if (rec["oracle_energy"], rec["queens"]) != (0, Q - 1):
        raise AssertionError(f"committed certificate {rec}")
    outs, real_run = [], qmax_push.tempering_mod.run_tempered
    rounds, real_round = [], full3d_shared.run_segment_tempered

    def recorded(*args, **kw):
        outs.append(real_run(*args, **kw))
        return outs[-1]

    def timed_round(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_round(*args, **kw)
        torch.cuda.synchronize()
        rounds.append(time.perf_counter() - t0)
        return out

    saved = (qmax_push.OUTDIR, qmax_push.N_STEPS)
    walls, launches, logs = {}, {}, {}
    with tempfile.TemporaryDirectory() as root:
        shutil.copy(cert, root)
        qmax_push.OUTDIR, qmax_push.N_STEPS = root, n_steps
        qmax_push.tempering_mod.run_tempered = recorded
        full3d_shared.run_segment_tempered = timed_round
        try:
            for run, ckdir, kill_at in (("a", "ck_a", None),
                                        ("b", "ck_b", 1), ("c", "ck_b", None)):
                zero_launches()
                rounds.clear()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with checkpoint_probe(kill_at) as log, \
                        contextlib.redirect_stdout(io.StringIO()):
                    try:
                        e = qmax_push.push(N, Q, warm=True, checkpoint_dir=(
                            os.path.join(root, ckdir)))[0]
                    except Killed:
                        e = None
                walls[run] = time.perf_counter() - t0
                launches[run] = full3d_shared.KERNEL_LAUNCHES
                logs[run] = log
                phase("slice", f"Q_max push ({run}) N={N} Q={Q} 65536 "
                      f"chains {n_steps} steps: "
                      f"{'killed' if e is None else f'best energy {e}'}; "
                      f"{launches[run]} kernel launches (rounds of "
                      f"{', '.join(f'{t:.3f}' for t in rounds)} s: "
                      f"run_segment_tempered between synchronizes); wall "
                      f"{walls[run]:.3f} s; peak device memory "
                      f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
                      f"GiB; checkpoint {ckpt_note(log)}")
            left = sorted(os.listdir(os.path.join(root, "ck_b")))
        finally:
            qmax_push.OUTDIR, qmax_push.N_STEPS = saved
            qmax_push.tempering_mod.run_tempered = real_run
            full3d_shared.run_segment_tempered = real_round
    want, got = outs  # (b) was killed inside run_tempered
    if want["energy_history"].shape[1] != 3:
        raise AssertionError("the uninterrupted push stopped after round 1: "
                             f"energy {int(want['best_energy'].min())} at "
                             f"Q={Q}, the committed closed edge; the resume "
                             "check cannot run")
    if launches != {"a": 2, "b": 1, "c": 1}:
        raise AssertionError(f"push launches {launches}, want a 2, b 1, c 1")
    if [r[0] for r in logs["c"]["restores"]] != [1]:
        raise AssertionError(f"(c) restored {logs['c']['restores']}, not "
                             "round 1")
    if left:
        raise AssertionError(f"(c) left {left} behind: no clear()")
    for key in want:
        if key != "wall_time" and not np.array_equal(got[key], want[key]):
            raise AssertionError(f"resumed push: {key} differs from the "
                                 "uninterrupted push")
    best = int(want["best_energy"].min())
    phase("slice", f"Q_max push resumed after round 1 == uninterrupted in "
          f"every array ({', '.join(k for k in want if k != 'wall_time')}); "
          f"best energy {best} (Q={Q} stays the closed edge); walls "
          f"a {walls['a']:.3f} s, b+c {walls['b'] + walls['c']:.3f} s")
    return sum(launches.values())


def pod_scale_resume(want):
    """configs/pod_scale.yaml's run with its checkpoint_dir (in a temporary
    directory; mesh dropped) through drivers.run_single_n, killed right
    after 5 of its 10 segments and resumed: the same arrays as the
    uninterrupted run, and only the 5 remaining segments launched."""
    with tempfile.TemporaryDirectory() as ckdir:
        cfg = parse_config({**POD_SCALE, "tpu": {
            **POD_SCALE["tpu"], "checkpoint_dir": ckdir}})
        got, logs = {}, {}
        for run, kill_at in (("killed", 5), ("resumed", None)):
            zero_launches()
            t0 = time.perf_counter()
            with checkpoint_probe(kill_at) as log, \
                    contextlib.redirect_stdout(io.StringIO()):
                try:
                    res = drivers.run_single_n(cfg, device="cuda",
                                               plot=False)["result"]
                except Killed:
                    res = None
            wall = time.perf_counter() - t0
            got[run] = check_launches(f"pod-scale {run}",
                                      {metropolis_pallas: 5 * 4})
            logs[run] = log
            tags = sorted(f for f in os.listdir(ckdir) if f.endswith(".npz"))
            phase("slice", f"pod scale {run} (tpu.checkpoint_dir, {tags}): "
                  f"{got[run][metropolis_pallas]} "
                  f"kernel launches; wall {wall:.3f} s; checkpoint "
                  f"{ckpt_note(log)}")
    if [r[0] for r in logs["resumed"]["restores"]] != [5]:
        raise AssertionError("pod-scale resume did not restore segment 5")
    for field in ("energy_history", "history_steps", "history_len",
                  "final_energy", "final_state", "best_energy", "best_state",
                  "steps_to_best", "stop_step", "accept_bins", "total_bins"):
        if not np.array_equal(getattr(res, field), getattr(want, field)):
            raise AssertionError(f"pod-scale resume: {field} differs")
    phase("slice", "pod scale resumed after 5 of 10 segments == "
          "uninterrupted in every ChainResult array")
    return sum(g[metropolis_pallas] for g in got.values())


def floors_campaign_slice():
    """tools/full3d_floors_campaign.py with its root in a temporary
    directory: full-3D N=15 (65536 chains, Q=225) fresh, confirm and one
    refinement, cut to 125000 steps each; then the board refinement at N=14
    from the committed board floor.  Every exported board is re-scored by
    verify_board, and each campaign.json floor is the least re-score."""
    board14 = os.path.join(REPO, "artifacts", "board_floors",
                           "competition_results",
                           "best_heights_14_20260819_2259.txt")
    runs = ((["--sizes", "15", "--n-steps", "125000", "--max-refines", "1"],
             "full_3d", {full3d_shared: 3 * 2}),
            (["--mcmc-type", "board", "--sizes", "14", "--n-steps", "125000",
              "--max-refines", "1", "--refine-from", board14],
             "board", {board_shared: 2}))
    real_outdir = full3d_floors_campaign._outdir
    total = collections.Counter()
    with tempfile.TemporaryDirectory() as root:
        full3d_floors_campaign._outdir = lambda m: os.path.join(root, m)
        try:
            for argv, kind, want in runs:
                zero_launches()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    full3d_floors_campaign.main(argv)
                wall = time.perf_counter() - t0
                got = check_launches(f"floors campaign {kind}", want)
                with open(os.path.join(root, kind, "campaign.json")) as f:
                    log = json.load(f)
                (rec,) = log.values()
                scores = []
                for s in rec["searches"]:
                    path = s["board"] if os.path.isabs(s["board"]) else \
                        os.path.join(root, kind, "competition_results",
                                     s["board"])
                    v = verify_board.verify(path)
                    if v["oracle_energy"] != s["energy"] or \
                            not v["distinct_cells"]:
                        raise AssertionError(f"floors {kind}: {s} re-scores "
                                             f"{v}")
                    scores.append(v["oracle_energy"])
                if rec["floor"] != min(scores):
                    raise AssertionError(f"floors {kind}: floor "
                                         f"{rec['floor']} != {min(scores)}")
                n_launch = sum(got[m] for m in want)
                total.update({m: got[m] for m in want})
                phase("slice", f"floors campaign {kind} "
                      f"{' '.join(argv[:-2] if kind == 'board' else argv)}: "
                      f"searches {[(s['kind'], s['energy']) for s in rec['searches']]}"
                      f", floor {rec['floor']} (every board re-scored by "
                      f"verify_board); {n_launch} kernel launches; wall "
                      f"{wall:.3f} s")
        finally:
            full3d_floors_campaign._outdir = real_outdir
    return total


def committed_certificates():
    """Every committed artifacts/qmax/qmax_N*_Q*.txt scores 0 on the card
    with Q distinct cells (read, not timed)."""
    names = sorted(f for f in os.listdir(os.path.join(REPO, "artifacts",
                                                      "qmax"))
                   if re.fullmatch(r"qmax_N\d+_Q\d+\.txt", f))
    for name in names:
        Q = int(re.search(r"_Q(\d+)", name).group(1))
        rows = np.loadtxt(os.path.join(REPO, "artifacts", "qmax", name),
                          delimiter=",", dtype=np.int64, ndmin=2)
        e = int(full3d_energy(torch.from_numpy(rows).cuda()))
        if e != 0 or rows.shape != (Q, 3) or \
                len({tuple(r) for r in rows.tolist()}) != Q:
            raise AssertionError(f"{name}: energy {e} on the card, "
                                 f"{rows.shape[0]} queens")
    phase("slice", f"{len(names)} committed certificates "
          f"(artifacts/qmax/qmax_N*_Q*.txt) score 0 on the card with Q "
          f"distinct cells")


def rescore(energy_fn, states, per_call=2 ** 25):
    """Oracle energies of a batch of states, in slices that keep the
    O(cells^2) pair tensors small."""
    states = torch.as_tensor(np.asarray(states)).cuda()
    cells = states[0].numel() // (3 if states.shape[-1] == 3 else 1)
    step = max(1, per_call // (cells * cells))
    return torch.cat([energy_fn(states[i:i + step])
                      for i in range(0, len(states), step)]).cpu().numpy()


@contextlib.contextmanager
def recorded_runs():
    """Every ``runner.run_experiment`` call made by the drivers, with its
    result, so each run's best states can be re-scored."""
    runs, orig = [], runner.run_experiment

    def record(**kw):
        res = orig(**kw)
        runs.append((kw, res))
        return res

    runner.run_experiment = record
    try:
        yield runs
    finally:
        runner.run_experiment = orig


def check_oracle(path, runs, energy_fn):
    """Each run's reported best energies equal the oracle's re-score of its
    best states."""
    for kw, res in runs:
        got = rescore(energy_fn, res.best_state)
        if not np.array_equal(got, res.best_energy):
            raise AssertionError(f"{path}: N={kw['N']} seed "
                                 f"{kw['base_seed']}: best energies differ "
                                 f"from the oracle re-score")


def optional_modules():
    have = []
    for name in ("yaml", "matplotlib", "pandas"):
        try:
            __import__(name)
            have.append(f"{name} yes")
        except ImportError:
            have.append(f"{name} no")
    phase("slice", "config dicts go through parse_config; importable here: "
          + ", ".join(have))


# configs/pod_scale.yaml cut to 2^19 of 5M steps, its mesh dropped (and its
# checkpoint_dir, which pod_scale_resume points into a temporary directory).
POD_SCALE = {
    "experiment_type": "single_N",
    "common": {"n_steps": 1 << 19, "n_runs": 4096, "verbose": True,
               "initialization": "random", "mcmc_type": "board",
               "early_stop_patience": None,
               "betta_scheduling": {"type": "linear_annealing",
                                    "base_seed": 42, "beta_const": 5.0,
                                    "beta_start": 1.0, "beta_end": 5.0},
               "output_path": "figures/pod_energy_history.png"},
    "single_N": {"N": 20},
    "tpu": {"kernel": "pallas", "history_stride": 16384}}


def pod_scale_slice():
    """configs/pod_scale.yaml's run as drivers.run_single_n makes it
    (``POD_SCALE``); returns its launches and result."""
    cfg = parse_config(POD_SCALE)
    n_steps = cfg.n_steps
    N, stride = cfg.section("single_N")["N"], cfg.tpu.history_stride
    n_segs, seg_outer = runner.plan_segments(-(-n_steps // stride),
                                             cfg.n_runs, stride,
                                             min_segments=10)
    schedule = build_schedule("linear_annealing", n_steps, beta_start=1.0,
                              beta_end=5.0)
    zero_launches()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        res = runner.run_experiment(
            N=N, n_steps=n_steps, init_mode=cfg.init_mode, schedule=schedule,
            n_runs=cfg.n_runs, base_seed=42, device="cuda",
            mcmc_type=cfg.mcmc_type,
            early_stop_patience=cfg.early_stop_patience,
            verbose=cfg.verbose, history_stride=stride,
            kernel=cfg.tpu.kernel, n_bins=cfg.tpu.n_bins)
    got = check_launches("pod-scale slice",
                         {metropolis_pallas: n_segs * seg_outer})
    check_oracle("pod-scale slice", [({"N": N, "base_seed": 42}, res)],
                 board_energy)
    if res.energy_history.shape != (4096, n_steps // stride + 1):
        raise AssertionError("pod-scale history has the wrong shape")
    if not (res.total_bins.sum(1) == n_steps).all():
        raise AssertionError("pod-scale runs did not take every step")
    phase("slice", f"pod scale N={N} runs=4096 steps={n_steps} "
          f"stride={stride}: best energy {int(res.best_energy.min())}, mean "
          f"{res.best_energy.mean():.2f} (oracle re-score of all 4096 best "
          f"boards equal); {got[metropolis_pallas]} kernel launches; "
          f"{res.moves_per_sec:.4e} moves/s; last progress line: "
          f"{log.getvalue().strip().splitlines()[-2]}")
    return got[metropolis_pallas], res


def beyond_reference_slice():
    """configs/beyond_reference.yaml's sweep through
    drivers.measure_min_energy_vs_n, cut to 62500 of 8M steps."""
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
    schedule = build_schedule("linear_annealing", n_steps, beta_start=1.0,
                              beta_end=5.5)
    zero_launches()
    with recorded_runs() as runs:
        out = drivers.measure_min_energy_vs_n(
            Ns=params["Ns"], n_steps=n_steps, schedule=schedule,
            init_modes=params["init_modes"], n_runs=cfg.n_runs,
            base_seed=4242, verbose=False, plot=False,
            mcmc_type=cfg.mcmc_type,
            early_stop_patience=cfg.early_stop_patience, tpu=cfg.tpu,
            device="cuda")
    cells = len(params["Ns"]) * len(params["init_modes"])
    got = check_launches("beyond-reference slice", {metropolis_pallas: cells})
    check_oracle("beyond-reference slice", runs, board_energy)
    res = out["results"]
    for idx, N in enumerate(params["Ns"]):
        if N in (17, 19, 23, 29, 31) and (
                res["klarner"]["all_min_energies"][idx].any()):
            raise AssertionError(f"klarner N={N} did not report energy 0")
    table = ", ".join(
        f"{N}: {res['random']['mean_min_energies'][i]:.2f}/"
        f"{res['klarner']['mean_min_energies'][i]:.2f}"
        for i, N in enumerate(params["Ns"]))
    phase("slice", f"beyond-reference sweep 10 N x 2 inits x 128 runs x "
          f"{n_steps} steps: mean best energy random/klarner by N {{{table}}}"
          f"; klarner N in (17, 19, 23, 29, 31) at 0; 2560 best boards "
          f"equal their oracle re-score; {got[metropolis_pallas]} kernel "
          f"launches")
    return got[metropolis_pallas]


def full3d_pairs_slice():
    """config.yaml's beta_start_end_pairs section through
    drivers.run_beta_start_end_pairs with mcmc_type full_3d and kernel
    pallas: n_runs 10 -> 4096, steps 1M -> 2^17, stride 16384."""
    n_steps, stride = 1 << 17, 16384
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
        "tpu": {"kernel": "pallas", "history_stride": stride}})
    params = cfg.section("beta_start_end_pairs")
    n_segs, seg_outer = runner.plan_segments(-(-n_steps // stride),
                                             cfg.n_runs, stride)
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recorded_runs() as runs:
        out = drivers.run_beta_start_end_pairs(
            N=params["N"], n_steps=n_steps,
            beta_start_ends=params["beta_start_ends"],
            annealing_type=params["annealing_type"],
            init_mode=cfg.init_mode, n_runs=cfg.n_runs,
            base_seed=cfg.sched_cfg["base_seed"], verbose=False, plot=False,
            mcmc_type=cfg.mcmc_type,
            early_stop_patience=cfg.early_stop_patience, tpu=cfg.tpu,
            device="cuda")
    wall = time.perf_counter() - t0
    pairs = len(params["beta_start_ends"])
    got = check_launches("full-3D pairs slice",
                         {full3d_pallas: pairs * n_segs * seg_outer})
    check_oracle("full-3D pairs slice", runs, full3d_energy)
    for _, res in runs:
        if any(len({tuple(q) for q in s.tolist()}) != 144
               for s in res.best_state[:64]):
            raise AssertionError("full-3D best placement with shared cells")
    bests = {k: f"{int(v.min())}/{v.mean():.2f}"
             for k, v in out["all_best_energies"].items()}
    props = sum(r.proposals for _, r in runs)
    phase("slice", f"full-3D pairs N=12 Q=144 runs=4096 steps={n_steps} "
          f"stride={stride}: best min/mean by pair {bests} (oracle re-score "
          f"of all 12288 best placements equal); {got[full3d_pallas]} kernel "
          f"launches; {props / wall:.4e} moves/s over the three pairs; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
          f"GiB")
    return got[full3d_pallas]


def scan_work(mod, ln):
    """(int32 ops, bytes) of one scan-kernel launch, counted from
    ``csrc/board_scan.cu`` / ``full3d_scan.cu``: THREEFRY_OPS per threefry
    (18 per board step; 15 per full-3D step plus 6 per extra rejection
    attempt, N^3 / (N^3 - Q) attempts expected), 12 per randint and 30 of
    bookkeeping per step, and the dE: tables 4 per line lookup (24 or 26 a
    step) and 2 per line update of an accepted move; naive 20 per attack
    test, two per other cell or queen.  Bytes: the table words the launch
    gathers and updates (at most the table), the board cells or queen
    coordinates it reads (a whole board or all Q queens for a naive scan
    or an improvement's copy), the accepted moves and best states it
    writes, the occupancy bytes its attempts test, two key words per
    chain, the energy rows and the common words with 6 per-chain
    scalars."""
    spec = ln.spec
    N, C, naive = spec.N, ln.C, spec.kernel == "naive"
    a, moving = ln.active, int((ln.active > 0).sum())
    if mod is board_chain:
        per_step = 18 * THREEFRY_OPS + 3 * 12 + 30
        lines, others = 12, N * N - 1
        T, state = tables.table_size(N), N * N
        read = torch.clamp(a, max=state)     # the site's old height
        moved, occ_bytes = ln.accepted, 0
    else:
        Q, N3 = spec.q_eff, N ** 3
        attempts = N3 / (N3 - Q)
        per_step = ((15 + 6 * (attempts - 1)) * THREEFRY_OPS + 2 * 12 + 30)
        lines, others = 13, Q - 1
        T, state = tables.table_size(N, full3d=True), 3 * Q
        read = torch.clamp(3 * a, max=state)  # the mover's coordinates
        moved = 3 * ln.accepted
        occ_bytes = min(ln.proposals * attempts, N3 * C) + 2 * ln.accepted
    if naive:
        ops = ln.proposals * (per_step + 2 * 20 * others)
        table = 0
        read = torch.where(a > 0, state, 0)
    else:
        ops = ln.proposals * (per_step + 2 * lines * 4) + (
            ln.accepted * 4 * lines)
        table = (min(2 * lines * ln.proposals, T * C)
                 + min(2 * lines * ln.accepted, T * C))
    words = (table + int(read.sum()) + min(moved, state * C)
             + (2 - naive) * state * ln.improved + 2 * C + ln.n_outer * C
             + ln.common_words(6))
    return ops, 4 * words + occ_bytes


def scan_layout(mod, spec, C):
    """A scan kernel's layout of a launch of C chains on this card
    (chain/board.py:scan_layout, chain/full3d.py:scan_layout)."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    if mod is board_chain:
        return board_chain.scan_layout(spec.N, spec.kernel, C, n_sm)
    return full3d_chain.scan_layout(spec.N, spec.q_eff, spec.kernel, C, n_sm)


def layout_note(mod, spec, C):
    """A scan kernel's layout of a launch, for the compare lines."""
    lay = scan_layout(mod, spec, C)
    where = (f"shared memory, {lay.smem_bytes} B a block" if lay.in_shared
             else "device memory")
    return f"; {lay.chains_per_block} chains a block in {where}"


def warm_starts(mod, spec, C, seed):
    """Random warm starts: boards, or Q distinct cells per placement."""
    rs = np.random.default_rng(seed)
    N = spec.N
    if mod is board_chain:
        return rs.integers(0, N, size=(C, N, N)).astype(np.int32)
    cells = np.stack([rs.permutation(N ** 3)[:spec.q_eff] for _ in range(C)])
    return np.stack([cells // (N * N), cells // N % N, cells % N],
                    axis=-1).astype(np.int32)


def scan_compare(mod, name, spec, n_chains, start_outer, n_outer, seed0=0,
                 warm=False):
    """One segment of ``n_outer`` chunks through a scan kernel and through
    its twin, on the card, in both modes from one state each, every field
    and the ys rows equal; then the two modes' kernel states equal (all but
    the table).  Returns the per-mode results."""
    keys = rng.chain_keys_from_seeds(
        seed0 + np.arange(n_chains, dtype=np.uint32), "cuda")
    starts = warm_starts(mod, spec, n_chains, seed0) if warm else None
    out = {}
    launches = mod.KERNEL_LAUNCHES
    for kern in ("tables", "naive"):
        sp = dataclasses.replace(spec, kernel=kern)
        carry = mod.init_carry_batch(keys, sp, starts, device="cuda")
        if start_outer:
            carry, _ = mod.run_segment(carry, 0, sp, start_outer)
        k_st, t_st = mod.segment_state(carry), mod.segment_state(carry)
        stride = sp.history_stride
        beta = chunk_betas(sp.schedule, start_outer * stride,
                           n_outer * stride, carry.device)
        yk = torch.zeros((n_outer, n_chains), dtype=torch.int32,
                         device="cuda")
        yt = torch.zeros_like(yk)
        kernel_ms = cuda_ms(lambda: mod.segment_cuda(
            k_st, yk, start_outer, n_outer, sp, beta))
        twin_ms = cuda_ms(lambda: mod.segment_reference(
            t_st, yt, start_outer, n_outer, sp, beta))
        err = 0
        for field, a in list(vars(k_st).items()) + [("ys", yk)]:
            b = yt if field == "ys" else getattr(t_st, field)
            if a is None and b is None:
                continue
            if not torch.equal(a, b):
                err = max(err, int((a.long() - b.long()).abs().max()))
                phase("compare", f"{name} {kern}: field {field} differs "
                      f"({int((a != b).sum())} entries)")
        if err:
            raise AssertionError(f"kernel != twin on {name} {kern}: max abs "
                                 f"err {err}")
        ln = launch_of(sp, snapshot(carry, True), snapshot(k_st, False),
                       start_outer * stride, n_outer * stride,
                       n_outer=n_outer)
        work = scan_work(mod, ln)
        phase("compare", f"{name} {kern}: kernel == twin on all fields and "
              f"ys; {ln.proposals} proposals, {ln.accepted} accepted, "
              f"{ln.improved} chains improved, {int(k_st.done.sum())} "
              f"chains stopped; kernel {kernel_ms:.3f} ms, twin "
              f"{twin_ms:.1f} ms{layout_note(mod, sp, n_chains)}")
        out[kern] = dict(err=err, kernel_ms=kernel_ms, twin_ms=twin_ms,
                         st=k_st, ys=yk, spec=sp, work=work,
                         n_chains=n_chains, mod=mod)
    mod.KERNEL_LAUNCHES = launches
    for field, a in vars(out["tables"]["st"]).items():
        b = getattr(out["naive"]["st"], field)
        if field != "table" and not torch.equal(a, b):
            raise AssertionError(f"{name}: tables != naive on the card in "
                                 f"{field}")
    if not torch.equal(out["tables"]["ys"], out["naive"]["ys"]):
        raise AssertionError(f"{name}: tables != naive on the card in ys")
    phase("compare", f"{name}: tables == naive on the card")
    return out


def recover_slice():
    """The freeze mode's path at the board CLI configuration (N=16, 32768
    chains, 50000 steps, linear 1->3, stride 48): run_segment with
    track_best on, then off, then recover_best_heights on the untracked
    run.  Returns the replay's launches and the three times."""
    N, C, n_steps, stride = 16, 32768, 50000, 48
    spec = spec_of(N, n_steps, stride, lin(n_steps, 1.0, 3.0))
    seeds = 42 + np.arange(C, dtype=np.uint32)
    n_outer = spec.n_outer

    def run(track_best):
        carry = board_shared.init_carry_batch(seeds, spec, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = board_shared.run_segment(carry, 0, spec, n_outer,
                                          track_best=track_best)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    tracked, t_on = run(True)
    zero_launches()
    untracked, t_off = run(False)
    t0 = time.perf_counter()
    rec = board_shared.recover_best_heights(untracked, spec)
    torch.cuda.synchronize()
    t_rec = time.perf_counter() - t0
    replay = min(n_outer, max(1, -(-int(untracked.best_step.max())
                                   // stride)))
    got = check_launches("recover slice", {board_shared: n_outer + 1})
    if board_shared.FREEZE_LAUNCHES != 1:
        raise AssertionError(f"recover slice: {board_shared.FREEZE_LAUNCHES}"
                             f" freeze-mode launches, expected 1")
    for field in ("energy", "best_energy", "best_step", "no_improve",
                  "stop_step", "heights", "accept_bins", "total_bins"):
        if not torch.equal(getattr(tracked, field), getattr(untracked,
                                                            field)):
            raise AssertionError(f"recover slice: track_best changed "
                                 f"{field}")
    if not torch.equal(rec, tracked.best_heights.reshape(C, N, N)):
        bad = int((rec != tracked.best_heights.reshape(C, N, N)).any(
            2).any(1).sum())
        raise AssertionError(f"recover slice: {bad} recovered boards differ "
                             f"from the tracked ones")
    rescored = rescore(board_energy, rec.cpu().numpy())
    best = tracked.best_energy.reshape(-1).cpu().numpy()
    if not np.array_equal(rescored, best):
        raise AssertionError("recover slice: recovered boards do not score "
                             "their best energies")
    phase("slice", f"recover N={N} chains={C} steps={n_steps} stride="
          f"{stride}: run_segment track_best on {t_on:.3f} s "
          f"({t_on / n_outer * 1e3:.3f} ms per chunk), off {t_off:.3f} s "
          f"({t_off / n_outer * 1e3:.3f} ms per chunk); recover_best_heights"
          f" {t_rec:.3f} s ({replay} chunks replayed to max best_step "
          f"{int(untracked.best_step.max())}); all {C} recovered boards == "
          f"tracked boards, oracle re-score == best energy (min "
          f"{int(best.min())}); {got[board_shared]} kernel launches, "
          f"1 in freeze mode")
    return dict(launches=1, t_on=t_on, t_off=t_off, t_rec=t_rec)


def check_chunk_betas():
    """The recover replay evaluates a run's betas in one call: each step's
    beta must not depend on the chunk it was evaluated in, for every
    schedule kind on the card."""
    for kind, kw in (("linear_annealing", dict(beta_start=1.0, beta_end=3.0)),
                     ("exponential_annealing",
                      dict(beta_start=0.5, beta_end=5.0)),
                     ("logarithmic_annealing",
                      dict(beta_start=0.5, beta_end=5.0)),
                     ("sinusoidal_annealing",
                      dict(beta_start=0.5, beta_end=5.0)),
                     ("constant", dict(beta_const=2.0))):
        for n, stride in ((50000, 48), (2 ** 24, 32768), (1000003, 977)):
            sched = build_schedule(kind, n, **kw)
            n_outer = min(-(-n // stride), 1042)
            whole = chunk_betas(sched, 0, n_outer * stride, "cuda")
            parts = torch.cat([chunk_betas(sched, o * stride, stride, "cuda")
                               for o in range(n_outer)])
            if not torch.equal(whole, parts):
                raise AssertionError(f"{kind} n={n} stride={stride}: betas "
                                     f"depend on the chunk")
    phase("slice", "chunk_betas over a run == chunk by chunk, every "
          "schedule kind")


def check_scan_runs(path, runs, energy_fn, n_steps):
    """Every recorded run took every step, has a full history and reports
    best energies equal to its best states' oracle re-score."""
    check_oracle(path, runs, energy_fn)
    for kw, res in runs:
        if res.energy_history.shape != (kw["n_runs"], n_steps + 1):
            raise AssertionError(f"{path}: history shape "
                                 f"{res.energy_history.shape}")
        if not (res.total_bins.sum(1) == n_steps).all():
            raise AssertionError(f"{path}: a run did not take every step")


def config_yaml_slice():
    """config.yaml as committed (compare_beta_end: N 12 and 18, pairs 1->3
    and 1->5, exponential, 10 runs, 1M steps, stride 1, kernel tables,
    verbose) through drivers.run_from_config, figures off."""
    cfg = load_config(os.path.join(REPO, "config.yaml"))
    params = cfg.section("compare_beta_end")
    n_segs, seg_outer = runner.plan_segments(
        cfg.n_steps, cfg.n_runs, cfg.tpu.history_stride,
        min_segments=10 if cfg.verbose else 1)
    zero_launches()
    t0 = time.perf_counter()
    with recorded_runs() as runs, tempfile.TemporaryDirectory() as outdir, \
            contextlib.redirect_stdout(io.StringIO()):
        drivers.run_from_config(cfg, outdir=outdir, device="cuda",
                                plot=False)
    wall = time.perf_counter() - t0
    cells = 2 * len(params["beta_start_ends"])
    got = check_launches("config.yaml slice",
                         {board_chain: cells * n_segs})
    check_scan_runs("config.yaml slice", runs, board_energy, cfg.n_steps)
    table = "; ".join(
        f"N={kw['N']} beta {kw['schedule'].beta_start}->"
        f"{kw['schedule'].beta_end}: best min {int(res.best_energy.min())} "
        f"mean {res.best_energy.mean():.1f}, {res.wall_time:.2f} s, "
        f"{res.moves_per_sec:.4e} moves/s" for kw, res in runs)
    phase("slice", f"config.yaml {cfg.experiment_type} kernel "
          f"{cfg.tpu.kernel} runs={cfg.n_runs} steps={cfg.n_steps} stride "
          f"{cfg.tpu.history_stride} (uncut): {table}; all "
          f"{cells * cfg.n_runs} best boards == oracle re-score; "
          f"{got[board_chain]} kernel launches ({n_segs} segments of "
          f"{seg_outer} chunks per cell); phase {wall:.2f} s")
    return got[board_chain]


def full3d_tables_pairs_slice():
    """config.yaml's beta_start_end_pairs section (N=12, three linear
    pairs, 10 runs, 1M steps, stride 1, kernel tables) as full_3d."""
    cfg = load_config(os.path.join(REPO, "config.yaml"))
    params = cfg.section("beta_start_end_pairs")
    n_segs, _ = runner.plan_segments(
        cfg.n_steps, cfg.n_runs, cfg.tpu.history_stride,
        min_segments=10 if cfg.verbose else 1)
    zero_launches()
    t0 = time.perf_counter()
    with recorded_runs() as runs, contextlib.redirect_stdout(io.StringIO()):
        drivers.run_beta_start_end_pairs(
            N=params["N"], n_steps=cfg.n_steps,
            beta_start_ends=params["beta_start_ends"],
            annealing_type=params["annealing_type"],
            init_mode=cfg.init_mode, n_runs=cfg.n_runs,
            base_seed=cfg.sched_cfg["base_seed"], verbose=cfg.verbose,
            plot=False, mcmc_type="full_3d",
            early_stop_patience=cfg.early_stop_patience, tpu=cfg.tpu,
            device="cuda")
    wall = time.perf_counter() - t0
    pairs = len(params["beta_start_ends"])
    got = check_launches("full-3D tables pairs slice",
                         {full3d_chain: pairs * n_segs})
    check_scan_runs("full-3D tables pairs slice", runs, full3d_energy,
                    cfg.n_steps)
    Q = params["N"] ** 2
    for _, res in runs:
        if any(len({tuple(q) for q in s.tolist()}) != Q
               for s in res.best_state):
            raise AssertionError("full-3D best placement with shared cells")
    table = "; ".join(
        f"beta {kw['schedule'].beta_start}->{kw['schedule'].beta_end}: best "
        f"min {int(res.best_energy.min())} mean "
        f"{res.best_energy.mean():.1f}, {res.moves_per_sec:.4e} moves/s"
        for kw, res in runs)
    phase("slice", f"config.yaml beta pairs as full_3d N={params['N']} "
          f"Q={Q} kernel {cfg.tpu.kernel} runs={cfg.n_runs} "
          f"steps={cfg.n_steps} stride {cfg.tpu.history_stride} (uncut): "
          f"{table}; all {pairs * cfg.n_runs} best placements == oracle "
          f"re-score; {got[full3d_chain]} kernel launches; phase "
          f"{wall:.2f} s")
    return got[full3d_chain]


def scan_throughput(mod, label, spec, chains, bounds):
    """Proposed moves/s of a scan kernel in both modes: run_segment calls
    of one chunk each for >= 2 s, then one launch alone (CUDA events)."""
    stride = spec.history_stride
    for kern in ("tables", "naive"):
        sp = dataclasses.replace(spec, kernel=kern)
        keys = rng.chain_keys_from_seeds(np.arange(chains, dtype=np.uint32),
                                         "cuda")
        carry = mod.init_carry_batch(keys, sp, device="cuda")
        carry, _ = mod.run_segment(carry, 0, sp, 1)
        torch.cuda.synchronize()
        seg, t0 = 1, time.perf_counter()
        while True:
            carry, _ = mod.run_segment(carry, seg, sp, 1)
            seg += 1
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            if elapsed >= 2.0:
                break
        rate = (seg - 1) * stride * chains / elapsed
        st = mod.segment_state(carry)
        beta = chunk_betas(sp.schedule, seg * stride, stride,
                           st.energy.device)
        ys = torch.empty((1, chains), dtype=torch.int32, device="cuda")
        before = snapshot(st, False)
        k_ms = cuda_ms(lambda: mod.segment_cuda(st, ys, seg, 1, sp, beta))
        ln = launch_of(sp, before, snapshot(st, False), seg * stride,
                       stride)
        bound_ms, bound_by = bounds.of(*scan_work(mod, ln))
        phase("throughput", f"{label} {kern} chains={chains}: {rate:.4e} "
              f"proposed moves/s over {seg - 1} x {stride}-step run_segment "
              f"calls ({elapsed:.2f} s); kernel alone {k_ms:.1f} ms per "
              f"{stride}-step chunk = {stride * chains / k_ms * 1e3:.4e} "
              f"moves/s; bound {bound_ms:.2f} ms ({bound_by}) = "
              f"{bound_ms / k_ms:.3f} of the kernel's time")
    phase("throughput", "nvidia-smi clocks.sm,power.draw,temperature.gpu: "
          + nvidia_smi("clocks.sm,power.draw,temperature.gpu"))


def scan_config_launch(mod, bounds):
    """A scan kernel alone at config.yaml's launch shape (10 chains, stride
    1, 100000 steps: a tenth of a cell), from step 0 and from step 900000:
    microseconds per step.  Board: compare_beta_end's N=12 and 18
    (exponential 1->3, 1->5); full-3D: beta_start_end_pairs as full_3d
    (N=12, Q=144, linear 0.5->3)."""
    n, steps = 10 ** 6, 100_000
    if mod is board_chain:
        name, specs = "board_scan", [spec_of(N, n, 1, build_schedule(
            "exponential_annealing", n, beta_start=1.0, beta_end=beta_end),
            kernel="tables") for N, beta_end in ((12, 3.0), (18, 5.0))]
    else:
        name, specs = "full3d_scan", [spec_of(
            12, n, 1, lin(n, 0.5, 3.0), kernel="tables",
            mcmc_type="full_3d")]
    keys = rng.chain_keys_from_seeds(np.arange(10, dtype=np.uint32), "cuda")
    for spec in specs:
        for start in (0, 900_000):
            st = mod.segment_state(mod.init_carry_batch(keys, spec,
                                                        device="cuda"))
            beta = chunk_betas(spec.schedule, start, steps, "cuda")
            ys = torch.empty((steps, 10), dtype=torch.int32, device="cuda")
            before = snapshot(st, False)
            k_ms = cuda_ms(lambda: mod.segment_cuda(st, ys, start, steps,
                                                    spec, beta))
            ln = launch_of(spec, before, snapshot(st, False), start, steps,
                           n_outer=steps)
            bound_ms, bound_by = bounds.of(*scan_work(mod, ln))
            phase("throughput", f"{name} config.yaml launch N={spec.N} "
                  f"Q={spec.q_eff if mod is full3d_chain else '-'} C=10 "
                  f"{steps} steps from step {start}: {k_ms:.3f} ms = "
                  f"{k_ms * 1e3 / steps:.4f} us per step; bound "
                  f"{bound_ms:.4f} ms ({bound_by}); {ln.accepted} accepted"
                  f"{layout_note(mod, spec, 10)}")


def throughput(mod, label, spec, chain_counts, bounds):
    seg_steps = spec.history_stride
    for chains in chain_counts:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        carry = mod.init_carry_batch(np.arange(chains, dtype=np.uint32),
                                     spec, device="cuda")
        torch.cuda.synchronize()
        phase("throughput", f"{label} chains={chains}: init_carry_batch "
              f"{time.perf_counter() - t0:.3f} s, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        carry, _ = mod.run_segment(carry, 0, spec, 1)
        torch.cuda.synchronize()
        seg, t0 = 1, time.perf_counter()
        while True:
            carry, _ = mod.run_segment(carry, seg, spec, 1)
            seg += 1
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            if elapsed >= 3.0:
                break
        rate = (seg - 1) * seg_steps * chains / elapsed
        st = mod.segment_state(carry)
        beta = chunk_betas(spec.schedule, seg * seg_steps, seg_steps,
                           st.energy.device)
        before = snapshot(st, mod in PER_CHAIN)
        k_ms = cuda_ms(lambda: mod.segment_cuda(
            st, seg * seg_steps, seg_steps, spec, beta))
        ln = launch_of(spec, before, snapshot(st, mod in PER_CHAIN),
                       seg * seg_steps, seg_steps)
        bound_ms, bound_by = bounds.of(*WORK[mod](ln))
        phase("throughput", f"{label} chains={chains}: {rate:.4e} proposed "
              f"moves/s over {seg - 1} x {seg_steps}-step run_segment calls "
              f"({elapsed:.2f} s); kernel alone {k_ms:.1f} ms per "
              f"{seg_steps}-step chunk = "
              f"{seg_steps * chains / k_ms * 1e3:.4e} moves/s; bound "
              f"{bound_ms:.1f} ms ({bound_by}) = {bound_ms / k_ms:.3f} of "
              f"the kernel's time{jax_count_note(mod, ln, bounds, k_ms)}")
    phase("throughput", "nvidia-smi clocks.sm,power.draw,temperature.gpu: "
          + nvidia_smi("clocks.sm,power.draw,temperature.gpu"))


def metropolis_table(bounds):
    """The per-chain board kernel alone at the main paths' launches, each on
    a fresh state behind a spin kernel, three times after one untimed
    launch: the pod-scale launch (N=20, 4096 chains, the second 16384-step
    chunk of linear 1->5 over 5M) and the beyond-reference launch (128
    chains, 62500 steps from step 0, linear 1->5.5 over 8M) at N=16 and
    N=32; each with its layout and its share of the bound."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for label, N, horizon, b1, stride, chains, prior, seed0 in (
            ("pod-scale launch", 20, 5_000_000, 5.0, 16384, 4096, 16384, 42),
            ("beyond-reference launch", 16, 8_000_000, 5.5, 62500, 128, 0,
             4242),
            ("beyond-reference launch", 32, 8_000_000, 5.5, 62500, 128, 0,
             4242)):
        spec = pspec_of(N, horizon, stride, lin(horizon, 1.0, b1))
        carry = metropolis_pallas.init_carry_batch(
            seed0 + np.arange(chains, dtype=np.uint32), spec, device="cuda")
        if prior:
            carry, _ = metropolis_pallas.run_segment(carry, 0, spec, 1)
        beta = chunk_betas(spec.schedule, prior, stride, "cuda")
        times = []
        for rep in range(4):
            st = metropolis_pallas.segment_state(carry)
            before = snapshot(st, True)
            ms = device_ms(lambda: metropolis_pallas.segment_cuda(
                st, prior, stride, spec, beta), reps=1)
            if rep:
                times.append(ms)
        ln = launch_of(spec, before, snapshot(st, True), prior, stride)
        bound_ms, bound_by = bounds.of(*metropolis_work(ln))
        lay = metropolis_pallas.layout(N, chains, n_sm)
        phase("throughput", f"metropolis {label} N={N} C={chains} {stride} "
              f"steps from {prior}: kernel alone "
              f"{', '.join(f'{t:.3f}' for t in times)} ms = "
              f"{min(times) / stride * 1e3:.4f} us a step; bound "
              f"{bound_ms:.3f} ms ({bound_by}) = {bound_ms / min(times):.3f} "
              f"of the kernel's time{shared_note(lay)}")


def sass_text():
    """``cuobjdump -sass`` of the built kernel library."""
    from torch.utils.cpp_extension import CUDA_HOME

    return subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
         str(_build.library_path())],
        capture_output=True, text=True, check=True, timeout=300).stdout


# The scan samplers' kernels, which include csrc/threefry.cuh: their SASS
# digest is printed so that a change to the threefry code of the probes
# can be shown to leave them as they were (pair_scan_slice.py --only probes
# prints the same digest for two checkouts).
SCAN_KERNELS = ("board_scan_kernel", "full3d_scan_kernel")


def scan_sass_digest(text):
    """sha256 (16 hex digits) of the instructions of every instance of the
    scan kernels, and the number of instances.  A name is hashed from the
    kernel's on (its template arguments): nvcc names an anonymous
    namespace after the source's path, which differs between checkouts."""
    import hashlib

    h, n, keep = hashlib.sha256(), 0, False
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = next((k for k in SCAN_KERNELS if mangled(k) in m.group(1)),
                     None)
            keep = k is not None
            n += keep
            if keep:
                h.update(m.group(1).split(mangled(k), 1)[1].encode())
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", line)
        if keep and ins:
            h.update(re.sub(r"_Z\w+", "_Z", ins.group(1)).encode())
    return h.hexdigest()[:16], n


def sass_loops(text):
    """Innermost loops of each probe kernel instance in the built library
    (``cuobjdump -sass`` text): ``{(kernel, template args): [Counter of the
    opcodes of one loop body, ...]}``, a loop being the instructions from a
    backward branch's target to the branch."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = next((p for p in LOOP_FUNCS.values()
                         if mangled(p) in m.group(1)), None)
            args = m.group(1).split(name, 1)[1] if name else ""
            cur = (name, tuple(int(v) for v in re.findall(r"L[ib](\d+)E",
                                                           args)))
            funcs[cur] = [] if name else None
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m and cur and funcs.get(cur) is not None:
            funcs[cur].append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for key, ins in funcs.items():
        if not ins:
            continue
        loops = []
        for addr, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) <= addr:
                loops.append((int(t.group(1), 16), addr))
        inner = [lp for lp in loops if not any(
            o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        out[key] = [collections.Counter(
            op.split(".")[0] for a, op, _ in ins if lo <= a <= hi)
            for lo, hi in inner]
    return out


# Evaluations one trip of each probe's hot loop makes, by its template
# arguments and the loop's opcodes: A and C unroll 32 and 8 doublings or
# ops of K chains, B one trip of K chains, D one row against the 9 targets.
LOOP_EVALS = {"vpu": lambda t, b: 32 * t[0], "test": lambda t, b: t[0],
              "op": lambda t, b: 8 * t[0], "sweep": lambda t, b: 9,
              # the gather chain: one store per element and step (axis 0: a
              # step of E elements a thread; axis 1: two steps of the
              # schedule's slots, empty slots predicated off); the slice
              # loop and the staged reduce (ROWS = 0) unroll 16 rows, the
              # register reduce walks its ROWS rows once a trip; a step's
              # draws, 1 word a thread (lowbias32) or 4 (threefry)
              "gather_chain": lambda t, b: b["STS"],
              "slice_loop": lambda t, b: 16,
              "reduce": lambda t, b: t[0] or 16,
              "prng": lambda t, b: probes_mem.PRNG_WORDS[
                  probes_mem.PRNG_MODES[t[0]]]}
# int32 operations of one evaluation as the TPU function writes it (each
# elementwise jnp operation one, constant expressions none), the yardstick
# of the samplers' bounds too:
#   A (roofline.py:100) a + a: 1.
#   C (probe_full3d_alternatives.py:194) the op and its | 1: 2.
#   B (probe_full3d_alternatives.py:74) xi ^ a and a + fn(...): 2, plus fn:
#     production 21 (3 deltas, 3 squares, 2 max, 3 subtractions, 3 products
#     and 2 ors for t, 2 compares, 2 selects, 1 add); nomul 26 (3 deltas,
#     3 negations, 3 max for |d|, 2 max, 6 compares, 3 ors and 2 ands, then
#     1 compare, 2 selects, 1 add); swar 101 (3 biased adds; 6 eq_halves of
#     8 ops; 3 smax of 11 ops with their 128 - d; 3 ands + 2 ors, 3 + 3,
#     1 + 1 and the & _ONES of att).
#   D (probe_swar_sweep.py:119) per (row, target): production 22 (3 deltas,
#     prod_scores 18, the accumulate); swar 105 (3 biased adds, swar_scores
#     100 with its occupancy's 2 ands, the two accumulates).  The 9 targets'
#     hashes are per chunk, not per column, and left out: leaving work out
#     only lowers a bound.
#   gather chain (probe_gather.py:84) per (word, step) the take and the + 1:
#     2 (and a gathered load and a store, charged as shared-memory bytes).
#   slice loop (probe_slice.py:105) per (row word, step) blk + acc: 1 (and
#     a load and a store); the offset and acc + 1 are per step, not per word.
#   reduce (probe_slice.py:174) per (row word, step) x + acc and the sum: 2.
#     The register instances issue one IADD3 for both, exactly half: the
#     check below fails only under half, so they pass at equality (plus
#     the loop's own few instructions).
#   PRNG draws (probe_slice.py:194, the port's generators as
#     mcqueens/kernels/prng.py and core/rng.py write them), counted as the
#     uint32 operations they need, as THREEFRY_OPS counts a rotate as one
#     funnel shift: lowbias32 30 (g ^ step*K, three lowbias32 of 8, three
#     shift-xor pairs and two products, the ^ W0, + W1, & 0x7FFFFFFF, w0 +
#     w1 and the accumulate; the & masks of prng.py's _shr stand in for a
#     logical shift that int32 jnp lacks, and are not counted); threefry 75
#     (one threefry2x32 of 73, the x0 ^ x1 and the accumulate; the step's
#     fold_in is once per step for the whole array).
PROBE_OPS = {"vpu": {None: 1}, "op": {None: 2},
             "test": {"production": 23, "nomul": 28, "swar": 103},
             "sweep": {"production": 22, "swar": 105},
             "gather_chain": {None: 2}, "slice_loop": {None: 1},
             "reduce": {None: 2},
             "prng": {"lowbias32": 30, "threefry": 75}}
# SASS that issues no int32 arithmetic: branches and barriers, loads and
# stores, and the uniform datapath (one per warp: the loop's scalars).
NOT_INT32 = ("BRA", "EXIT", "NOP", "BSSY", "BSYNC", "BAR", "WARPSYNC", "LD",
             "ST", "S2R", "CS2R", "U")
# The pipe an sm_90 sub-partition issues an opcode on, as NVIDIA's
# throughput tables put them (an attribution, not a measurement): IMAD and
# float arithmetic on the FMA pipe, shared-memory accesses and shuffles
# through MIO, what NOT_INT32 lists apart, the rest on the ALU pipe.
FMA_PIPE = ("IMAD", "FFMA", "FADD", "FMUL")
MIO = ("LDS", "STS", "SHFL")
# Kernel A's hot loop keeps both int32 pipes busy (half its doublings
# IADD3, half IMAD), and so does the threefry draws' (part of each draw's
# adds and rotates as IMAD): each pipe must issue at least this share of
# the loop's int32 instructions.
BOTH_PIPES = 0.4
BOTH_PIPES_LOOPS = (("vpu", None), ("prng", "threefry"))


def pipe_mix(body):
    """{pipe: instructions} of a loop body's opcode Counter."""
    mix = collections.Counter()
    for op, n in body.items():
        mix["FMA" if op.startswith(FMA_PIPE) else "MIO"
            if op.startswith(MIO) else "other"
            if op.startswith(NOT_INT32) else "ALU"] += n
    return mix


def instance_kind(key, targs):
    """The kind a probe instance's template arguments select (None for A
    and C, whose count does not depend on the op)."""
    if key == "test":
        return probes.TEST_KINDS[targs[1]]
    if key == "sweep":
        return probes.SWEEP_KINDS[targs[0]]
    if key == "prng":
        return probes_mem.PRNG_MODES[targs[0]]
    return None


def probe_instances():
    """Every (CUDA function, template arguments) the entry points launch."""
    f = LOOP_FUNCS
    return ([(f["vpu"], (k,)) for k in probes.VPU_KS]
            + [(f["test"], (k, i)) for k in probes.TEST_KS
               for i in range(len(probes.TEST_KINDS))]
            + [(f["op"], (k, i)) for k in probes.OP_KS
               for i in range(len(probes.OPS))]
            + [(f["sweep"], (i,)) for i in range(len(probes.SWEEP_KINDS))]
            + [(f["gather_chain"], (e,)) for e in probes_mem.CHAIN_ES]
            + [(f["slice_loop"], ())]
            + [(f["reduce"], (r,))
               for r in range(probes_mem.REDUCE_REG_ROWS + 1)]
            + [(f["prng"], (i,)) for i in range(len(probes_mem.PRNG_MODES))])


def hot_candidates(key, loops):
    """The innermost loops of one kernel instance that may be its hot loop:
    in a kernel that keeps its working set in shared memory, the loops that
    touch no device memory (the strips' fill and drain are loops too, with
    8 global loads or stores a trip)."""
    if key not in SMEM_LOOPS:
        return loops
    loops = [c for c in loops if not (c["LDG"] or c["STG"])]
    if key == "gather_chain":  # a step ends at a barrier (the schedule's
        return [c for c in loops if c["BAR"]]  # build loops have none)
    return loops


def check_sass(loops):
    """Each probe instance's hot loop must issue at least half as many
    int32 instructions per evaluation as the TPU source has operations (the
    one-pass gather and slice copy have no loop and are not checked).
    ptxas fuses ops into three-input instructions (IADD3, IMAD, LOP3,
    VIMNMX3) and these loops keep 0.67-1.13 instruction per source op; a
    loop with part of the test hoisted or the chains merged keeps a third
    or less, and would also run faster than its bound."""
    by_name = {name: key for key, name in LOOP_FUNCS.items()}
    missing = set(probe_instances()) - set(loops)
    if missing:
        raise AssertionError(f"cuobjdump found no hot loop in {missing}")
    for name, targs in probe_instances():
        key = by_name[name]
        body = max(hot_candidates(key, loops[name, targs]),
                   key=lambda c: sum(c.values()))
        n_int = sum(v for op, v in body.items()
                    if not op.startswith(NOT_INT32))
        evals = LOOP_EVALS[key](targs, body)
        per = n_int / evals
        need = PROBE_OPS[key][instance_kind(key, targs)]
        mix = pipe_mix(body)
        phase("sass", f"{name}<{', '.join(map(str, targs))}>: hot loop "
              f"{sum(body.values())} instructions, {per:.3f} int32 per "
              f"evaluation against {need} source ops ({per / need:.3f}); "
              f"per evaluation by pipe: " + ", ".join(
                  f"{p} {mix[p] / evals:.3f}" for p in sorted(mix))
              + f" (IADD3 {body['IADD3'] / evals:.3f}, IMAD "
              f"{body['IMAD'] / evals:.3f})")
        if per < need / 2:
            raise AssertionError(f"{name}<{targs}>: {per:.3f} int32 "
                                 f"instructions per evaluation, under half "
                                 f"the source's {need}: the loop was cut")
        least = min(mix["ALU"], mix["FMA"]) / max(1, mix["ALU"] + mix["FMA"])
        if ((key, instance_kind(key, targs)) in BOTH_PIPES_LOOPS
                and least < BOTH_PIPES):
            raise AssertionError(f"{name}<{targs}>: one int32 pipe issues "
                                 f"{least:.3f} of the hot loop, under "
                                 f"{BOTH_PIPES}")


def probe_cases(rs):
    """(kernel key, label, inputs, keywords, timing shape?) of the probe
    compare phase: the JAX tools' parity shapes at small n_iter (random
    words too), and the card-filling timing shapes of the tools."""
    W = port_tools.ALU_WIDTH

    def rows(v, width=1024):
        return torch.full((8, width), v, dtype=torch.int32, device="cuda")

    def rand(shape=(8, 1024)):
        return torch.from_numpy(rs.integers(-2 ** 31, 2 ** 31, shape).astype(
            np.int32)).cuda()

    def planes(kind, Q, C, width):
        return tuple(torch.from_numpy(np.tile(p, (1, width // C))).cuda()
                     for p in probe_swar_sweep.sweep_planes(kind, Q, C))

    cases = [
        ("vpu", "A ones (8,1024) n_iter=2048 k=8 (the JAX shape; all 0)",
         (rows(1),), dict(independent=True, n_iter=2048, k=8, inner=16),
         False),
        ("vpu", "A random (8,1024) n_iter=1 k=8 inner=3", (rand(),),
         dict(independent=True, n_iter=1, k=8, inner=3), False),
        ("vpu", "A random (8,1024) dependent n_iter=1 k=2 inner=7", (rand(),),
         dict(independent=False, n_iter=1, k=2, inner=7), False),
        ("vpu", f"A ones (8,{W}) n_iter=2048 k=8", (rows(1, W),),
         dict(independent=True, n_iter=2048, k=8, inner=16), True),
        ("vpu", f"A ones (8,{W}) dependent n_iter=2048 k=8", (rows(1, W),),
         dict(independent=False, n_iter=2048, k=8, inner=16), False),
    ]
    # Every instance, both forms of a doubling in both modes, an odd inner
    # (the last doubling outside the loop over pairs) and an even one, and
    # 19 doublings (9 pairs and the last one alone); under 32 doublings, so
    # random words do not wrap to 0.
    for k in probes.VPU_KS:
        for independent, n_iter, inners in ((True, 3, (5, 6)),
                                            (False, 1, (3, 2))):
            for inner in inners:
                for name, x in (("random", rand()), ("ones", rows(1))):
                    cases.append((
                        "vpu", f"A {name} (8,1024) "
                        f"{'' if independent else 'dependent '}"
                        f"n_iter={n_iter} k={k} inner={inner}", (x,),
                        dict(independent=independent, n_iter=n_iter, k=k,
                             inner=inner), False))
    for independent, k in ((True, 8), (False, 1)):
        cases.append(("vpu", f"A random (8,1024) "
                      f"{'' if independent else 'dependent '}n_iter=1 k={k} "
                      f"inner=19", (rand(),),
                      dict(independent=independent, n_iter=1, k=k, inner=19),
                      False))
    for kind in probes.TEST_KINDS:
        for k in (2, 4, 16):
            cases.append(("test", f"B {kind} 70s (8,1024) n_iter=3 k={k}",
                          (rows(70),), dict(kind=kind, n_iter=3, k=k),
                          False))
        cases.append(("test", f"B {kind} random (8,1024) n_iter=2 k=4",
                      (rand(),), dict(kind=kind, n_iter=2, k=4), False))
        cases.append(("test", f"B {kind} 70s (8,{W}) n_iter=128 k=4",
                      (rows(70, W),), dict(kind=kind, n_iter=128, k=4),
                      kind == "production"))
        # the alternatives tool's ILP sweep at its own width
        for k in (2, 8, 16, 32):
            cases.append(("test", f"B {kind} 70s (8,{W}) n_iter=2 k={k}",
                          (rows(70, W),), dict(kind=kind, n_iter=2, k=k),
                          False))
    for op in probes.OPS:
        for k in (4, 16):
            cases.append(("op", f"C {op} 3s (8,1024) n_iter=4 k={k}",
                          (rows(3),), dict(op=op, n_iter=4, k=k, u=8),
                          False))
        # k=1: no XOR fold, whose pairs cancel in the add chains
        for k in (1, 16):
            cases.append(("op", f"C {op} random (8,1024) n_iter=2 k={k}",
                          (rand(),), dict(op=op, n_iter=2, k=k, u=8), False))
        cases.append(("op", f"C {op} 3s (8,{W}) n_iter=128 k=16",
                      (rows(3, W),), dict(op=op, n_iter=128, k=16, u=8),
                      op == "mul"))
    S = port_tools.SWEEP_WIDTH
    for kind in probes.SWEEP_KINDS:
        for Q in (16, 32):
            cases.append(("sweep", f"D {kind} Q={Q} C=256 4 chunks",
                          planes(kind, Q, 256, 256),
                          dict(kind=kind, n_chunks=4), False))
        # the swar sweep's own shapes: its planes (C=2048 tiled to S
        # columns) at the full run's Q=144 and the --quick run's Q=256
        cases.append(("sweep", f"D {kind} Q=144 C={S} 1 chunk",
                      planes(kind, 144, 2048, S), dict(kind=kind, n_chunks=1),
                      False))
        cases.append(("sweep", f"D {kind} Q=256 C={S} "
                      f"{8 if kind == 'production' else 2} chunks",
                      planes(kind, 256, 2048, S),
                      dict(kind=kind, n_chunks=8 if kind == "production"
                           else 2), kind == "production"))
    return cases


def probe_evals(key, inputs, kw):
    """Evaluations one launch makes: doublings (A), attack tests (B; a SWAR
    test scores two queens), op + or pairs (C), (row, target) tests (D)."""
    n = inputs[0].numel()
    if key == "vpu":
        return n * kw["n_iter"] * kw["k"] * kw["inner"]
    if key == "test":
        return n * kw["n_iter"] * kw["k"] * probes._test_u(kw["k"])
    if key == "op":
        return n * kw["n_iter"] * kw["k"] * kw["u"]
    return n * kw["n_chunks"] * probes.SWEEP_TARGETS


# -- the gather and slice tools' kernels (kernels/probes_mem.py) -------------

def mem_cases(rs):
    """(key, label, inputs, keywords, timing shape?) of the gather and
    slice kernels' compare phase: the JAX tools' parity shapes (their own
    inputs, small trip counts), random words with ragged tiles, and the
    tools' card-filling shapes, one of each kernel timed (at the tools'
    --quick trip counts where they cut them)."""
    T, W, W1 = (port_tools.TIMING_THREADS, port_tools.ALU_WIDTH,
                port_tools.ONE_PASS_WORDS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    def arange(S, L):
        return torch.arange(S * L, dtype=torch.int32,
                            device="cuda").reshape(S, L)

    def rand(S, L):
        return cuda(rs.integers(-2 ** 31, 2 ** 31, (S, L)).astype(np.int32))

    def unaligned(S, L):
        # a contiguous (S, L) view one word into its buffer
        return cuda(rs.integers(-2 ** 31, 2 ** 31, S * L + 1).astype(
            np.int32))[1:].view(S, L)

    def index(seed, hi, shape):
        return cuda(np.random.default_rng(seed).integers(0, hi, size=shape,
                                                         dtype=np.int32))

    def big_index(hi, shape):
        return torch.randint(0, hi, shape, dtype=torch.int32, device="cuda",
                             generator=gen)

    def ones(S, L):
        return torch.ones((S, L), dtype=torch.int32, device="cuda")

    def off(o):
        return torch.tensor([o], dtype=torch.int32, device="cuda")

    def passes(independent, n):
        # kernel A as the tools call it: every doubling in its inner loop
        return dict(independent=independent, n_iter=1,
                    k=8 if independent else 1, inner=n)

    cases = []
    for S, L, axis in ((8, 128, 1), (8, 256, 1), (64, 128, 1), (256, 512, 1),
                       (8, 128, 0), (32, 128, 0), (256, 128, 0),
                       (256, 1024, 0)):
        cases.append(("gather", f"5a gather ({S},{L}) axis {axis}",
                      (arange(S, L), index(0, L if axis == 1 else S, (S, L)),
                       axis), {}, False))
    cases += [
        ("gather", "5b gather narrow (8,256->64) axis 1",
         (arange(8, 256), index(1, 256, (8, 64)), 1), {}, False),
        ("gather", "5b gather narrow (256,128->64) axis 0",
         (arange(256, 128), index(1, 256, (64, 128)), 0), {}, False),
        ("gather", "gather random (40,100) axis 1",
         (rand(40, 100), index(3, 100, (40, 100)), 1), {}, False),
        ("gather", f"gather ({W1 // 512},512) axis 1",
         (arange(W1 // 512, 512), big_index(512, (W1 // 512, 512)), 1), {},
         True),
        ("gather", f"gather (256,{W1 // 256}) axis 0",
         (arange(256, W1 // 256), big_index(256, (256, W1 // 256)), 0), {},
         False),
        ("gather", f"gather narrow ({W1 // 64},256->64) axis 1",
         (arange(W1 // 64, 256), big_index(256, (W1 // 64, 64)), 1), {},
         False),
    ]
    for S, L, axis in ((8, 128, 1), (64, 256, 1), (256, 1024, 0)):
        cases.append(("gather_chain", f"5c gather chain ({S},{L}) axis {axis}"
                      f" n_iter=3", (arange(S, L) % 7,
                                     index(2, L if axis == 1 else S, (S, L)),
                                     axis), dict(n_iter=3), False))
    # ragged tiles, and every elements-per-thread instance on both axes
    # (axis 1: 4, 4, 8, 16, 1, 2, 32, 32; axis 0: 32, 4, 1), odd and even
    # step counts
    for S, L, axis in ((40, 100, 1), (6, 400, 1), (5, 2000, 1), (3, 4000, 1),
                       (1, 200, 1), (1, 500, 1), (2, 8000, 1), (3, 8192, 1),
                       (300, 45, 0), (32, 128, 0), (8, 96, 0)):
        for n in (4, 5):
            cases.append(("gather_chain", f"gather chain random ({S},{L}) "
                          f"axis {axis} n_iter={n} (e="
                          f"{probes_mem.chain_tile(S, L, axis)[2]})",
                          (rand(S, L), index(4, L if axis == 1 else S,
                                             (S, L)), axis),
                          dict(n_iter=n), False))
    # indices that defeat a bank schedule: every element gathering one word,
    # every source in one bank, the identity, a permutation of each row
    for S, L, axis in ((16, 256, 1), (3, 4000, 1), (32, 128, 0)):
        n_src = L if axis == 1 else S
        rg = np.random.default_rng(5)
        for name, a in (
                ("all zeros", np.zeros((S, L))),
                ("one bank", 32 * rg.integers(0, n_src // 32, (S, L))),
                ("identity", np.broadcast_to(np.arange(L), (S, L)) if axis == 1
                 else np.broadcast_to(np.arange(S)[:, None], (S, L))),
                ("permutation", np.stack([rg.permutation(L) for _ in range(S)])
                 if axis == 1 else np.stack([rg.permutation(S)
                                             for _ in range(L)], 1))):
            cases.append(("gather_chain", f"gather chain {name} ({S},{L}) "
                          f"axis {axis} n_iter=5",
                          (rand(S, L), cuda(a.astype(np.int32)), axis),
                          dict(n_iter=5), False))
    cases += [
        ("gather_chain", f"gather chain ({T // 256},256) axis 1 n_iter=512",
         (arange(T // 256, 256) % 7, big_index(256, (T // 256, 256)), 1),
         dict(n_iter=512), True),
        ("gather_chain", f"gather chain (256,{T // 8}) axis 0 n_iter=512",
         (arange(256, T // 8) % 7, big_index(256, (256, T // 8)), 0),
         dict(n_iter=512), False),
        ("vpu_mem", "5d add cost (256,1024) n_iter=2048", (ones(256, 1024),),
         passes(False, 2048), False),
        ("vpu_mem", "5h pass cost (1,1024) n_iter=8192", (ones(1, 1024),),
         passes(False, 8192), False),
        ("vpu_mem", "5h pass cost (1024,256) n_iter=8192",
         (ones(1024, 256),), passes(False, 8192), False),
        ("vpu_mem", "pass random (8,1024) n_iter=7", (rand(8, 1024),),
         passes(False, 7), False),
        ("vpu_mem", f"pass cost (8,{W}) n_iter=8192", (ones(8, W),),
         passes(False, 8192), True),
        ("vpu_mem", "5i ind pass cost (64,1024) n_iter=2048",
         (ones(64, 1024),), passes(True, 2048), False),
        ("vpu_mem", "ind pass random (8,1024) n_iter=3", (rand(8, 1024),),
         passes(True, 3), False),
        ("vpu_mem", f"ind pass cost (8,{W}) n_iter=2048", (ones(8, W),),
         passes(True, 2048), False),
    ]
    for S, o in ((256, 16), (256, 8), (256, 12), (496, 240)):
        cases.append(("slice_load", f"5e slice load ({S},1024) w16 off{o}",
                      (arange(S, 1024), off(o), 16), {}, False))
    cases += [
        ("slice_load", "slice load random (256,1024) w16 off100",
         (rand(256, 1024), off(100), 16), {}, False),
        ("slice_load", f"slice load (256,{W1 // 256}) w16 off240",
         (arange(256, W1 // 256), off(240), 16), {}, True),
        ("slice_store", "5f slice store (256,1024) w16 off48",
         (arange(256, 1024), off(48), 16), {}, False),
        ("slice_store", "slice store random (40,100) w5 off35",
         (rand(40, 100), off(35), 5), {}, False),
        # int32 rows (C not a multiple of 4; rows not 16-byte aligned) and
        # the last legal offset
        ("slice_load", "slice load random (37,1001) w5 off32",
         (rand(37, 1001), off(32), 5), {}, False),
        ("slice_store", "slice store random (37,1001) w5 off32",
         (rand(37, 1001), off(32), 5), {}, False),
        ("slice_load", "slice load random (24,128) w8 off16, x 4 B past "
         "16-byte alignment", (unaligned(24, 128), off(16), 8), {}, False),
        ("slice_store", "slice store random (24,128) w8 off16, x 4 B past "
         "16-byte alignment", (unaligned(24, 128), off(16), 8), {}, False),
        ("slice_store", f"slice store (256,{W1 // 256}) w16 off48",
         (arange(256, W1 // 256), off(48), 16), {}, True),
        ("slice_loop", "5g slice loop (256,1024) w16 n_iter=4096",
         (torch.zeros((256, 1024), dtype=torch.int32, device="cuda"), 16),
         dict(n_iter=4096), False),
        ("slice_loop", "slice loop random (40,100) w8 n_iter=11",
         (rand(40, 100), 8), dict(n_iter=11), False),
        ("slice_loop", f"slice loop (256,{W}) w16 n_iter=4096",
         (torch.zeros((256, W), dtype=torch.int32, device="cuda"), 16),
         dict(n_iter=4096), True),
        ("reduce", "5j reduce (64,1024) n_iter=4096", (ones(64, 1024),),
         dict(n_iter=4096), False),
        ("reduce", "reduce random (24,200) n_iter=5", (rand(24, 200),),
         dict(n_iter=5), False),
    ]
    # both instances: the column in registers (S <= 64) and the staged strip
    for S in (1, 24, 63, 64, 65, 256):
        for n in (1, 5):
            cases.append(("reduce", f"reduce random ({S},1000) n_iter={n} "
                          f"(instance {probes_mem.reduce_instance(S)})",
                          (rand(S, 1000),), dict(n_iter=n), False))
    cases += [
        ("reduce", f"reduce (64,{T}) n_iter=512", (ones(64, T),),
         dict(n_iter=512), True),
    ]
    for mode in probes_mem.PRNG_MODES:
        key = f"prng_{mode}"
        for R in (8, 2):
            cases.append((key, f"5k prng {mode} ({R},1024) n_iter=4096",
                          ((R, 1024), mode),
                          dict(n_iter=4096, device="cuda"), False))
        # a step count that is not a multiple of the key chunk (128), ragged
        # word counts, and steps wrapping past 2^32
        for shape, n, step0 in (((3, 333), 1, 9), ((1, 1000), 33, 9),
                                ((5, 77), 4097, 9), ((7, 513), 33, 2 ** 32 - 17),
                                ((2, 1024), 300, 2 ** 32 - 200)):
            cases.append((key, f"prng {mode} {shape} n_iter={n} step0={step0}",
                          (shape, mode), dict(n_iter=n, device="cuda",
                                              step0=step0), False))
        cases.append((key, f"prng {mode} (8,{W}) n_iter=512", ((8, W), mode),
                      dict(n_iter=512, device="cuda"), True))
    return cases


# -- the probe table -----------------------------------------------------------

def alu_work(ops):
    """Work of kernels A-D: evaluations times the TPU source's operations
    per evaluation; each input word read once, each output word written
    once (D writes one row)."""
    def work(inputs, kw):
        out = inputs[0].shape[1] if ops == "sweep" else inputs[0].numel()
        words = sum(t.numel() for t in inputs) + out
        return (probe_evals(ops, inputs, kw) * PROBE_OPS[ops][kw.get("kind")],
                4 * words, 0)
    return work


# The gather and slice kernels' work, counted from the TPU source: each
# input word read once (the gather: each distinct gathered word), each
# output word written once; the shared-memory kernels' loaded and stored
# words there (the strip's fill and drain included).

def gather_work(inputs, kw):
    x, idx, axis = inputs
    need = int(torch.unique(probes_mem._flat_index(idx, x.shape[1],
                                                   axis)).numel())
    return idx.numel(), 4 * (need + 2 * idx.numel()), 0


def chain_work(inputs, kw):
    words, n = inputs[0].numel(), kw["n_iter"]
    return 2 * words * n, 12 * words, 8 * words * n + 4 * words


def load_work(inputs, kw):
    x, _, width = inputs
    return 0, 4 * (2 * width * x.shape[1] + 1), 0


def store_work(inputs, kw):
    x, _, width = inputs
    S, C = x.shape
    return 0, 4 * ((2 * S - width) * C + 1), 0


def loop_work(inputs, kw):
    x, width = inputs
    strip, n = width * x.shape[1], kw["n_iter"]
    return strip * n, 8 * x.numel(), 8 * strip * n + 8 * x.numel()


def reduce_work(inputs, kw):
    # The function's work: a column fits in registers, so re-reading x from
    # shared memory every step is a choice of a kernel, not work the
    # function needs (a bound counts each input word read once).
    x, n = inputs[0], kw["n_iter"]
    words = x.numel()
    return 2 * words * n, 4 * (words + x.shape[1]), 0


def reduce_staging_note(inputs, kw, bounds, kernel_ms):
    """The reduce's earlier bound, printed beside the function's: the
    staged kernel's own shared-memory words, 4 S C (n_iter + 1) bytes."""
    x, n = inputs[0], kw["n_iter"]
    staged = 4 * x.numel() * (n + 1)
    ms = bounds.terms(0, 0, staged)["shared-memory bytes"]
    return (f"old yardstick, the staged kernel's shared-memory words: "
            f"{staged:.4e} B -> {ms:.4f} ms = {ms / kernel_ms:.3f} of the "
            f"kernel's {kernel_ms:.4f} ms")


def chain_schedule_note(inputs, kw, bounds, kernel_ms):
    """The bank schedule the kernel built on the card for these inputs (axis
    1): instructions and shared-memory wavefronts a 256-word row, against
    8 and 16 with no conflict; 0 for axis 0, which has none."""
    x, idx, axis = inputs
    if axis != 1:
        return "axis 0: no schedule (a lane a column, one bank each)"
    S, L = x.shape
    rows, _, e = probes_mem.chain_tile(S, L, axis)
    sched = torch.empty((-(-S // rows), probes_mem.chain_instructions(e),
                         32), dtype=torch.int32, device="cuda")
    probes_mem.launch_chain(probes._lib(), x, idx, torch.empty_like(x), axis,
                            n_iter=1, schedule=sched,
                            stream=torch.cuda.current_stream().cuda_stream)
    sc = sched.cpu().numpy().view(np.uint32)
    live = sc != 0xFFFFFFFF
    src = np.where(live, sc & 0xFFFF, 0xFFFFFFFF).astype(np.int64)
    # load wavefronts of an instruction: the most distinct words in a bank
    loads = 0
    for blk, lv in zip(src, live):
        for ins, m in zip(blk, lv):
            if m.any():
                u = np.unique(ins[m])
                loads += int(np.bincount(u % 32, minlength=32).max())
    n_instr = int(live.any(-1).sum())
    if live.sum() != S * L:
        raise AssertionError(f"the schedule holds {int(live.sum())} "
                             f"elements, not {S * L}")
    rows_256 = S * L / 256
    return (f"the card's bank schedule: {n_instr / rows_256:.3f} "
            f"instructions a 256-word row (8 with no conflict), "
            f"{(loads + n_instr) / rows_256:.3f} wavefronts (16), "
            f"{loads - n_instr} load conflicts in all; model share "
            f"{16 * rows_256 / (loads + n_instr):.3f}")


def prng_work(inputs, kw):
    shape, mode = inputs
    words, n = math.prod(shape), kw["n_iter"]
    fold_in = THREEFRY_OPS * n if mode == "threefry" else 0
    return PROBE_OPS["prng"][mode] * words * n + fold_in, 4 * words, 0


# One PyTorch call computing a one-pass kernel's words on the same inputs:
# torch.gather (its index widened to int64 outside the timing), narrow_copy,
# index_fill.  No PyTorch call computes a probe's loop.

def gather_library(inputs):
    x, idx, axis = inputs
    idx64 = idx.long()
    return lambda: torch.gather(x, axis, idx64)


def load_library(inputs):
    x, off, width = inputs
    o = int(off[0])
    return lambda: torch.narrow_copy(x, 0, o, width)


def store_library(inputs):
    x, off, width = inputs
    rows = torch.arange(int(off[0]), int(off[0]) + width, device=x.device)
    return lambda: x.index_fill(0, rows, 7)


def probe_row(name, source, replaces, calls, work, *, ops=None,
              trip="n_iter", sites=None, smem=False, library=None,
              note=None):
    """One probe row of the kernels line.  ``calls``: (public wrapper,
    launcher, plain twin); ``work(inputs, kw)``: (int32 operations,
    device-memory bytes, shared-memory bytes) of a launch; ``ops``: the
    PROBE_OPS and LOOP_EVALS key of its hot loop, None for a one-pass kernel
    (no loop: no SASS check, no scaling); ``trip``: the trip count the
    scaling check doubles; ``sites``: every pallas_call site the row stands
    for; ``smem``: the hot loop works out of shared memory; ``library``:
    inputs -> one PyTorch call computing the same words, or None;
    ``note(inputs, kw, bounds, kernel_ms)``: a second figure printed beside
    the bound, or None."""
    return dict(name=name, func=name.split(" ")[0], source=source,
                replaces=replaces, sites=sites or [replaces], calls=calls,
                work=work, ops=ops, trip=trip, smem=smem, library=library,
                note=note)


_ALU_CU = "mcqueens_torch/kernels/csrc/probe_alu.cu"
_ATTACK_CU = "mcqueens_torch/kernels/csrc/probe_attack.cu"
_GATHER_CU = "mcqueens_torch/kernels/csrc/probe_gather.cu"
_SLICE_CU = "mcqueens_torch/kernels/csrc/probe_slice.cu"
_A = (probes.vpu_doubling, probes.vpu_doubling_cuda,
      probes.vpu_doubling_reference)
_PRNG = (probes_mem.prng_draws, probes_mem.prng_draws_cuda,
         probes_mem.prng_draws_reference)
_SLICE = "tools/probe_slice.py"
# The measurement tools' probe kernels, keyed by launch count: kernel A's
# launches are split between the roofline ("vpu") and the gather and slice
# tools ("vpu_mem"), the PRNG kernel's by generator.
PROBES = {
    "vpu": probe_row("vpu_probe_kernel", _ALU_CU, "tools/roofline.py:100", _A,
                     alu_work("vpu"), ops="vpu"),
    "test": probe_row(
        "test_probe_kernel", _ATTACK_CU,
        "tools/probe_full3d_alternatives.py:74",
        (probes.attack_test, probes.attack_test_cuda,
         probes.attack_test_reference), alu_work("test"), ops="test"),
    "op": probe_row(
        "op_probe_kernel", _ALU_CU, "tools/probe_full3d_alternatives.py:194",
        (probes.op_chain, probes.op_chain_cuda, probes.op_chain_reference),
        alu_work("op"), ops="op"),
    "sweep": probe_row(
        "sweep_probe_kernel", _ATTACK_CU, "tools/probe_swar_sweep.py:119",
        (probes.sweep, probes.sweep_cuda, probes.sweep_reference),
        alu_work("sweep"), ops="sweep", trip="n_chunks"),
    "gather": probe_row(
        "gather_probe_kernel", _GATHER_CU, "tools/probe_gather.py:41",
        (probes_mem.gather, probes_mem.gather_cuda,
         probes_mem.gather_reference), gather_work,
        sites=["tools/probe_gather.py:41", "tools/probe_gather.py:60"],
        library=gather_library),
    "gather_chain": probe_row(
        "gather_chain_probe_kernel", _GATHER_CU, "tools/probe_gather.py:84",
        (probes_mem.gather_chain, probes_mem.gather_chain_cuda,
         probes_mem.gather_chain_reference), chain_work, ops="gather_chain",
        smem=True, note=chain_schedule_note),
    "vpu_mem": probe_row(
        "vpu_probe_kernel (add, pass and independent pass costs)", _ALU_CU,
        "tools/probe_gather.py:114", _A, alu_work("vpu"), ops="vpu",
        trip="inner", sites=["tools/probe_gather.py:114", f"{_SLICE}:129",
                             f"{_SLICE}:149"]),
    "slice_load": probe_row(
        "slice_probe_kernel (load)", _SLICE_CU, f"{_SLICE}:46",
        (probes_mem.slice_load, probes_mem.slice_load_cuda,
         probes_mem.slice_load_reference), load_work, library=load_library),
    "slice_store": probe_row(
        "slice_probe_kernel (store)", _SLICE_CU, f"{_SLICE}:70",
        (probes_mem.slice_store, probes_mem.slice_store_cuda,
         probes_mem.slice_store_reference), store_work,
        library=store_library),
    "slice_loop": probe_row(
        "slice_loop_probe_kernel", _SLICE_CU, f"{_SLICE}:105",
        (probes_mem.slice_loop, probes_mem.slice_loop_cuda,
         probes_mem.slice_loop_reference), loop_work, ops="slice_loop",
        smem=True),
    "reduce": probe_row(
        "reduce_probe_kernel", _SLICE_CU, f"{_SLICE}:174",
        (probes_mem.sublane_reduce, probes_mem.sublane_reduce_cuda,
         probes_mem.sublane_reduce_reference), reduce_work, ops="reduce",
        smem=True, note=reduce_staging_note),
    "prng_lowbias32": probe_row(
        "prng_probe_kernel (lowbias32)", _SLICE_CU, f"{_SLICE}:194", _PRNG,
        prng_work, ops="prng"),
    "prng_threefry": probe_row(
        "prng_probe_kernel (threefry)", _SLICE_CU, f"{_SLICE}:194", _PRNG,
        prng_work, ops="prng"),
}
# The CUDA function of each hot loop, the loops that work out of shared
# memory, and every probe kernel (its ptxas lines are summed over its
# template instances).
LOOP_FUNCS = {row["ops"]: row["func"] for row in PROBES.values()
              if row["ops"]}
SMEM_LOOPS = {row["ops"] for row in PROBES.values() if row["smem"]}
PROBE_FUNCS = sorted({row["func"] for row in PROBES.values()})


def probe_compare(cases):
    """Each probe kernel against its twin on the card, bitwise (any
    difference raises), the result through the public wrapper; returns
    {key: timing row}: the launcher alone timed on the card alone (the
    gather and slice wrappers' checks read the card back), the twin once."""
    saved = dict(probes.LAUNCHES), dict(probes_mem.LAUNCHES)
    rows = {}
    for key, label, inputs, kw, timing in cases:
        wrapper, launcher, twin = PROBES[key]["calls"]
        got = wrapper(*inputs, **kw)
        box = []  # the twin runs once: timed, and its words compared
        t_ms = cuda_ms(lambda: box.append(twin(*inputs, **kw)))
        want = box[0]
        if not torch.equal(got, want):
            err = int((got.long() - want.long()).abs().max())
            raise AssertionError(f"probe kernel != twin on {label}: "
                                 f"{int((got != want).sum())} words differ, "
                                 f"max abs err {err}")
        line = f"{label}: kernel == twin ({got.numel()} words)"
        if timing:
            k_ms = device_ms(lambda: launcher(*inputs, **kw))
            rows[key] = dict(label=label, kernel_ms=k_ms, twin_ms=t_ms,
                             kw=kw, inputs=inputs)
            line += f"; kernel {k_ms:.4f} ms, twin {t_ms:.1f} ms"
        phase("probes", line)
    probes.LAUNCHES.update(saved[0])
    probes_mem.LAUNCHES.update(saved[1])
    return rows


SCALING_PAIRS = 5


def pair_ms(fn1, fn2, reps=3):
    """Milliseconds per call of ``fn1`` and then of ``fn2``, ``reps`` calls
    each, behind one spin kernel (as :func:`device_ms`), so that neither
    waits for the host."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda._sleep(5_000_000)
    events[0].record()
    for fn, end in ((fn1, events[1]), (fn2, events[2])):
        for _ in range(reps):
            fn()
        end.record()
    torch.cuda.synchronize()
    return (events[0].elapsed_time(events[1]) / reps,
            events[1].elapsed_time(events[2]) / reps)


def probe_scaling(rows):
    """Time each loop kernel at its timing shape with its trip count and
    with twice it, in :data:`SCALING_PAIRS` alternated pairs, each behind
    its own spin kernel: the ratio of the two least times must lie in [1.8,
    2.2], else the compiler cut the loop.  The least of several pairs, not
    the mean of one run each, so that one slow reading (a clock dip) cannot
    fail an honest kernel."""
    saved = dict(probes.LAUNCHES), dict(probes_mem.LAUNCHES)
    for key, row in rows.items():
        meta = PROBES[key]
        if meta["ops"] is None:
            continue
        launcher, trip, inputs = meta["calls"][1], meta["trip"], row["inputs"]
        kw1 = dict(row["kw"])
        kw2 = dict(kw1, **{trip: 2 * kw1[trip]})
        launcher(*inputs, **kw2)
        pairs = [pair_ms(lambda: launcher(*inputs, **kw1),
                         lambda: launcher(*inputs, **kw2))
                 for _ in range(SCALING_PAIRS)]
        t1s, t2s = zip(*pairs)
        t1, t2 = min(t1s), min(t2s)
        row["scaling"] = t2 / t1
        phase("probes", f"{row['label']}: {trip} x2 -> time x{t2 / t1:.3f} "
              f"(least of {SCALING_PAIRS} alternated pairs: {t1:.4f} -> "
              f"{t2:.4f} ms; spread {max(t1s) / t1 - 1:.2%} and "
              f"{max(t2s) / t2 - 1:.2%})")
        if not 1.8 <= t2 / t1 <= 2.2:
            raise AssertionError(f"{row['label']}: time scales x{t2 / t1:.3f}"
                                 f" under 2x {trip}, not 1.8-2.2")
    probes.LAUNCHES.update(saved[0])
    probes_mem.LAUNCHES.update(saved[1])


def probe_library_ms(key, row):
    """The row's library call timed on its inputs, after checking it gives
    the kernel's words; None where no PyTorch call computes them."""
    meta = PROBES[key]
    if meta["library"] is None:
        return None
    fn = meta["library"](row["inputs"])
    if not torch.equal(fn(), meta["calls"][1](*row["inputs"], **row["kw"])):
        raise AssertionError(f"the library call of {key} disagrees")
    return device_ms(fn)


def probe_kernel_rows(rows, launches, bounds):
    """The kernels line's probe rows: each probe must run at no more than
    1.05 of its bound, and none may move shared-memory bytes faster than
    the bound's shared-memory rate."""
    out = []
    for key, meta in PROBES.items():
        row = rows[key]
        work = row["work"]
        bound_ms, bound_by = bounds.of(*work)
        share = bound_ms / row["kernel_ms"]
        terms = ", ".join(f"{k} {v:.4f} ms"
                          for k, v in bounds.terms(*work).items())
        phase("bound", f"{meta['name']} on '{row['label']}': {work[0]:.4e} "
              f"int32 ops, {work[1]:.4e} bytes, {work[2]:.4e} shared-memory "
              f"bytes -> {terms}; bound {bound_ms:.4f} ms ({bound_by}) = "
              f"{share:.3f} of the kernel's {row['kernel_ms']:.4f} ms")
        if meta["note"]:
            phase("bound", f"{meta['name']}: " + meta["note"](
                row["inputs"], row["kw"], bounds, row["kernel_ms"]))
        if share > 1.05:
            raise AssertionError(f"{meta['name']} ran at {share:.3f} of its "
                                 f"bound: work was cut")
        smem_rate = work[2] / (row["kernel_ms"] / 1e3)
        if smem_rate > bounds.smem_bytes_per_s:
            raise AssertionError(
                f"{meta['name']} moved {smem_rate:.4e} shared-memory B/s, "
                f"above the bound's {bounds.smem_bytes_per_s:.4e}")
        out.append({**{k: meta[k] for k in ("name", "source", "replaces",
                                             "sites")},
                    "route": "cuda", "launches": launches[key],
                    "max_abs_err": 0, "ms": row["kernel_ms"],
                    "plain_ms": row["twin_ms"], "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": row["library_ms"]})
    return out


TOOLS = (probe_full3d_cap, probe_full3d_alternatives, probe_swar_sweep,
         roofline, probe_gather, probe_slice)
# Probe launches of the tools' --quick runs: a warm-up launch and the timed
# reps of each point (roofline: 2 variants x 4 reps; alternatives: 3 kinds
# x 2 k x 3 reps, 2 ops x 4 reps; swar sweep: 2 kinds x 3 reps at Q=256).
# The gather tool: 13 gathers (10 of the JAX tool, 3 filling the card), 2
# add and 5 gather-chain costs; the slice tool: 5 loads and 2 stores, and 2
# slice loops, 6 + 3 passes, 2 reduces and 3 draws of each generator timed,
# each timed point a warm-up launch and 2 reps.
TOOL_LAUNCHES = {"vpu": 2 * (1 + 4), "test": 3 * 2 * (1 + 3),
                 "op": 2 * (1 + 4), "sweep": 2 * (1 + 3),
                 "gather": 13, "gather_chain": 5 * 3,
                 "vpu_mem": (2 + 6 + 3) * 3, "slice_load": 5,
                 "slice_store": 2, "slice_loop": 2 * 3, "reduce": 2 * 3,
                 "prng_lowbias32": 3 * 3, "prng_threefry": 3 * 3}


def tools_slice():
    """Each ported tool's ``main(["--quick", "--json", tmp])`` on the card
    (the alternatives and the swar sweep read the cap probe's fit of this
    run), the probe launch counts zeroed just before and read just after;
    prints each JSON.  Returns the launches, kernel A's split into the
    roofline's and the gather and slice tools'."""
    outs, a_before = {}, None
    with tempfile.TemporaryDirectory() as d:
        cap = os.path.join(d, "probe_full3d_cap.json")
        zero_launches()
        for mod in TOOLS:
            name = mod.__name__.rsplit(".", 1)[1]
            path = os.path.join(d, f"{name}.json")
            extra = ["--cap", cap] if mod in (probe_full3d_alternatives,
                                             probe_swar_sweep) else []
            if mod is probe_gather:
                a_before = probes.LAUNCHES["vpu"]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = mod.main(["--quick", "--json", path] + extra)
            with open(path) as f:
                out = json.load(f)
            if rc != 0 or out["device"] != "cuda" or not out["card"]:
                raise AssertionError(f"{name} --quick: rc {rc}, {out}")
            phase("tools", f"{name} --quick ({time.perf_counter() - t0:.1f}"
                  f" s): {json.dumps(out)}")
            outs[name] = out
    for name in ("probe_full3d_alternatives", "probe_swar_sweep"):
        if not outs[name]["fitted_b_us_per_queen"] > 0:
            raise AssertionError(f"{name} did not read this run's fit")
    if not all(v > 0 for v in outs["roofline"]["kernels"].values()):
        raise AssertionError("roofline: a sampler row is not positive")
    for name in ("probe_gather", "probe_slice"):
        failed = [k for k, v in outs[name]["probes"].items()
                  if v["status"] != "OK" or v["result"].startswith("WRONG")]
        if failed:
            raise AssertionError(f"{name}: probes not OK: {failed}")
    got = {**probes.LAUNCHES, **probes_mem.LAUNCHES, "vpu": a_before,
           "vpu_mem": probes.LAUNCHES["vpu"] - a_before}
    if got != TOOL_LAUNCHES:
        raise AssertionError(f"tools: probe launches {got}, expected "
                             f"{TOOL_LAUNCHES}")
    return got, outs


def check_rates(outs, bounds):
    """The rates the tools measured in this run must stay below the fixed
    constants the bounds divide by, else a bound would be beatable."""
    rl, alt = outs["roofline"], outs["probe_full3d_alternatives"]
    for label, rate, limit in (
            ("HBM bytes/s (roofline in-place add)",
             rl["hbm_bandwidth_GB_s"] * 1e9, bounds.bytes_per_s),
            ("int32 adds/s (roofline, kernel A)", rl["int32_add_ops_per_s"],
             bounds.int_ops_per_s),
            ("int32 add + or ops/s (kernel C)",
             1024e9 / alt["int32_add_ns_per_1024_ops"], bounds.int_ops_per_s),
            ("int32 mul + or ops/s (kernel C)",
             1024e9 / alt["int32_mul_ns_per_1024_ops"],
             bounds.int_ops_per_s)):
        phase("bound", f"{label}: measured {rate:.4e}, constant {limit:.4e}"
              f" ({rate / limit:.3f})")
        if rate > limit:
            raise AssertionError(f"{label} {rate:.4e} beats the bound's "
                                 f"constant {limit:.4e}")


def hold_cases(bounds):
    """The full-3D shared kernel at each hold (``_HOLD`` set as the probe
    of the hold sets it) on one launch of 1024 steps, the least a hold
    above 8 takes (N=15, Q=225, 4096 chains, launch 2 of the campaign's
    linear 0.8 -> 7 over 8M steps), against the twin: every state field
    equal, the kernel's time beside its bound.  Then the refusals: a hold
    outside (8, 16, 32), and hold 16 on a 44-step launch, must raise."""
    n, horizon = full3d_shared.LONG_LAUNCH, 8_000_000
    spec = spec_of(15, horizon, n, lin(horizon, 0.8, 7.0),
                   mcmc_type="full_3d")
    out = {}
    for hold in full3d_shared.HOLDS:
        name = f"full3d hold {hold} N=15 Q=225 C=4096 {n} steps"
        with held(hold):
            res = compare_case(full3d_shared, name, spec, 4096, 2, 77)
            bound_ms, bound_by = bounds.of(*res["work"])
        phase("hold", f"{name}: kernel {res['kernel_ms']:.3f} ms = "
              f"{res['ln'].proposals / res['kernel_ms'] * 1e3:.4e} proposed "
              f"moves/s; bound {bound_ms:.3f} ms ({bound_by}) = "
              f"{bound_ms / res['kernel_ms']:.3f} of the kernel's time"
              f"{shared_note(res['layout'])}")
        out[name] = dict(res, mod=full3d_shared)
    st = full3d_shared.segment_state(res["init"])
    for hold, steps in ((12, n), (16, 44)):
        beta = chunk_betas(spec.schedule, 0, steps, "cuda")
        with held(hold):
            try:
                full3d_shared.segment_cuda(st, 0, steps, spec, beta)
            except ValueError as e:
                phase("hold", f"hold {hold} on a {steps}-step launch "
                      f"refused: {e}")
            else:
                raise AssertionError(f"hold {hold} on a {steps}-step launch "
                                     f"ran")
    return out


RESULT_ARRAYS = ("energy_history", "history_steps", "history_len",
                 "final_energy", "final_state", "best_energy", "best_state",
                 "steps_to_best", "stop_step", "accept_bins", "total_bins")


def trace_slice():
    """``runner.run_chains`` (board, pallas_shared, N=16, 4096 chains, two
    2048-step chunks) without ``profile_dir`` and twice with it (the first
    traced run of a process also starts the profiler): every result array
    equal, and the trace must name the board kernel among the card's
    kernels.  Prints the walls (init, the final synchronise and the trace's
    export included) and the kernel time the trace holds.  Returns the
    board kernel's launches, all three runs."""
    spec = spec_of(16, 4096, 2048, lin(4096, 1.0, 5.0))
    seeds = np.arange(4096, dtype=np.uint32)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = runner.run_chains(seeds, spec, device="cuda")
    plain_s = time.perf_counter() - t0
    traced_s = []
    for _ in range(2):
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            got = runner.run_chains(seeds, spec, device="cuda",
                                    profile_dir=d)
            traced_s.append(time.perf_counter() - t0)
            (name,) = [f for f in os.listdir(d)
                       if f.endswith(".pt.trace.json")]
            size = os.path.getsize(os.path.join(d, name))
            with open(os.path.join(d, name)) as f:
                events = json.load(f)["traceEvents"]
        for field in RESULT_ARRAYS:
            if not np.array_equal(getattr(got, field), getattr(want, field)):
                raise AssertionError(f"trace: {field} differs from the "
                                     f"untraced run")
    launches = check_launches("trace", {board_shared: 6})
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = [e for e in kernels if "board_shared_kernel" in e["name"]]
    if len(ours) != 2:
        raise AssertionError(f"trace: {len(ours)} board_shared_kernel events"
                             f" of {len(kernels)} kernel events, expected 2: "
                             f"{sorted({e['name'] for e in kernels})}")
    phase("trace", f"run_chains N=16 C=4096 2 x 2048 steps: untraced "
          f"{plain_s:.3f} s, traced {traced_s[0]:.3f} s (the profiler's "
          f"start included) and {traced_s[1]:.3f} s (trace written: {size} "
          f"bytes, {len(events)} events); result arrays equal; the trace's "
          f"{len(kernels)} kernel events name {ours[0]['name']!r}, "
          f"{sum(e['dur'] for e in ours) / 1e3:.3f} ms of it in 2 launches")
    return launches[board_shared]


def bench_throughput(mod, bounds):
    """``bench._measure`` of the board kernel (``pallas_shared``) or the
    per-chain one (``pallas``) at 32768 and 4096 chains, 3 s each, the
    launches counted; then the kernel alone on the second chunk of a fresh
    state of the same configuration (CUDA events), its implied rate and
    share of its bound.  At 32768 chains the shared-site kernel's bench
    rate must reach 0.95 of the rate its chunk time implies."""
    kernel = "pallas_shared" if mod is board_shared else "pallas"
    seg = 32768
    for chains in (32768, 4096):
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        rate = bench._measure(16, chains, seg, 3.0, kernel)
        n = mod.KERNEL_LAUNCHES
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        _, spec, carry = bench._setup(16, chains, seg, kernel)
        carry, _ = mod.run_segment(carry, 0, spec, 1)
        st = mod.segment_state(carry)
        beta = chunk_betas(spec.schedule, seg, seg, "cuda")
        before = snapshot(st, mod in PER_CHAIN)
        k_ms = cuda_ms(lambda: mod.segment_cuda(st, seg, seg, spec, beta))
        ln = launch_of(spec, before, snapshot(st, mod in PER_CHAIN), seg,
                       seg)
        bound_ms, bound_by = bounds.of(*WORK[mod](ln))
        implied = seg * chains / k_ms * 1e3
        phase("throughput", f"bench._measure N=16 {kernel} chains={chains}:"
              f" {rate:.4e} proposed moves/s ({n} launches, peak device "
              f"memory {peak:.3f} GiB); kernel alone {k_ms:.1f} ms per "
              f"{seg}-step chunk = {implied:.4e} moves/s; bench / kernel "
              f"alone = {rate / implied:.4f}; bound {bound_ms:.1f} ms "
              f"({bound_by}) = {bound_ms / k_ms:.3f} of the kernel's time")
        if n < 2:
            raise AssertionError(f"bench {kernel}: {n} kernel launches")
        if mod is board_shared and chains == 32768 and rate < 0.95 * implied:
            raise AssertionError(f"bench {kernel}: {rate:.4e} moves/s is "
                                 f"under 0.95 of the kernel alone's "
                                 f"{implied:.4e}")
    phase("throughput", "nvidia-smi clocks.sm,power.draw,temperature.gpu: "
          + nvidia_smi("clocks.sm,power.draw,temperature.gpu"))


def bench_cli():
    """``python -m mcqueens_torch.bench --quick`` for each kernel, each in
    a process of its own, the four at once (a smoke check: the rates share
    the card): the last line must be the bench's JSON, with a positive rate
    on the card."""
    t0 = time.perf_counter()
    procs = {kernel: subprocess.Popen(
        [sys.executable, "-m", "mcqueens_torch.bench", "--quick", "--kernel",
         kernel], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for kernel in bench.KERNELS}
    try:
        for kernel, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"bench --quick --kernel {kernel}: rc "
                                     f"{proc.returncode}\n{err[-2000:]}")
            record = json.loads(out.strip().splitlines()[-1])
            if not (record["value"] > 0
                    and record["unit"] == "moves/s/chip"):
                raise AssertionError(f"bench --quick --kernel {kernel}: "
                                     f"{record}")
            phase("bench", f"python -m mcqueens_torch.bench --quick "
                  f"--kernel {kernel}: {json.dumps(record)}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    phase("bench", f"four processes at once: {time.perf_counter() - t0:.1f} s")


def probe_tools_slice():
    """``probe_hold.main`` at each hold for 1 s, and ``probe_largeN.main``
    at N=24 and N=32 for 2 s, on the card, JSON into a temporary directory,
    the launch counts zeroed before each and read after: every hold's
    energies exact, every size's oracle checks passed.  Returns the launches
    of each tool's kernel."""
    launches = {}
    with tempfile.TemporaryDirectory() as d:
        zero_launches()
        for hold in full3d_shared.HOLDS:
            path = os.path.join(d, f"hold{hold}.json")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = probe_hold.main(["--hold", str(hold), "--seconds", "1",
                                      "--json", path])
            with open(path) as f:
                out = json.load(f)
            if rc or not out["energy_exact"] or out["device"] != "cuda":
                raise AssertionError(f"probe_hold --hold {hold}: {out}")
            phase("tools", f"probe_hold --hold {hold} --seconds 1: "
                  f"{json.dumps(out)}")
        launches[full3d_shared] = full3d_shared.KERNEL_LAUNCHES
        if full3d_shared._HOLD != 8:
            raise AssertionError("probe_hold left _HOLD patched")
        zero_launches()
        path = os.path.join(d, "largeN.json")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = probe_largeN.main(["--seconds", "2", "--json", path])
        with open(path) as f:
            out = json.load(f)
        if rc or set(out["sizes"]) != {"N24", "N32"} or not all(
                row["oracle_checked"] for row in out["sizes"].values()):
            raise AssertionError(f"probe_largeN: {out}")
        launches[board_shared] = board_shared.KERNEL_LAUNCHES
        phase("tools", f"probe_largeN --seconds 2: {json.dumps(out)}")
    phase("tools", f"launches: full3d_shared_kernel {launches[full3d_shared]}"
          f" (probe_hold), board_shared_kernel {launches[board_shared]} "
          f"(probe_largeN)")
    return launches


# The mesh phase (dist/mesh.py): each sharded path against its unsharded
# run.  A case is (label, the sampler module, a function of the mesh, None
# for no mesh, returning what is compared bitwise).
MESH_SHARDS = (2, 4)


def result_arrays(res):
    return {field: getattr(res, field) for field in RESULT_ARRAYS}


def tempered_arrays(out):
    return {k: v for k, v in out.items() if k != "wall_time"}


def mesh_cases():
    """The six samplers' paths at their widths: the board CLI's main path
    (N=16, 32768 runs, 50000 steps, stride 48), the board tempered CLI's
    (16 levels; 50000 -> 4800 steps), the floors search (N=15, Q=225,
    65536 chains, 16 levels 0.8->7, two 62500-step chunks; the floors
    slice's cut), the per-chain board at pod scale (N=20, 4096 runs,
    stride 16384; 5M -> 2^17 steps), the per-chain full-3D beta pair 0.5->3
    (N=12, Q=144, 4096 runs, 2^17 steps, stride 16384) and config.yaml's
    first cells on both scans (10 chains, 1M steps, stride 1, tables)."""
    def board(n_steps, stride, schedule):
        return ChainSpec(N=16, n_steps=n_steps, schedule=schedule,
                         init_mode="random", history_stride=stride,
                         kernel="pallas_shared")

    def chains(spec, seeds, **kw):
        return lambda m: result_arrays(runner.run_chains(
            seeds, spec, device="cuda", mesh=m, **kw))

    def tempered(spec, seeds, ladder):
        return lambda m: tempered_arrays(tempering.run_tempered(
            seeds, spec, ladder, device="cuda", swap_seed=int(seeds[0]),
            mesh=m))

    cli_seeds = 42 + np.arange(32768, dtype=np.uint32)
    plain = board(50000, 48, lin(50000, 1.0, 3.0))
    temp = board(4800, 48, const(4800, 1.0))
    f3 = ChainSpec(N=15, n_steps=125000, schedule=const(125000, 1.0),
                   init_mode="random", mcmc_type="full_3d",
                   history_stride=62500, kernel="pallas_shared")
    pod = ChainSpec(N=20, n_steps=1 << 17, schedule=lin(1 << 17, 1.0, 5.0),
                    init_mode="random", history_stride=16384,
                    kernel="pallas", early_stop_patience=None)
    pairs = ChainSpec(N=12, n_steps=1 << 17,
                      schedule=lin(1 << 17, 0.5, 3.0), init_mode="random",
                      mcmc_type="full_3d", history_stride=16384,
                      kernel="pallas")
    exp = build_schedule("exponential_annealing", 10 ** 6, beta_start=1.0,
                         beta_end=3.0)
    scan_b = ChainSpec(N=12, n_steps=10 ** 6, schedule=exp,
                       init_mode="random", kernel="tables",
                       early_stop_patience=None)
    scan_f = ChainSpec(N=12, n_steps=10 ** 6, schedule=lin(10 ** 6, 0.5, 3.0),
                       init_mode="random", mcmc_type="full_3d",
                       kernel="tables")
    ten = 42 + np.arange(10, dtype=np.uint32)
    four_k = 42 + np.arange(4096, dtype=np.uint32)
    return [
        ("board shared N=16 C=32768 (board CLI)", board_shared,
         chains(plain, cli_seeds)),
        ("board shared tempered N=16 C=32768 ladder 16", board_shared,
         tempered(temp, cli_seeds, geometric_ladder(1.0, 3.0, 16))),
        ("full3d shared tempered N=15 Q=225 C=65536 ladder 16 (floors "
         "search)",
         full3d_shared,
         tempered(f3, 31337 + np.arange(65536, dtype=np.uint32),
                  geometric_ladder(0.8, 7.0, 16))),
        ("per-chain board N=20 C=4096 (pod scale)", metropolis_pallas,
         chains(pod, four_k)),
        ("per-chain full3d N=12 Q=144 C=4096 (beta pair 0.5->3)",
         full3d_pallas, chains(pairs, four_k)),
        ("board scan N=12 C=10 (config.yaml)", board_chain,
         chains(scan_b, ten, min_segments=10)),
        ("full3d scan N=12 Q=144 C=10 (config.yaml pairs)", full3d_chain,
         chains(scan_f, ten, min_segments=10)),
    ]


@contextlib.contextmanager
def card_busy(mod):
    """Each card's time in ``mod``'s segments, from CUDA events on its
    current stream around every segment call (a card's segments run while
    the host enqueues the next card's, so their host walls overlap)."""
    spans = collections.defaultdict(list)
    names = [n for n in ("run_segment", "run_segment_tempered")
             if hasattr(mod, n)]
    real = {n: getattr(mod, n) for n in names}

    def wrap(name):
        def call(carry, *args):
            dev = carry.device
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
            out = real[name](carry, *args)
            end.record(torch.cuda.current_stream(dev))
            spans[str(dev)].append((start, end))
            return out
        return call

    for n in names:
        setattr(mod, n, wrap(n))
    try:
        yield spans
    finally:
        for n in names:
            setattr(mod, n, real[n])


def busy_ms(spans):
    torch.cuda.synchronize()
    return {dev: sum(a.elapsed_time(b) for a, b in pairs)
            for dev, pairs in spans.items()}


def run_counted(fn, m):
    """``fn(m)`` with the launch counts zeroed just before and read just
    after; returns (result, wall seconds, launches by module)."""
    zero_launches()
    t0 = time.perf_counter()
    out = fn(m)
    wall = time.perf_counter() - t0
    return out, wall, {mod: mod.KERNEL_LAUNCHES for mod in KERNELS}


def same_arrays(label, want, got):
    for key, w in want.items():
        if not np.array_equal(np.asarray(got[key]), np.asarray(w)):
            raise AssertionError(f"mesh {label}: {key} differs from the "
                                 f"unsharded run")


def pod_scale_mesh(want):
    """configs/pod_scale.yaml as written (``mesh: true``: every visible
    card) through drivers.run_from_config, cut to 2^19 steps as the
    pod-scale slice, its checkpoint_dir in a temporary directory: equal to
    the unsharded slice's result in every ChainResult array."""
    cfg = load_config(os.path.join(REPO, "configs", "pod_scale.yaml"))
    if cfg.tpu.mesh is not True:
        raise AssertionError("configs/pod_scale.yaml no longer sets mesh")
    m = mesh_mod.mesh_for("cuda", cfg.tpu.mesh)
    cfg.common["n_steps"] = POD_SCALE["common"]["n_steps"]
    with tempfile.TemporaryDirectory() as ckdir:
        cfg.tpu.checkpoint_dir = ckdir
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = drivers.run_from_config(cfg, device="cuda",
                                          plot=False)["result"]
        wall = time.perf_counter() - t0
    n_segs, seg_outer = runner.plan_segments(
        -(-cfg.n_steps // cfg.tpu.history_stride), cfg.n_runs,
        cfg.tpu.history_stride, min_segments=10)
    got = check_launches("pod-scale mesh",
                         {metropolis_pallas: n_segs * seg_outer * len(m)})
    same_arrays("pod_scale.yaml", result_arrays(want), result_arrays(res))
    if res.devices != tuple(str(d) for d in mesh_mod.distinct(m)):
        raise AssertionError(f"pod-scale mesh ran on {res.devices}")
    phase("mesh", f"configs/pod_scale.yaml as written (mesh: true -> "
          f"{[str(d) for d in m]}; tpu.checkpoint_dir in a temporary "
          f"directory) cut to {cfg.n_steps} steps: == the unsharded "
          f"pod-scale slice in every ChainResult array; "
          f"{got[metropolis_pallas]} kernel launches; run wall "
          f"{res.wall_time:.3f} s against the unsharded {want.wall_time:.3f}"
          f" s (driver call {wall:.3f} s); "
          f"{profiling.throughput_of(res)}")
    return got[metropolis_pallas]


def mesh_slice(pod_result):
    """(a) pod_scale.yaml with its mesh; (b) every sampler's path on 2 and
    4 shards over cuda:0 against its unsharded run, bitwise, the shards'
    launches counted; (c) the same over distinct cards where more than one
    is visible.  Returns each module's launches in the sharded runs."""
    n_cards = torch.cuda.device_count()
    for dev in mesh_mod.make_mesh():
        # each card's context is made here, not inside a timed run
        torch.zeros(1, device=dev).cpu()
    launches = collections.Counter()
    launches[metropolis_pallas] += pod_scale_mesh(pod_result)
    for label, mod, fn in mesh_cases():
        want, wall0, base = run_counted(fn, None)
        if base[mod] == 0 or sum(base.values()) != base[mod]:
            raise AssertionError(f"mesh {label}: unsharded launches {base}")
        walls = []
        for k in MESH_SHARDS:
            m = mesh_mod.make_mesh(["cuda:0"] * k)
            got, wall, n = run_counted(fn, m)
            same_arrays(f"{label} on {k} shards", want, got)
            if n[mod] != k * base[mod] or sum(n.values()) != n[mod]:
                raise AssertionError(f"mesh {label} on {k} shards: "
                                     f"launches {n}, want {k} x {base[mod]}")
            launches[mod] += n[mod]
            walls.append(f"{k} shards {wall:.3f} s ({n[mod]} launches)")
        if n_cards >= 2:
            m = mesh_mod.make_mesh()
            with card_busy(mod) as spans:
                got, wall, n = run_counted(fn, m)
            same_arrays(f"{label} on {n_cards} cards", want, got)
            if n[mod] != n_cards * base[mod]:
                raise AssertionError(f"mesh {label} on {n_cards} cards: "
                                     f"{n[mod]} launches")
            launches[mod] += n[mod]
            per_card = ", ".join(f"{d} {ms / 1e3:.3f} s"
                                 for d, ms in busy_ms(spans).items())
            walls.append(f"{n_cards} cards {wall:.3f} s (busy: {per_card})")
        phase("mesh", f"{label}: 2 and 4 shards over cuda:0 == unsharded "
              f"in every array; unsharded {wall0:.3f} s ({base[mod]} "
              f"launches), {'; '.join(walls)}")
    if n_cards < 2:
        phase("mesh", f"one card visible ({torch.cuda.get_device_name(0)}; "
              f"nvidia-smi: {nvidia_smi('name,power.limit')}): no mesh "
              f"over distinct cards")
    missing = [KERNELS[mod]["name"] for mod in KERNELS if not launches[mod]]
    if missing:
        raise AssertionError(f"the mesh phase launched no {missing}")
    return launches


MULTIHOST = dict(n=16, n_steps=65536, n_chains=4096)


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_multihost_procs(local_args):
    """``python -m mcqueens_torch.tools.check_multihost`` in one process a
    ``local_args`` entry (its ``--local-shards`` or ``--devices``), all at
    once, at ``MULTIHOST``'s shape; returns (each process's JSON, the wall
    of the whole run).  A port taken before the store binds it is retried
    once on another; a non-zero rc or a timeout raises."""
    n_procs = len(local_args)
    with tempfile.TemporaryDirectory() as tmp:
        for attempt in range(2):
            port = free_port()
            outs = [os.path.join(tmp, f"mh{r}.json") for r in range(n_procs)]
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, "-m", "mcqueens_torch.tools.check_multihost",
                 "--device", "cuda", *local_args[r],
                 "--coordinator", f"localhost:{port}",
                 "--num-processes", str(n_procs), "--process-id", str(r),
                 "--out", outs[r], "--n", str(MULTIHOST["n"]),
                 "--n-steps", str(MULTIHOST["n_steps"]),
                 "--n-chains", str(MULTIHOST["n_chains"]),
                 "--timeout", "120"],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for r in range(n_procs)]
            try:
                logs = [p.communicate(timeout=300)[0] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            wall = time.perf_counter() - t0
            if all(p.returncode == 0 for p in procs):
                results = []
                for path in outs:
                    with open(path) as f:
                        results.append(json.load(f))
                return results, wall
            if attempt == 0 and any("address already in use" in log.lower()
                                    for log in logs):
                continue
            raise AssertionError("check_multihost failed:\n" + "\n---\n".join(
                f"rc {p.returncode}: {log[-3000:]}"
                for p, log in zip(procs, logs)))


def multihost_slice():
    """Two ``check_multihost`` processes on the card, each with 2 shards of
    ``cuda:0`` (and, where more than one card is visible, each with its own
    cards), at N=16, 4096 chains, 65536 steps: both JSONs equal each other
    and the same seeds' one-process ``run_chains`` on the card, bitwise.
    Prints each process's start-up, each shard's scan, the gather and the
    reduce.  Returns the board scan's launches (the one-process run's and
    every process's)."""
    spec = ChainSpec(N=MULTIHOST["n"], n_steps=MULTIHOST["n_steps"],
                     schedule=lin(MULTIHOST["n_steps"], 0.5, 3.0),
                     init_mode="random", mcmc_type="board", kernel="tables",
                     history_stride=MULTIHOST["n_steps"])
    seeds = np.arange(MULTIHOST["n_chains"], dtype=np.uint32)
    with card_busy(board_chain) as spans:
        want, wall0, base = run_counted(
            lambda m: runner.run_chains(seeds, spec, device="cuda"), None)
    (segment_ms,) = busy_ms(spans).values()
    if base[board_chain] != 1 or sum(base.values()) != 1:
        raise AssertionError(f"multihost: one-process launches {base}")
    phase("multihost", f"one process, unsharded: run_chains {wall0:.3f} s "
          f"(its run {want.wall_time:.3f} s, 1 launch of {len(seeds)} "
          f"chains, its segment {segment_ms:.3f} ms on the card); min "
          f"{int(want.final_energy.min())}, sum "
          f"{int(want.final_energy.sum())}")
    launches = 1
    n_cards = torch.cuda.device_count()
    layouts = [("2 processes x 2 shards of cuda:0",
                [["--local-shards", "2"]] * 2)]
    if n_cards >= 2:
        half = n_cards // 2
        layouts.append((f"2 processes x {half} cards", [
            ["--devices", ",".join(f"cuda:{i}" for i in range(half))],
            ["--devices", ",".join(f"cuda:{i}"
                                   for i in range(half, 2 * half))]]))
    for label, local_args in layouts:
        results, wall = check_multihost_procs(local_args)
        per_proc = [int(v) if flag == "--local-shards" else
                    len(v.split(",")) for flag, v in local_args]
        shards = sum(per_proc)
        for r, res in enumerate(results):
            got = {k: res[k] for k in ("final_energy", "min_energy",
                                       "sum_energy")}
            if got != {"final_energy": want.final_energy.tolist(),
                       "min_energy": int(want.final_energy.min()),
                       "sum_energy": int(want.final_energy.sum())}:
                raise AssertionError(f"multihost {label}: process {r} "
                                     f"differs from the one-process run")
            if (res["process_id"], res["n_processes"], res["n_devices"]) != (
                    r, 2, shards):
                raise AssertionError(f"multihost {label}: process {r}: "
                                     f"{res}")
            n_local = res["n_local_devices"]
            if n_local != per_proc[r] or res["kernel_launches"] != n_local:
                raise AssertionError(f"multihost {label}: process {r} "
                                     f"launched {res['kernel_launches']} "
                                     f"scans on {n_local} shards")
            launches += n_local
            s = res["seconds"]
            phase("multihost", f"{label}, process {r} ({res['devices']}): "
                  f"wall {s['wall']:.3f} s; start-up {s['startup']:.3f} s "
                  f"(imports {s['import']:.3f}, group "
                  f"{s['init_distributed']:.3f}, CUDA context "
                  f"{s['cuda_context']:.3f}, library load "
                  f"{s['library_load']:.3f}); a shard's init and scan "
                  f"{', '.join(f'{x:.3f}' for x in s['shards'])} s, its "
                  f"segment on the card "
                  f"{', '.join(f'{x:.3f}' for x in s['shard_segment_ms'])} "
                  f"ms ({-(-len(seeds) // shards)} chains each; unsharded "
                  f"{segment_ms:.3f} ms); gather {s['gather'] * 1e3:.2f} "
                  f"ms, reduce {s['reduce'] * 1e3:.2f} ms")
        phase("multihost", f"{label}: both processes == the one-process "
              f"run in final_energy, min and sum; the two processes' wall "
              f"{wall:.3f} s")
    if n_cards < 2:
        phase("multihost", f"one card visible ({torch.cuda.get_device_name(0)}"
              f"; nvidia-smi: {nvidia_smi('name,power.limit')}): no run "
              f"over distinct cards")
    return launches


def verify_slice(kind, smi):
    """``python -m mcqueens_torch.tools.verify_gpu --json <tmp>``: all six
    checks pass, and the file names the card and its power limit.  Returns
    its launches by kernel module (and the freeze mode's)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "VERIFY_GPU.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mcqueens_torch.tools.verify_gpu",
             "--json", path], cwd=REPO, capture_output=True, text=True,
            timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"verify_gpu: rc {proc.returncode}\n"
                                 f"{proc.stdout[-4000:]}{proc.stderr[-2000:]}")
        with open(path) as f:
            out = json.load(f)
    names = [name for name, _ in verify_gpu.CHECKS]
    if (list(out["checks"]) != names or not out["ok"]
            or any(c["status"] != "pass" for c in out["checks"].values())):
        raise AssertionError(f"verify_gpu: {json.dumps(out)[:3000]}")
    if (out["platform"], out["card"], out["nvidia_smi_name_power_limit"],
            out["smoke_mode"]) != ("gpu", kind, smi, False):
        raise AssertionError(f"verify_gpu: the card in the file: "
                             f"{out['platform']}, {out['card']}, "
                             f"{out['nvidia_smi_name_power_limit']}")
    for name, c in out["checks"].items():
        ran = {k: v for k, v in c["launches"].items() if v}
        phase("verify", f"{name}: pass in {c['seconds']:.3f} s, launches "
              f"{ran}; {c['detail']}")
    launches = collections.Counter(
        {mod: out["launches"][name]
         for name, mod in verify_gpu.KERNEL_MODULES.items()})
    missing = [KERNELS[mod]["name"] for mod in KERNELS if not launches[mod]]
    if missing or not out["launches"]["board_shared_freeze"]:
        raise AssertionError(f"verify_gpu launched no {missing or 'freeze'}")
    # The freeze-mode replay has a row of its own.
    launches[board_shared] -= out["launches"]["board_shared_freeze"]
    launches["freeze"] = out["launches"]["board_shared_freeze"]
    phase("verify", f"python -m mcqueens_torch.tools.verify_gpu: six checks "
          f"pass, {wall:.1f} s wall (process start included); the file "
          f"names {out['card']}, nvidia-smi: "
          f"{out['nvidia_smi_name_power_limit']}")
    return launches


def main():
    t_start = time.perf_counter()
    # 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA GPU (no CPU fallback)")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    phase("device", f"{kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    # 2. build ------------------------------------------------------------
    with timed("build"):
        existed = _build.library_path().exists()
        t0 = time.perf_counter()
        _build.load_library()
        build_s = time.perf_counter() - t0
        phase("build", f"{'loaded existing' if existed else 'nvcc built'} "
              f"{_build.library_path().name} from "
              f"{len(_build.SOURCES)} sources in {build_s:.2f} s")
        log = _build.library_path().with_suffix(".log")
        names = [k["name"] for k in KERNELS.values()] + PROBE_FUNCS
        shared_instances = []
        regs, spills = collections.defaultdict(list), collections.Counter()
        usage = _build.ptxas_usage() if log.exists() else {}
        for entry, use in usage.items():
            kernel = next(n for n in names if mangled(n) in entry)
            if kernel in PROBE_FUNCS:
                # one entry per template instance: summarised below
                regs[kernel].append(use["registers"])
                spills[kernel] += use["spill_bytes"]
                continue
            inst = re.search(r"(board|full3d)_shared_kernelILi(\d+)"
                             r"ELb([01])E(?:Li(\d+)E)?", entry)
            if inst:
                hold = f", H={inst[4]}" if inst[4] else ""
                kernel = (f"{inst[1]}_shared_kernel<L={inst[2]}, "
                          f"{'shared' if inst[3] == '1' else 'device'}"
                          f" memory{hold}>")
                shared_instances.append(kernel)
            inst = re.search(r"(metropolis|full3d_pallas)_kernelILi(\d+)EE",
                             entry)
            if inst:
                kernel = f"{inst[1]}_kernel<L={inst[2]}>"
                shared_instances.append(kernel)
            phase("build", f"{kernel}: {use['registers']} registers, "
                  f"{use['spill_bytes']} bytes of spill stores and loads")
            mod = (full3d_pallas if kernel.startswith("full3d_pallas")
                   else full3d_shared if kernel.startswith("full3d")
                   else metropolis_pallas
                   if kernel.startswith("metropolis") else board_shared)
            if (kernel in shared_instances
                    and use["registers"] > mod.REGISTERS):
                raise AssertionError(
                    f"{kernel} uses {use['registers']} registers; its layout "
                    f"rule reckons with {mod.REGISTERS}")
        built = collections.Counter(k.split("_kernel<")[0]
                                    for k in shared_instances)
        want = {"board_shared": 2 * len(board_shared.LANES),
                "full3d_shared": 2 * len(full3d_shared.LANES)
                * len(full3d_shared.HOLDS),
                "metropolis": len(metropolis_pallas.LANES),
                "full3d_pallas": len(full3d_pallas.LANES)}
        if log.exists() and built != want:
            raise AssertionError(f"team-size kernel instances built: "
                                 f"{shared_instances}")
        for kernel, vals in regs.items():
            phase("build", f"{kernel}: {len(vals)} template instances, "
                  f"{min(vals)}-{max(vals)} registers, {spills[kernel]} "
                  f"bytes of spills in all")
        bounds = Bounds()
        warm_up()

    # 3a. the probe kernels vs their twins --------------------------------
    with timed("compare probes"):
        text = sass_text()
        digest, n_scan = scan_sass_digest(text)
        phase("sass", f"scan samplers ({', '.join(SCAN_KERNELS)}): "
              f"{n_scan} instances, SASS sha256 {digest}")
        hold8 = full3d_sass_digests(text)
        if len(hold8) != 2 * len(full3d_shared.LANES):
            raise AssertionError(f"full3d_shared hold-8 instances in the "
                                 f"SASS: {sorted(hold8)}")
        phase("sass", "full3d_shared_kernel at hold 8, SASS sha256 by "
              "instance: " + ", ".join(
                  f"L={lanes} {'shared' if smem else 'device'} {d}"
                  for (lanes, smem), d in hold8.items()))
        check_sass(sass_loops(text))
        probe_rows = probe_compare(probe_cases(np.random.default_rng(11))
                                   + mem_cases(np.random.default_rng(13)))
        probe_scaling(probe_rows)
        for key, row in probe_rows.items():
            row["work"] = PROBES[key]["work"](row["inputs"], row["kw"])
            phase("probes", f"{row['label']}: "
                  f"{row['work'][0] / row['kernel_ms'] * 1e3:.4e} int32 "
                  f"ops/s as the TPU source counts them")
            row["library_ms"] = probe_library_ms(key, row)
            if row["library_ms"] is not None:
                phase("probes", f"{row['label']}: library call "
                      f"{row['library_ms']:.4f} ms, kernel "
                      f"{row['kernel_ms']:.4f} ms")

    # 3. kernel vs twin ---------------------------------------------------
    ladder = geometric_ladder(0.8, 7.0, 16)
    board_cases = [
        ("board main-path chunk N=16 C=32768 48 steps",
         spec_of(16, 50000, 48, lin(50000, 1.0, 3.0)), 32768, 0, 42, None),
        ("board N=16 C=4096 2048 steps", spec_of(16, 2048, 2048,
                                                 lin(2048, 1.0, 5.0)),
         4096, 0, 0, None),
        ("board N=5 patience 40 beta=50", spec_of(
            5, 600, 600, const(600, 50.0), early_stop_patience=40),
         1024, 0, 3, None),
        ("board N=11 klarner beta=100", spec_of(
            11, 256, 256, const(256, 100.0), init_mode="klarner"),
         256, 0, 0, None),
        ("board N=16 C=4096 step0 > 2^24", spec_of(
            16, 2 ** 25, 1024, lin(2 ** 25, 1.0, 5.0), n_bins=50),
         4096, 16387, 0, None),
        ("board tempered N=16 C=32768 48 steps ladder 16",
         spec_of(16, 50000, 48, const(50000, 1.0)), 32768, 0, 42,
         geometric_ladder(1.0, 3.0, 16)),
    ]
    full3d_cases = [
        ("full3d floors launch N=15 Q=225 C=65536 44 steps ladder 16",
         spec_of(15, 125000, 44, const(125000, 1.0), mcmc_type="full_3d"),
         65536, 0, 31337, ladder),
        ("full3d Q_max launch N=8 Q=48 C=4096 4096 steps",
         spec_of(8, 1 << 18, 4096, lin(1 << 18, 0.5, 5.0),
                 mcmc_type="full_3d", Q=48), 4096, 0, 0, None),
        ("full3d N=5 Q=13 patience 40 beta=50", spec_of(
            5, 600, 600, const(600, 50.0), mcmc_type="full_3d", Q=13,
            early_stop_patience=40), 1024, 0, 3, None),
        ("full3d N=3 Q=26 lazy-dominated", spec_of(
            3, 512, 512, lin(512, 0.5, 3.0), mcmc_type="full_3d", Q=26),
         256, 0, 0, None),
        ("full3d N=8 Q=48 step0 > 2^24", spec_of(
            8, 2 ** 25, 1028, lin(2 ** 25, 0.5, 5.0), mcmc_type="full_3d",
            Q=48, n_bins=50), 4096, 16330, 0, None),
    ]
    metropolis_cases = [
        ("metropolis pod-scale chunk N=20 C=4096 256 steps",
         pspec_of(20, 5_000_000, 256, lin(5_000_000, 1.0, 5.0)), 4096, 0,
         42, None),
        ("metropolis bench shape N=16 C=32768 48 steps",
         pspec_of(16, 2 ** 24, 48, lin(2 ** 24, 1.0, 5.0)), 32768, 0, 0,
         None),
        ("metropolis N=32 C=128 512 steps",
         pspec_of(32, 8_000_000, 512, lin(8_000_000, 1.0, 5.5)), 128, 0,
         4242, None),
        ("metropolis N=5 patience 40 beta=50", pspec_of(
            5, 600, 600, const(600, 50.0), early_stop_patience=40),
         1024, 0, 3, None),
        ("metropolis N=11 klarner beta=100", pspec_of(
            11, 256, 256, const(256, 100.0), init_mode="klarner"),
         256, 0, 0, None),
        ("metropolis N=2", pspec_of(2, 300, 300, lin(300, 0.5, 3.0)), 256, 0,
         0, None),
        ("metropolis N=12 1000 chains (padding)",
         pspec_of(12, 100_000, 128, lin(100_000, 1.0, 3.0)), 1000, 0, 7,
         None),
        ("metropolis N=16 C=4096 step0 > 2^24", pspec_of(
            16, 2 ** 25, 1024, lin(2 ** 25, 1.0, 5.0), n_bins=50),
         4096, 16387, 0, None),
    ]
    # The per-chain board kernel's design edges (kernels/metropolis_pallas.py:
    # layout): each team size forced at the pod-scale width, stops and bin
    # edges inside a batch of draws, segments of 1, B - 1 and B + 1 steps at
    # a whole warp's batch (B = 32) and by the rule, N=170 (the largest it
    # takes), C=4099 (not whole blocks) by the rule and with a ragged last
    # CTA, and the pod-scale launch and the beyond-reference launch at its
    # largest N in full, held against the twin on a sample.  (name, spec,
    # chains, step0, seed0, keywords)
    pod = pspec_of(20, 5_000_000, 256, lin(5_000_000, 1.0, 5.0))
    edge = pspec_of(5, 600, 64, const(600, 50.0), early_stop_patience=13,
                    n_bins=60)
    far = pspec_of(16, 8_000_000, 1, lin(8_000_000, 1.0, 5.5))
    metropolis_design_cases = [
        *[(f"metropolis L={L} forced N=20 C=4096 256 steps", pod, 4096, 0, 42,
           dict(forced=metropolis_forced(20, L, 128 // L)))
          for L in metropolis_pallas.LANES],
        ("metropolis stops and bin edges inside a batch L=32 N=5 C=1024",
         edge, 1024, 0, 3, dict(forced=metropolis_forced(5, 32))),
        ("metropolis stops and bin edges inside a batch N=5 C=4096", edge,
         4096, 0, 3, {}),
        *[(f"metropolis {n}-step segment{' L=32' if L else ''} N=16 C=128",
           dataclasses.replace(far, history_stride=n), 128, 12345, 4242,
           dict(forced=metropolis_forced(16, 32)) if L else {})
          for L in (True, False) for n in (1, 31, 33)],
        ("metropolis N=170 C=16 64 steps", pspec_of(
            170, 10 ** 6, 64, lin(10 ** 6, 1.0, 3.0)), 16, 0, 1, {}),
        ("metropolis C=4099 N=16 256 steps", pspec_of(
            16, 2 ** 24, 256, lin(2 ** 24, 1.0, 5.0)), 4099, 0, 6, {}),
        ("metropolis C=4099 ragged L=32 3 a CTA N=16 256 steps", pspec_of(
            16, 2 ** 24, 256, lin(2 ** 24, 1.0, 5.0)), 4099, 0, 6,
         dict(forced=metropolis_forced(16, 32, 3))),
        ("metropolis pod-scale launch N=20 C=4096 16384 steps from 16384",
         dataclasses.replace(pod, history_stride=16384), 4096, 16384, 42,
         dict(prior=16384, sample=64)),
        ("metropolis beyond-reference launch N=32 C=128 62500 steps",
         pspec_of(32, 8_000_000, 62500, lin(8_000_000, 1.0, 5.5)), 128, 0,
         4242, dict(sample=16)),
    ]
    full3d_pallas_cases = [
        ("full3d_pallas N=12 Q=144 C=4096 256 steps",
         pspec_of(12, 1 << 17, 256, lin(1 << 17, 0.5, 3.0),
                  mcmc_type="full_3d"), 4096, 0, 42, None),
        ("full3d_pallas N=15 Q=225 C=4096 128 steps",
         pspec_of(15, 8_000_000, 128, lin(8_000_000, 0.8, 7.0),
                  mcmc_type="full_3d"), 4096, 0, 0, None),
        ("full3d_pallas N=3 Q=26 long attempt runs", pspec_of(
            3, 512, 512, lin(512, 0.5, 3.0), mcmc_type="full_3d", Q=26),
         256, 0, 0, None),
        ("full3d_pallas N=2 Q=7", pspec_of(
            2, 512, 512, lin(512, 0.5, 3.0), mcmc_type="full_3d", Q=7),
         256, 0, 0, None),
        ("full3d_pallas N=5 Q=13 patience 40 beta=50", pspec_of(
            5, 600, 600, const(600, 50.0), mcmc_type="full_3d", Q=13,
            early_stop_patience=40), 1024, 0, 3, None),
        ("full3d_pallas N=11 klarner Q=121 beta=100", pspec_of(
            11, 256, 256, const(256, 100.0), mcmc_type="full_3d",
            init_mode="klarner"), 256, 0, 0, None),
        ("full3d_pallas N=8 Q=48 step0 > 2^24", pspec_of(
            8, 2 ** 25, 1028, lin(2 ** 25, 0.5, 5.0), mcmc_type="full_3d",
            Q=48, n_bins=50), 1000, 16330, 0, None),
    ]
    # The per-chain full-3D kernel's design edges (kernels/full3d_pallas.py:
    # layout): each team size forced at the beta pairs' width, N=3/Q=26 (one
    # free cell in 27: rounds of attempts past the two drawn ahead) at each
    # team size, C=4099 (not whole blocks) by the rule and with a ragged last
    # CTA, and, held against the twin on a sample, the beta pairs' launch in
    # full from step 0, and its first 2048 steps from step 65536 and the N=15
    # chunk's first 1024 at 65536 chains (the twin's time is per step).
    # (name, spec, chains, step0, seed0, keywords)
    f3p = pspec_of(12, 1 << 17, 256, lin(1 << 17, 0.5, 3.0),
                   mcmc_type="full_3d")
    f3p_dense = pspec_of(3, 512, 128, lin(512, 0.5, 3.0), mcmc_type="full_3d",
                         Q=26)
    pairs = dataclasses.replace(f3p, history_stride=16384)
    f3p_n15 = pspec_of(15, 8_000_000, 8192, lin(8_000_000, 0.8, 7.0),
                       mcmc_type="full_3d")
    full3d_pallas_design_cases = [
        *[(f"full3d_pallas L={L} forced N=12 Q=144 C=4096 256 steps", f3p,
           4096, 0, 42, dict(forced=full3d_pallas_forced(f3p, L, 128 // L)))
          for L in full3d_pallas.LANES],
        *[(f"full3d_pallas long attempt runs L={L} forced N=3 Q=26 C=256",
           f3p_dense, 256, 0, 0,
           dict(forced=full3d_pallas_forced(f3p_dense, L)))
          for L in full3d_pallas.LANES],
        ("full3d_pallas C=4099 N=12 Q=144 256 steps", f3p, 4099, 0, 6, {}),
        ("full3d_pallas C=4099 ragged L=32 3 a CTA N=12 Q=144 256 steps",
         f3p, 4099, 0, 6, dict(forced=full3d_pallas_forced(f3p, 32, 3))),
        ("full3d_pallas beta pairs launch N=12 Q=144 C=4096 16384 steps from 0",
         pairs, 4096, 0, 42, dict(sample=64)),
        ("full3d_pallas beta pairs launch N=12 Q=144 C=4096 2048 steps from "
         "65536", dataclasses.replace(pairs, history_stride=2048), 4096,
         65536, 42, dict(prior=65536, sample=64)),
        ("full3d_pallas N=15 Q=225 C=65536 1024 steps from 8192",
         dataclasses.replace(f3p_n15, history_stride=1024), 65536, 8192, 0,
         dict(prior=8192, sample=64)),
    ]
    rs = np.random.default_rng(7)
    # (name, spec, chains, start_outer, seed0, freeze horizons of C chains)
    freeze_cases = [
        ("board freeze horizons inside the chunk N=16 C=32768 48 steps",
         spec_of(16, 50000, 48, lin(50000, 1.0, 3.0)), 32768, 10, 42,
         lambda C: rs.integers(480, 528, C)),
        ("board freeze at 0 N=16 C=4096", spec_of(
            16, 50000, 48, lin(50000, 1.0, 3.0)), 4096, 0, 42,
         lambda C: np.zeros(C)),
        ("board freeze past n_steps, tail chunk N=16 C=4096", spec_of(
            16, 50000, 48, lin(50000, 1.0, 3.0)), 4096, 1041, 42,
         lambda C: np.full(C, 2 ** 31 - 1)),
        ("board freeze patience 40 beta=50 N=5", spec_of(
            5, 600, 600, const(600, 50.0), early_stop_patience=40), 1024, 0,
         3, lambda C: rs.integers(0, 600, C)),
        ("board freeze 1000 chains (padding) N=12", spec_of(
            12, 100_000, 128, lin(100_000, 1.0, 3.0)), 1000, 0, 7,
         lambda C: rs.integers(0, 160, C)),
    ]
    # The board kernel's layouts and edges (kernels/board_shared.py:layout):
    # each team size and the device-memory instance forced, the rule's
    # device-memory instance, padding chains in the tempered mode, half the
    # chains frozen at 0, patience stops that differ inside a warp, and a
    # warm start at the least energy (no chain may improve, so no best board
    # may be written).  (name, spec, chains, start_outer, seed0, keywords)
    main_spec = spec_of(16, 50000, 48, lin(50000, 1.0, 3.0))
    layout_cases = [
        *[(f"board L={L} forced N=16 C=4096 48 steps", main_spec, 4096, 0,
           42, dict(forced=board_shared.Layout(
               L, 32, board_shared.cta_smem_bytes(16, 32, True))))
          for L in sorted(board_shared.LANES)],
        ("board device memory forced N=16 C=4096 48 steps", main_spec, 4096,
         0, 42, dict(forced=board_shared.Layout(8, 32, 0))),
        ("board device memory N=128 C=256 16 steps", spec_of(
            128, 1 << 20, 16, lin(1 << 20, 1.0, 3.0)), 256, 0, 5, {}),
        ("board tempered 1000 chains (padding) N=16 ladder 16", spec_of(
            16, 50000, 48, const(50000, 1.0)), 1000, 0, 42,
         dict(ladder=geometric_ladder(1.0, 3.0, 16))),
        ("board freeze at 0 for half the chains N=16 C=32768 48 steps",
         main_spec, 32768, 10, 42, dict(freeze=lambda C: np.where(
             np.arange(C) % 2, rs.integers(480, 528, C), 0))),
        ("board patience stops inside a warp N=5 C=4096", spec_of(
            5, 600, 64, const(600, 50.0), early_stop_patience=13), 4096, 0,
         3, {}),
        ("board warm start at the least energy N=11 klarner beta=0.5",
         spec_of(11, 256, 256, const(256, 0.5)), 256, 0, 0,
         dict(warm=lambda C: fastinit.board_init_batch(
             torch.zeros(C, dtype=torch.int32), 11, "klarner").numpy())),
    ]
    # The full-3D shared kernel's layouts and edges
    # (kernels/full3d_shared.py:layout): each team size forced at the floors
    # launch's width, the device-memory instance forced and picked by the
    # rule (a slot of 2Q words fits no CTA past Q = 29055), padding chains in
    # the tempered mode, patience stops that differ inside a warp, chains
    # whose best planes fall far behind their live ones in one long launch,
    # and a warm start at the least energy (no chain may improve, so no best
    # plane may be written).  (name, spec, chains, start_outer, seed0,
    # keywords)
    f3_spec = spec_of(15, 125000, 44, const(125000, 1.0),
                      mcmc_type="full_3d")

    def f3_forced(L, smem=True):
        cpb = min(32, 512 // L)
        return full3d_shared.Layout(
            L, cpb, full3d_shared.cta_smem_bytes(225, L, cpb) if smem else 0)

    full3d_layout_cases = [
        *[(f"full3d L={L} forced N=15 Q=225 C=4096 44 steps ladder 16",
           f3_spec, 4096, 0, 31337, dict(ladder=ladder, forced=f3_forced(L)))
          for L in full3d_shared.LANES],
        ("full3d device memory forced N=15 Q=225 C=4096 44 steps ladder 16",
         f3_spec, 4096, 0, 31337, dict(ladder=ladder,
                                       forced=f3_forced(8, False))),
        ("full3d device memory by the rule N=31 Q=29100 C=128 16 steps",
         spec_of(31, 1 << 20, 16, lin(1 << 20, 0.5, 3.0), mcmc_type="full_3d",
                 Q=29100), 128, 0, 5, {}),
        ("full3d tempered 1000 chains (padding) N=15 ladder 16", f3_spec,
         1000, 0, 42, dict(ladder=ladder)),
        ("full3d patience stops inside a warp N=5 Q=13 C=4096", spec_of(
            5, 600, 64, const(600, 50.0), mcmc_type="full_3d", Q=13,
            early_stop_patience=13), 4096, 0, 3, {}),
        ("full3d best planes far behind N=6 Q=36 C=4096 2048 steps beta 0.3",
         spec_of(6, 2048, 2048, const(2048, 0.3), mcmc_type="full_3d", Q=36),
         4096, 0, 5, {}),
        ("full3d warm start at the least energy N=11 klarner beta=0.5",
         spec_of(11, 256, 256, const(256, 0.5), mcmc_type="full_3d"), 256, 0,
         0, dict(warm=lambda C: fastinit.full3d_init_batch(
             torch.zeros(C, dtype=torch.int32), 11, "klarner").numpy())),
    ]
    # (name, spec, chains, start_outer, n_outer, seed0, warm start)
    scan_board_cases = [
        ("board_scan config.yaml cell N=12 C=10 stride 1",
         spec_of(12, 10 ** 6, 1, build_schedule(
             "exponential_annealing", 10 ** 6, beta_start=1.0,
             beta_end=3.0), kernel="tables"), 10, 0, 128, 42, False),
        ("board_scan config.yaml cell N=18 C=10 stride 1 mid-run",
         spec_of(18, 10 ** 6, 1, build_schedule(
             "exponential_annealing", 10 ** 6, beta_start=1.0,
             beta_end=5.0), kernel="tables"), 10, 5000, 128, 10042, False),
        ("board_scan N=2 stride 7 tail past n_steps",
         spec_of(2, 100, 7, lin(100, 0.5, 3.0), kernel="tables"), 256, 0,
         15, 0, False),
        ("board_scan N=6 patience 30 beta=50",
         spec_of(6, 150, 50, const(150, 50.0), kernel="tables",
                 early_stop_patience=30), 1024, 0, 3, 3, False),
        ("board_scan N=16 C=4096 warm start",
         spec_of(16, 2 ** 24, 64, lin(2 ** 24, 1.0, 5.0), kernel="tables"),
         4096, 0, 2, 5, True),
        # The kernel draws 32 steps at a time from each segment's first
        # step: stops inside a batch, segments of 1, 31 and 33 steps, a
        # segment from start_outer > 0 with stride > 1, a C that is not a
        # multiple of the chains per block, and an N whose table stays in
        # device memory (tables) beside the same N in shared memory (naive).
        ("board_scan N=5 patience 13 stops inside 32-step batches",
         spec_of(5, 300, 50, const(300, 50.0), kernel="tables",
                 early_stop_patience=13), 1024, 0, 6, 5, False),
        ("board_scan N=12 C=10 one-step segment",
         spec_of(12, 10 ** 6, 1, build_schedule(
             "exponential_annealing", 10 ** 6, beta_start=1.0,
             beta_end=3.0), kernel="tables"), 10, 77, 1, 42, False),
        ("board_scan N=7 31-step segment",
         spec_of(7, 1000, 31, lin(1000, 0.5, 3.0), kernel="tables"), 300, 0,
         1, 1, False),
        ("board_scan N=7 33-step segment",
         spec_of(7, 1000, 11, lin(1000, 0.5, 3.0), kernel="tables"), 300, 0,
         3, 2, False),
        ("board_scan N=9 start_outer 7 stride 13",
         spec_of(9, 400, 13, lin(400, 0.5, 3.0), kernel="tables", n_bins=7),
         300, 7, 5, 4, False),
        ("board_scan N=16 C=4099 warm start",
         spec_of(16, 2 ** 24, 64, lin(2 ** 24, 1.0, 5.0), kernel="tables"),
         4099, 0, 1, 6, True),
        ("board_scan N=48 C=8 table in device memory",
         spec_of(48, 10 ** 6, 100, lin(10 ** 6, 1.0, 3.0), kernel="tables"),
         8, 0, 3, 7, False),
    ]
    scan_full3d_cases = [
        ("full3d_scan config.yaml pairs cell N=12 Q=144 C=10 stride 1",
         spec_of(12, 10 ** 6, 1, lin(10 ** 6, 0.5, 3.0), kernel="tables",
                 mcmc_type="full_3d"), 10, 0, 128, 42, False),
        ("full3d_scan N=12 Q=144 C=4096", spec_of(
            12, 10 ** 6, 32, lin(10 ** 6, 0.5, 3.0), kernel="tables",
            mcmc_type="full_3d"), 4096, 0, 2, 42, False),
        ("full3d_scan N=2 Q=7 stride 5 tail past n_steps", spec_of(
            2, 12, 5, lin(12, 0.5, 3.0), kernel="tables",
            mcmc_type="full_3d", Q=7), 16, 0, 3, 0, False),
        ("full3d_scan N=5 Q=13 patience 30 beta=50", spec_of(
            5, 120, 40, const(120, 50.0), kernel="tables",
            mcmc_type="full_3d", Q=13, early_stop_patience=30), 256, 0, 3,
         3, False),
        ("full3d_scan N=3 Q=26 one free cell", spec_of(
            3, 6, 3, lin(6, 0.5, 3.0), kernel="tables",
            mcmc_type="full_3d", Q=26), 16, 0, 2, 0, False),
        ("full3d_scan N=6 Q=36 warm start", spec_of(
            6, 10 ** 6, 32, lin(10 ** 6, 0.5, 3.0), kernel="tables",
            mcmc_type="full_3d"), 1024, 3, 2, 9, True),
        # The kernel draws 32 steps and two rejection attempts at a time
        # from each segment's first step: stops inside a batch, segments of
        # 1, 31 and 33 steps, a segment from start_outer > 0 with stride >
        # 1, a C that is not a multiple of the chains per block, nearly full
        # cubes over more than a batch (every accepted move frees the cell
        # the next proposals may draw; N=3 Q=26 has one free cell, so
        # nearly every step walks past its two attempts), and an N whose
        # table stays in device memory (tables) beside the same N in shared
        # memory (naive).
        ("full3d_scan N=4 Q=16 patience 13 stops inside 32-step batches",
         spec_of(4, 300, 50, const(300, 50.0), kernel="tables",
                 mcmc_type="full_3d", Q=16, early_stop_patience=13), 1024,
         0, 2, 5, False),
        ("full3d_scan N=12 Q=144 C=10 one-step segment", spec_of(
            12, 10 ** 6, 1, lin(10 ** 6, 0.5, 3.0), kernel="tables",
            mcmc_type="full_3d"), 10, 77, 1, 42, False),
        ("full3d_scan N=5 Q=13 31-step segment", spec_of(
            5, 1000, 31, lin(1000, 0.5, 3.0), kernel="tables",
            mcmc_type="full_3d", Q=13), 300, 0, 1, 1, False),
        ("full3d_scan N=5 Q=13 33-step segment", spec_of(
            5, 1000, 11, lin(1000, 0.5, 3.0), kernel="tables",
            mcmc_type="full_3d", Q=13), 300, 0, 3, 2, False),
        ("full3d_scan N=6 Q=36 start_outer 7 stride 13", spec_of(
            6, 400, 13, lin(400, 0.5, 3.0), kernel="tables",
            mcmc_type="full_3d", n_bins=7), 300, 7, 5, 4, False),
        ("full3d_scan N=12 Q=144 C=4099 warm start", spec_of(
            12, 10 ** 6, 32, lin(10 ** 6, 0.5, 3.0), kernel="tables",
            mcmc_type="full_3d"), 4099, 0, 1, 6, True),
        ("full3d_scan N=2 Q=7 stride 1 40 steps", spec_of(
            2, 100, 1, lin(100, 0.5, 3.0), kernel="tables",
            mcmc_type="full_3d", Q=7), 256, 0, 40, 0, False),
        ("full3d_scan N=3 Q=26 stride 1 34 steps", spec_of(
            3, 100, 1, lin(100, 0.5, 3.0), kernel="tables",
            mcmc_type="full_3d", Q=26), 64, 0, 34, 0, False),
        ("full3d_scan N=36 Q=1296 C=4 table in device memory", spec_of(
            36, 10 ** 6, 20, lin(10 ** 6, 0.5, 3.0), kernel="tables",
            mcmc_type="full_3d"), 4, 0, 2, 7, False),
    ]
    results, scan_results = {}, {}
    with timed("compare freeze mode"):
        for name, spec, n_chains, start_outer, seed0, frz in freeze_cases:
            res = compare_case(board_shared, name, spec, n_chains,
                               start_outer, seed0, freeze=frz)
            results[name] = dict(res, mod="freeze")
            st = res["st"]
            if "patience" in name and not int(
                    (st.stop_step < spec.n_steps).sum()):
                raise AssertionError(f"{name}: no chain stopped")
            if "at 0" in name and int(st.total_bins.sum()):
                raise AssertionError(f"{name}: a frozen chain moved")
            if "padding" in name and st.energy.shape[0] != 1024:
                raise AssertionError(f"{name}: not padded to 1024")
    with timed("compare board layouts"):
        for name, spec, n_chains, start_outer, seed0, kw in layout_cases:
            res = compare_case(board_shared, name, spec, n_chains,
                               start_outer, seed0, **kw)
            results[name] = dict(
                res, mod="freeze" if "freeze" in kw else board_shared)
            check_layout_case(name, res, kw)
    with timed("compare full3d layouts"):
        for name, spec, n_chains, start_outer, seed0, kw in \
                full3d_layout_cases:
            res = compare_case(full3d_shared, name, spec, n_chains,
                               start_outer, seed0, **kw)
            results[name] = dict(res, mod=full3d_shared)
            check_full3d_case(name, res, kw)
        campaign = campaign_chunk_case(bounds)
        results["full3d campaign chunk"] = dict(campaign, mod=full3d_shared)
    with timed("compare full3d holds"):
        results.update(hold_cases(bounds))
    with timed("compare metropolis design"):
        for name, spec, n_chains, step0, seed0, kw in metropolis_design_cases:
            res = per_chain_case(metropolis_pallas, name, spec, n_chains,
                                 step0, seed0, **kw)
            results[name] = dict(res, mod=metropolis_pallas)
            check_per_chain_case(name, res, kw)
    with timed("compare full3d_pallas design"):
        for name, spec, n_chains, step0, seed0, kw in \
                full3d_pallas_design_cases:
            res = per_chain_case(full3d_pallas, name, spec, n_chains, step0,
                                 seed0, **kw)
            results[name] = dict(res, mod=full3d_pallas)
            check_per_chain_case(name, res, kw)
    with timed("compare scan samplers"):
        for mod, cases in ((board_chain, scan_board_cases),
                           (full3d_chain, scan_full3d_cases)):
            for (name, spec, n_chains, start_outer, n_outer, seed0,
                 warm) in cases:
                out = scan_compare(mod, name, spec, n_chains, start_outer,
                                   n_outer, seed0, warm)
                for kern, res in out.items():
                    scan_results[f"{name} {kern}"] = res
                if "patience" in name and not int(
                        out["tables"]["st"].done.sum()):
                    raise AssertionError(f"{name}: no chain stopped")
                if "device memory" in name:
                    shared = {k: scan_layout(mod, dataclasses.replace(
                        spec, kernel=k), n_chains).in_shared
                        for k in ("tables", "naive")}
                    if shared != {"tables": False, "naive": True}:
                        raise AssertionError(f"{name}: layouts {shared}")
                if "C=4099" in name and all(
                        n_chains % scan_layout(mod, res["spec"], n_chains)
                        .chains_per_block == 0 for res in out.values()):
                    raise AssertionError(f"{name}: C is a multiple of the "
                                         f"chains per block")
                if "inside 32-step" in name:
                    st = out["tables"]["st"]
                    t = st.stop_step[st.done != 0] - start_outer * \
                        spec.history_stride
                    inside = int((t % 32 != 31).sum())
                    if not inside:
                        raise AssertionError(f"{name}: no stop inside a "
                                             f"batch")
                    phase("compare", f"{name}: {inside} of "
                          f"{int(st.done.sum())} stops inside a batch")
    with timed("compare"):
        for mod, cases in ((board_shared, board_cases),
                           (full3d_shared, full3d_cases),
                           (metropolis_pallas, metropolis_cases),
                           (full3d_pallas, full3d_pallas_cases)):
            for name, spec, n_chains, start_outer, seed0, lad in cases:
                res = compare_case(mod, name, spec, n_chains, start_outer,
                                   seed0, lad)
                results[name] = dict(res, mod=mod)
                st = res["st"]
                if "patience" in name:
                    stopped = int((st.stop_step < spec.n_steps).sum())
                    if stopped == 0:
                        raise AssertionError(f"{name}: no chain stopped")
                    phase("compare", f"{name}: {stopped}/{n_chains} chains "
                          f"stopped")
                if "klarner" in name and (int(st.energy.abs().max())
                                          or int(st.best_energy.abs().max())):
                    raise AssertionError("klarner energies left 0")
                if "2^24" in name:
                    step0 = start_outer * spec.history_stride
                    if step0 <= 2 ** 24 or float(np.float32(step0 + 1)) == (
                            step0 + 1):
                        raise AssertionError(f"{name} does not exercise "
                                             "float32 step rounding")
                if "lazy" in name:
                    share = float(st.accept_bins.sum() / st.total_bins.sum())
                    phase("compare", f"{name}: accept share {share:.4f} "
                          f"(1 of 27 candidates is free)")
                if "padding" in name and st.energy.shape[0] != 1024:
                    raise AssertionError(f"{name}: not padded to 1024")

    # 4. the main paths end to end ---------------------------------------
    with timed("slice board"):
        board_launches = board_slice()
    with timed("slice board tempered"):
        board_tempered_slice()
    with timed("slice full3d floors"):
        full3d_launches = full3d_slice()
    with timed("slice qmax"):
        qmax_search()
    with timed("slice qmax push killed and resumed"):
        full3d_launches += qmax_push_slice()
    with timed("slice floors campaign"):
        floors = floors_campaign_slice()
        full3d_launches += floors[full3d_shared]
        board_launches += floors[board_shared]
    with timed("slice committed certificates"):
        committed_certificates()
    optional_modules()
    with timed("slice pod scale"):
        metropolis_launches, pod_result = pod_scale_slice()
    with timed("slice pod scale killed and resumed"):
        metropolis_launches += pod_scale_resume(pod_result)
    with timed("mesh"):
        mesh_launches = mesh_slice(pod_result)
    with timed("multihost"):
        multihost_launches = multihost_slice()
    with timed("verify"):
        verify_launches = verify_slice(kind, smi)
    with timed("slice beyond reference"):
        metropolis_launches += beyond_reference_slice()
    with timed("slice full3d pairs"):
        full3d_pallas_launches = full3d_pairs_slice()
    with timed("slice recover"):
        check_chunk_betas()
        recovered = recover_slice()
    with timed("slice config.yaml"):
        board_scan_launches = config_yaml_slice()
    with timed("slice config.yaml pairs as full_3d"):
        full3d_scan_launches = full3d_tables_pairs_slice()
    with timed("slice trace"):
        board_launches += trace_slice()

    # 5. throughput -------------------------------------------------------
    with timed("throughput board"):
        bench_throughput(board_shared, bounds)
    with timed("throughput full3d"):
        horizon = 8_000_000
        throughput(full3d_shared, "full_3d N=15 Q=225 (campaign chunks)",
                   spec_of(15, horizon, 62500, lin(horizon, 0.8, 7.0),
                           mcmc_type="full_3d"),
                   (65536, 4096), bounds)
    with timed("throughput metropolis"):
        metropolis_table(bounds)
        bench_throughput(metropolis_pallas, bounds)
    with timed("bench --quick"):
        bench_cli()
    with timed("throughput full3d_pallas"):
        horizon = 8_000_000
        throughput(full3d_pallas, "full3d_pallas N=15 Q=225",
                   pspec_of(15, horizon, 8192, lin(horizon, 0.8, 7.0),
                            mcmc_type="full_3d"),
                   (65536, 4096), bounds)
    with timed("throughput board_scan"):
        scan_config_launch(board_chain, bounds)
        horizon = 2 ** 24
        scan_throughput(board_chain, "board_scan N=16",
                        spec_of(16, horizon, 16384, lin(horizon, 1.0, 5.0),
                                kernel="tables"), 4096, bounds)
    with timed("throughput full3d_scan"):
        scan_config_launch(full3d_chain, bounds)
        horizon = 10 ** 6
        scan_throughput(full3d_chain, "full3d_scan N=12 Q=144",
                        spec_of(12, horizon, 16384, lin(horizon, 0.5, 3.0),
                                kernel="tables", mcmc_type="full_3d"),
                        4096, bounds)

    # 6. the measurement tools --------------------------------------------
    with timed("slice tools"):
        tool_launches, tool_outs = tools_slice()
        check_rates(tool_outs, bounds)
    with timed("slice probe tools"):
        probe_tools_slice()

    leaked = sorted(m for m in set(sys.modules) - _PRELOADED
                    if m == "jax" or m.startswith(("jax.", "mcqueens.",
                                                   "tools.")))
    if leaked:
        raise AssertionError(f"the port imported {leaked}")

    rows = []
    for mod, launches, case in (
            (board_shared, board_launches, "board N=16 C=4096 2048 steps"),
            (full3d_shared, full3d_launches,
             "full3d floors launch N=15 Q=225 C=65536 44 steps ladder 16"),
            (metropolis_pallas, metropolis_launches,
             "metropolis pod-scale chunk N=20 C=4096 256 steps"),
            (full3d_pallas, full3d_pallas_launches,
             "full3d_pallas N=12 Q=144 C=4096 256 steps")):
        res = results[case]
        bound_ms, bound_by = bounds.of(*res["work"])
        phase("bound", f"{KERNELS[mod]['name']} on '{case}': "
              f"{res['work'][0]:.4e} int32 ops, {res['work'][1]:.4e} bytes "
              f"-> bound {bound_ms:.4f} ms ({bound_by}) = "
              f"{bound_ms / res['kernel_ms']:.3f} of the kernel's "
              f"{res['kernel_ms']:.4f} ms"
              f"{jax_count_note(mod, res['ln'], bounds, res['kernel_ms'])}")
        rows.append({
            **KERNELS[mod],
            "route": "cuda",
            "launches": launches + mesh_launches[mod] + verify_launches[mod],
            "mesh_launches": mesh_launches[mod],
            "verify_launches": verify_launches[mod],
            "max_abs_err": max(r["err"] for r in results.values()
                               if r["mod"] is mod),
            "ms": res["kernel_ms"],
            "plain_ms": res["twin_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # No single PyTorch call computes a Metropolis launch.
            "library_ms": None,
        })
    # The per-chain full-3D kernel at its main path's launch, and at the
    # first 1024 steps of the N=15 chunk.
    for case, res in results.items():
        if res["mod"] is full3d_pallas and (
                "launch" in case or "steps from 8192" in case):
            bound_ms, bound_by = bounds.of(*res["work"])
            note = jax_count_note(full3d_pallas, res["ln"], bounds,
                                  res["kernel_ms"])
            phase("bound", f"{KERNELS[full3d_pallas]['name']} on '{case}': "
                  f"bound {bound_ms:.4f} ms ({bound_by}) = "
                  f"{bound_ms / res['kernel_ms']:.3f} of the kernel's "
                  f"{res['kernel_ms']:.4f} ms{note}")
    scan_rows = (
        (FREEZE_ROW, recovered["launches"], results,
         "board freeze horizons inside the chunk N=16 C=32768 48 steps",
         "freeze"),
        (KERNELS[board_chain], board_scan_launches, scan_results,
         "board_scan N=16 C=4096 warm start tables", board_chain),
        (KERNELS[full3d_chain], full3d_scan_launches, scan_results,
         "full3d_scan N=12 Q=144 C=4096 tables", full3d_chain))
    for row, launches, table, case, tag in scan_rows:
        res = table[case]
        if tag != "freeze":
            row = {**row, "mesh_launches": mesh_launches[tag]}
            launches += mesh_launches[tag]
        if tag is board_chain:
            row["multihost_launches"] = multihost_launches
            launches += multihost_launches
        row = {**row, "verify_launches": verify_launches[tag]}
        launches += verify_launches[tag]
        bound_ms, bound_by = bounds.of(*res["work"])
        phase("bound", f"{row['name']} on '{case}': {res['work'][0]:.4e} "
              f"int32 ops, {res['work'][1]:.4e} bytes -> bound "
              f"{bound_ms:.4f} ms ({bound_by}) = "
              f"{bound_ms / res['kernel_ms']:.3f} of the kernel's "
              f"{res['kernel_ms']:.4f} ms")
        rows.append({
            **row,
            "route": "cuda",
            "launches": launches,
            "max_abs_err": max(r["err"] for r in table.values()
                               if r["mod"] == tag),
            "ms": res["kernel_ms"],
            "plain_ms": res["twin_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })
    rows += probe_kernel_rows(probe_rows, tool_launches, bounds)
    phase("done", f"all phases passed in {time.perf_counter() - t_start:.1f} "
          f"s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
