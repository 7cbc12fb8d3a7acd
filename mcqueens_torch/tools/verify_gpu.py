#!/usr/bin/env python
"""One-command check of the kernel invariants on the card (PyTorch port of
``python -m tools.verify_tpu``).

The test suite runs on the CPU (the kernels' plain twins, and their host
emulation); this tool replays the invariants on the card in one command, at
the JAX tool's sizes and by its checks' names, and writes the outcome to
``artifacts/h100/VERIFY_GPU.json``:

  1. ``tables_equals_naive``: the two scan modes' trajectories, bitwise.
  2. ``incremental_vs_oracle``: final and best energies == a straight-loop
     re-score (:func:`mcqueens_torch.tools.verify_board.energy`) for all
     seven kernel / mode pairs.
  3. ``card_vs_twin_streams``: the board shared-site kernel (256 chains,
     1024 steps) and both full-3D kernels (N=6, 128 chains, 512 steps) on
     the card and as their twins on the CPU: every carry field and ``ys``
     bitwise (the counter-hash streams replay anywhere).
  4. ``klarner_zero``: the Klarner start at N=11 has energy 0 and a cold
     chain keeps it.
  5. ``recover_best_heights``: replayed best boards == tracked ones.
  6. ``init_energy_at_scale``: initial energies == the oracle at C=65536,
     N=18 (the size at which a TPU build once returned a wrong constant).

Every sampler kernel launches; the file holds, beside each check's status,
detail and seconds, its kernel launches, the card's name and power limit
(``nvidia-smi``) and ``ok``.  The exit code is 1 if any check fails.

    python -m mcqueens_torch.tools.verify_gpu [--json PATH]

Without CUDA it raises: a CPU run happens only when asked, ``--device
cpu``, which writes ``"smoke_mode": true`` and holds check 3's twins to the
host emulation of the same ``.cu`` sources
(:mod:`mcqueens_torch.kernels.host_emulation`, g++).  ``--quick`` cuts the
sizes, on the CPU only, and the file lists each cut.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
import traceback

import numpy as np
import torch

from mcqueens_torch import tools
from mcqueens_torch.chain import board as board_chain
from mcqueens_torch.chain import full3d as full3d_chain
from mcqueens_torch.chain.spec import ChainSpec
from mcqueens_torch.core.schedules import build_schedule, chunk_betas
from mcqueens_torch.dist import runner
from mcqueens_torch.kernels import (board_shared, full3d_pallas,
                                    full3d_shared, host_emulation,
                                    metropolis_pallas)
from mcqueens_torch.tools.verify_board import energy as oracle_energy

DEFAULT_JSON = tools.H100_ARTIFACTS / "VERIFY_GPU.json"
# Kernel launch counters, by the CUDA source's name.
KERNEL_MODULES = {"board_scan": board_chain, "full3d_scan": full3d_chain,
                  "board_shared": board_shared,
                  "full3d_shared": full3d_shared,
                  "metropolis": metropolis_pallas,
                  "full3d_pallas": full3d_pallas}
EMULATED_SMS = 2


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Each check's chains and steps: the JAX tool's, or ``QUICK``'s."""

    steps: int = 2000               # checks 1 and 2 (8 and 4 chains)
    stride: int = 500
    board_chains: int = 256         # check 3, board shared-site
    board_steps: int = 1024
    board_stride: int = 256
    f3_chains: int = 128            # check 3, both full-3D kernels
    f3_steps: int = 512
    f3_stride: int = 128
    klarner_steps: int = 512        # check 4
    klarner_stride: int = 256
    recover_chains: int = 256       # check 5
    recover_steps: int = 2048
    recover_stride: int = 512
    scale_chains: int = 65536       # check 6


FULL = Sizes()
QUICK = Sizes(steps=200, stride=50, board_chains=64, board_steps=64,
              board_stride=32, f3_chains=32, f3_steps=64, f3_stride=32,
              klarner_steps=64, klarner_stride=32, recover_chains=64,
              recover_steps=256, recover_stride=64, scale_chains=256)


@dataclasses.dataclass(frozen=True)
class Battery:
    device: torch.device
    sizes: Sizes = FULL


def _spec(**kw) -> ChainSpec:
    """The JAX tool's ``_spec``: N=8 boards, linear 0.5 -> 3."""
    n_steps = kw.pop("n_steps")
    defaults = dict(
        N=8,
        n_steps=n_steps,
        schedule=build_schedule("linear_annealing", n_steps,
                                beta_start=0.5, beta_end=3.0),
        init_mode="random",
        mcmc_type="board",
        history_stride=kw.pop("history_stride"),
    )
    defaults.update(kw)
    return ChainSpec(**defaults)


def board_oracle(heights) -> int:
    """A board's energy by the straight loop over its N^2 queens."""
    h = np.asarray(heights)
    return oracle_energy([(i, j, int(h[i, j])) for i in range(h.shape[0])
                          for j in range(h.shape[1])])


def full3d_oracle(queens) -> int:
    return oracle_energy(np.asarray(queens).tolist())


def check_tables_equals_naive(b: Battery) -> str:
    """Golden-trajectory equality of the two scan modes."""
    s = b.sizes
    seeds = np.arange(8, dtype=np.uint32)
    res = {kern: runner.run_chains(
        seeds, _spec(kernel=kern, n_steps=s.steps, history_stride=s.stride),
        device=b.device) for kern in ("tables", "naive")}
    a, n = res["tables"], res["naive"]
    for field in ("energy_history", "final_state", "best_state",
                  "accept_bins"):
        if not np.array_equal(getattr(a, field), getattr(n, field)):
            raise AssertionError(f"tables and naive differ in {field}")
    return f"tables == naive bitwise over {s.steps} steps x 8 chains"


PAIRS = (("tables", "board"), ("naive", "board"), ("pallas", "board"),
         ("pallas_shared", "board"), ("pallas", "full_3d"),
         ("tables", "full_3d"), ("pallas_shared", "full_3d"))


def check_incremental_vs_oracle(b: Battery) -> str:
    """Final and best incremental energies == the oracle, every kernel."""
    s = b.sizes
    seeds = np.arange(4, dtype=np.uint32)
    for kern, mt in PAIRS:
        res = runner.run_chains(
            seeds, _spec(kernel=kern, mcmc_type=mt, n_steps=s.steps,
                         history_stride=s.stride), device=b.device)
        oracle = board_oracle if mt == "board" else full3d_oracle
        for r in range(res.n_runs):
            for what in ("final", "best"):
                got = int(getattr(res, f"{what}_energy")[r])
                want = oracle(getattr(res, f"{what}_state")[r])
                if got != want:
                    raise AssertionError(f"{kern}/{mt} chain {r} {what}: "
                                         f"energy {got}, oracle {want}")
    return ("incremental == oracle (final+best) for "
            + ", ".join(f"{k}/{m}" for k, m in PAIRS))


_CARRY_OF = {
    board_shared: lambda st, carry: board_shared.carry_of(st),
    full3d_shared: lambda st, carry: full3d_shared.carry_of(st, carry.occ),
    full3d_pallas: lambda st, carry: full3d_pallas.carry_of(
        st, carry.block_seeds),
}


def emulated_segment(mod, carry, spec: ChainSpec):
    """``mod.run_segment(carry, 0, spec, spec.n_outer)`` of CPU state
    through the host emulation of the module's ``.cu`` source, launch by
    launch as the card runs it; returns ``(carry, ys)``."""
    lib = host_emulation.load()
    st = mod.segment_state(carry)
    stride = spec.history_stride
    ys = torch.empty((spec.n_outer, st.energy.shape[0]), dtype=torch.int32)
    for o in range(spec.n_outer):
        beta = chunk_betas(spec.schedule, o * stride, stride, "cpu")
        mod.launch_segment(lib, st, o * stride, stride, spec, beta,
                           n_sm=EMULATED_SMS)
        ys[o].copy_(st.energy)
    return _CARRY_OF[mod](st, carry), ys


def same_segment(label: str, want, want_ys, got, got_ys) -> None:
    """Every carry field and ``ys`` equal, bitwise."""
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if (w is None) != (g is None) or (
                w is not None and not torch.equal(w.cpu(), g.cpu())):
            raise AssertionError(f"{label}: carry field {f.name} differs")
    if not torch.equal(want_ys.cpu(), got_ys.cpu()):
        raise AssertionError(f"{label}: ys differs")


def check_card_vs_twin_streams(b: Battery) -> str:
    """The counter-hash kernels give bitwise the same trajectories on the
    card as their twins on the CPU (on ``--device cpu``: the twins and the
    host emulation of the card's source)."""
    s = b.sizes
    other = ("card" if b.device.type == "cuda"
             else "the host emulation of its .cu source")
    cases = (
        ("pallas_shared(board)", board_shared, s.board_chains,
         _spec(kernel="pallas_shared", n_steps=s.board_steps,
               history_stride=s.board_stride)),
        ("pallas(full_3d)", full3d_pallas, s.f3_chains,
         _spec(kernel="pallas", mcmc_type="full_3d", N=6,
               n_steps=s.f3_steps, history_stride=s.f3_stride)),
        ("pallas_shared(full_3d)", full3d_shared, s.f3_chains,
         _spec(kernel="pallas_shared", mcmc_type="full_3d", N=6,
               n_steps=s.f3_steps, history_stride=s.f3_stride)),
    )
    for label, mod, n_chains, spec in cases:
        seeds = np.arange(n_chains, dtype=np.uint32)
        twin, twin_ys = mod.run_segment(
            mod.init_carry_batch(seeds, spec, device="cpu"), 0, spec,
            spec.n_outer)
        if b.device.type == "cuda":
            got, ys = mod.run_segment(
                mod.init_carry_batch(seeds, spec, device=b.device), 0, spec,
                spec.n_outer)
        else:
            got, ys = emulated_segment(
                mod, mod.init_carry_batch(seeds, spec, device="cpu"), spec)
        same_segment(label, twin, twin_ys, got, ys)
    return (f"{other} == twin bitwise, every carry field and ys: "
            + ", ".join(c[0] for c in cases))


def check_klarner_zero(b: Battery) -> str:
    s = b.sizes
    spec = _spec(N=11, init_mode="klarner", kernel="pallas_shared",
                 n_steps=s.klarner_steps, history_stride=s.klarner_stride,
                 schedule=build_schedule("constant", s.klarner_steps,
                                         beta_const=100.0))
    res = runner.run_chains(np.arange(4, dtype=np.uint32), spec,
                            device=b.device)
    if not (res.energy_history[:, 0] == 0).all():
        raise AssertionError(f"Klarner start energies "
                             f"{res.energy_history[:, 0].tolist()}")
    if not (res.best_energy == 0).all():
        raise AssertionError(f"best energies {res.best_energy.tolist()}")
    return "Klarner N=11 init energy 0, cold chain stays at 0"


def check_recover_best_heights(b: Battery) -> str:
    s = b.sizes
    spec = _spec(kernel="pallas_shared", n_steps=s.recover_steps,
                 history_stride=s.recover_stride)
    seeds = np.arange(s.recover_chains, dtype=np.uint32)
    tracked, _ = board_shared.run_segment(
        board_shared.init_carry_batch(seeds, spec, device=b.device), 0,
        spec, spec.n_outer)
    untracked, _ = board_shared.run_segment(
        board_shared.init_carry_batch(seeds, spec, device=b.device), 0,
        spec, spec.n_outer, track_best=False)
    rec = board_shared.recover_best_heights(untracked, spec)
    want = tracked.best_heights.reshape(-1, spec.N, spec.N)
    if not torch.equal(rec.cpu(), want.cpu()):
        bad = int((rec != want).reshape(rec.shape[0], -1).any(1).sum())
        raise AssertionError(f"replayed best boards differ on {bad} chains")
    return (f"replayed best boards == tracked best boards "
            f"({s.recover_chains} chains)")


def check_init_energy_at_scale(b: Battery) -> str:
    """Initial energies == the oracle at the 65536-chain campaign scale:
    one fixed board warm-starting every chain, and fresh starts
    spot-checked."""
    C, N = b.sizes.scale_chains, 18
    spec = _spec(N=N, kernel="pallas_shared", n_steps=64, history_stride=64)
    seeds = np.arange(C, dtype=np.uint32)
    rng = np.random.default_rng(0)
    board = rng.integers(0, N, size=(N, N)).astype(np.int32)
    want = board_oracle(board)
    carry = board_shared.init_carry_batch(
        seeds, spec, initial_states=np.repeat(board[None], C, axis=0),
        device=b.device)
    e = carry.energy.reshape(-1).cpu()
    if not bool((e == want).all()):
        raise AssertionError(f"warm energies in [{int(e.min())}, "
                             f"{int(e.max())}], oracle {want}")
    fresh = board_shared.init_carry_batch(seeds, spec, device=b.device)
    e2 = fresh.energy.reshape(-1).cpu()
    h2 = fresh.heights.reshape(-1, N, N).cpu().numpy()
    for r in (0, 1, C // 2, C - 1):
        if board_oracle(h2[r]) != int(e2[r]):
            raise AssertionError(f"fresh chain {r}: energy {int(e2[r])}, "
                                 f"oracle {board_oracle(h2[r])}")
    return (f"init energies at C={C}, N={N} == oracle "
            f"(warm {want}; fresh spot-checked)")


CHECKS = [
    ("tables_equals_naive", check_tables_equals_naive),
    ("incremental_vs_oracle", check_incremental_vs_oracle),
    ("card_vs_twin_streams", check_card_vs_twin_streams),
    ("klarner_zero", check_klarner_zero),
    ("recover_best_heights", check_recover_best_heights),
    ("init_energy_at_scale", check_init_energy_at_scale),
]


def launch_counts() -> dict:
    counts = {name: mod.KERNEL_LAUNCHES
              for name, mod in KERNEL_MODULES.items()}
    counts["board_shared_freeze"] = board_shared.FREEZE_LAUNCHES
    return counts


def run_check(fn, battery: Battery) -> dict:
    """One check: its status (``pass`` or ``fail``), detail (the check's
    line or the traceback), seconds and the kernel launches it made."""
    before = launch_counts()
    t0 = time.time()
    try:
        detail, status = fn(battery), "pass"
    except Exception:  # noqa: BLE001
        detail, status = traceback.format_exc(limit=5), "fail"
    after = launch_counts()
    return {"status": status, "detail": detail,
            "seconds": time.time() - t0,
            "launches": {k: after[k] - before[k] for k in after}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--json", default=str(DEFAULT_JSON),
                        help="where to write the results (not under the "
                             "TPU's artifacts/)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card; raises without one) or cpu "
                             "(a smoke run of the twins and the emulation)")
    parser.add_argument("--quick", action="store_true",
                        help="smaller sizes, for --device cpu only")
    args = parser.parse_args(argv)
    dev = tools.device(args.device)
    smoke = dev.type == "cpu"
    if args.quick and not smoke:
        parser.error("--quick cuts the sizes for the CPU tests only")
    tools.output_path(args.json)  # refuse a bad path before the checks run
    sizes = QUICK if args.quick else FULL
    battery = Battery(dev, sizes)
    out = {"platform": "cpu" if smoke else "gpu", **tools.card(dev),
           "smoke_mode": smoke, "checks": {}, "ok": True}
    if args.quick:
        out["quick_cuts"] = {
            f.name: [getattr(FULL, f.name), getattr(QUICK, f.name)]
            for f in dataclasses.fields(Sizes)
            if getattr(FULL, f.name) != getattr(QUICK, f.name)}
    if smoke:
        print("[warn] --device cpu: a smoke run of the twins and the host "
              "emulation; nothing here certifies a card", flush=True)
    for name, fn in CHECKS:
        res = run_check(fn, battery)
        out["checks"][name] = res
        out["ok"] &= res["status"] == "pass"
        print(f"[{res['status'].upper()}] {name} ({res['seconds']:.1f}s): "
              f"{res['detail']}"[:500], flush=True)
    out["launches"] = {k: sum(c["launches"][k]
                              for c in out["checks"].values())
                       for k in launch_counts()}
    tools.write_json(args.json, out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
