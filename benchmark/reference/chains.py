"""Plain replay of single chains of the shared-site Metropolis samplers.

One chain is walked step by step in Python from its seed: its draws come
from :mod:`.hashing`, its state is a list of queens with a count of queens
on every line (the energy is the sum over lines of C(count, 2), so a move
changes it by the counts on the 12 or 13 lines through the new cell less
those through the old one), and it records what the program reports of it:
the energy after each launch, the final and best states and energies, the
step of the best, and the accepted and proposed moves of each bin.

The accept test is ``u < expf(-float32(beta * dE))`` in float32 on the
card.  Its ``expf`` is not correctly rounded, so a float64 exp decides the
test here only where the two cannot disagree: within a few float32 ulps of
the threshold the step is *ambiguous*, and :func:`replay` follows both
branches (such a step comes about once in tens of chains).  ``precision``
"bfloat16" rounds beta, the product and the threshold to bfloat16 instead:
the lower-precision control of the benchmark's check.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import hashing as H
from benchmark.reference import states

# Float32 ulps around the threshold inside which the card's expf may
# decide either way (its documented error is at most 2 ulps).
_ULPS = 3
# With u = 0 only expf's underflow decides: certain above 2^-145, certain
# below 2^-160 (the smallest float32 is 2^-149; bfloat16 underflows from
# 2^-133, so the window for u = 0 starts at exp(-80)).
_UNDERFLOW = (2.0 ** -145, 2.0 ** -160)


class Ambiguous(Exception):
    """A step whose accept test the float32 card may decide either way."""

    def __init__(self, step: int):
        super().__init__(step)
        self.step = step


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def accept_limits(u24: np.ndarray, beta: np.ndarray,
                  precision: str = "float32", chunk: int = 1 << 16):
    """Per step ``(K, A)``: a move of energy change ``dE`` is accepted
    surely when ``dE <= K``, ambiguously when ``K < dE <= A``, and never
    when ``dE > A``.  ``u24`` are the steps' uniforms times 2^24, ``beta``
    their float32 betas."""
    parts = [_limits(u24[s:s + chunk], np.asarray(beta[s:s + chunk],
                                                   np.float32), precision)
             for s in range(0, u24.shape[0], chunk)]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def _limits(u24, beta, precision):
    u = u24.astype(np.float64) / 2.0 ** 24
    pos = u > 0
    lo_p = np.where(pos, -np.log(np.where(pos, u, 1.0)), 80.0)
    hi_p = np.where(pos, lo_p, 112.0)
    b64 = beta.astype(np.float64)
    first = np.floor(lo_p / b64).astype(np.int64) - 2
    width = int((np.ceil(hi_p / b64) - np.floor(lo_p / b64)).max()) + 5
    de = first[:, None] + np.arange(width)[None, :]
    if precision == "bfloat16":
        bt = _bf16(beta)
        p = _bf16(bt[:, None] * np.maximum(de, 0).astype(np.float32))
        v = _bf16(np.exp(-p.astype(np.float64)).astype(np.float32))
        acc = u[:, None] < v
        rej = ~acc
    else:
        p = beta[:, None] * np.maximum(de, 0).astype(np.float32)
        v = np.exp(-p.astype(np.float64))
        tol = _ULPS * np.spacing(v.astype(np.float32)).astype(np.float64)
        acc = np.where(pos[:, None], u[:, None] < v - tol,
                       v > _UNDERFLOW[0])
        rej = np.where(pos[:, None], u[:, None] >= v + tol,
                       v < _UNDERFLOW[1])
    acc |= de <= 0
    n_acc = np.argmin(acc, axis=1)          # leading sure accepts
    n_live = np.argmax(rej, axis=1)         # first sure reject
    if (not acc[:, 0].all() or not rej[:, -1].all()
            or (n_live < n_acc).any()):
        raise AssertionError("accept_limits: thresholds outside the window")
    return first + n_acc - 1, first + n_live - 1


def _decide(de: int, k: int, a: int, step: int, forced: dict) -> bool:
    if de <= k:
        return True
    if de > a:
        return False
    if step not in forced:
        raise Ambiguous(step)
    return forced[step]


def bin_starts(n_steps: int, n_bins: int):
    """Per bin, its first step (a step's bin is min(s*nb // n, nb - 1))."""
    starts = [0] * n_bins
    for b in range(1, n_bins):
        starts[b] = -(-b * n_steps // n_bins)
    return starts + [n_steps]


def board_lines(N: int):
    """For each (cell i*N + j, height k), the 12 ids of the lines through
    queen (i, j, k) that another board queen can share."""
    ii = torch.arange(N)
    i, j, k = (g.reshape(-1) for g in torch.meshgrid(ii, ii, ii,
                                                     indexing="ij"))
    span = 4 * N
    ids = [states.line_keys(i, j, k, N, d) + n * span * span
           for n, d in enumerate(states.DIRECTIONS) if d != (0, 0, 1)]
    return [tuple(row) for row in torch.stack(ids, 1).tolist()]


def full3d_lines(N: int):
    """For each cell (i*N + j)*N + k, the ids of its 13 lines."""
    ii = torch.arange(N)
    i, j, k = (g.reshape(-1) for g in torch.meshgrid(ii, ii, ii,
                                                     indexing="ij"))
    span = 4 * N
    ids = [states.line_keys(i, j, k, N, d) + n * span * span
           for n, d in enumerate(states.DIRECTIONS)]
    return [tuple(row) for row in torch.stack(ids, 1).tolist()]


def schedule_betas(kind: str, n_steps: int, params: dict) -> np.ndarray:
    """float32 beta of every step: the step as float32, then each operation
    rounded to float32 (``linear``: b0 + (t / (n - 1)) * (b1 - b0))."""
    f32 = np.float32
    if kind == "constant":
        return np.full(n_steps, f32(params["beta_const"]), f32)
    if kind != "linear_annealing":
        raise ValueError(f"schedule {kind!r} is not in the reference")
    b0, b1 = f32(params["beta_start"]), f32(params["beta_end"])
    if n_steps <= 1:
        return np.full(n_steps, b1, f32)
    t = np.arange(n_steps, dtype=np.int64).astype(f32)
    frac = (t / f32(n_steps - 1)).astype(f32)
    return (b0 + (frac * f32(b1 - b0)).astype(f32)).astype(f32)


def board_draws(seed: int, block_seed: int, N: int, n_steps: int):
    """The site cell, height offset and 24-bit uniform of every step."""
    s = torch.arange(n_steps, dtype=torch.int64)
    site_base = (H.mul32(block_seed & H.MASK, H.SITE_MUL) + H.SITE_SALT) \
        & H.MASK
    cell = (H.lowbias32(s ^ site_base) & 0x7FFFFFFF) % (N * N)
    w0, w1 = H.step_words(H.chain_stream(seed & H.MASK), s)
    return (cell.numpy(), (w0 % (N - 1)).numpy(),
            H.uniform24(w1).numpy())


def full3d_draws(seed: int, block_seed: int, N: int, Q: int, n_steps: int,
                 stride: int, hold: int):
    """The candidate cell and 24-bit uniform of every step, and the mover
    of every hold-chunk: chunks start every ``hold`` steps inside each
    launch of ``stride`` steps."""
    s = torch.arange(n_steps, dtype=torch.int64)
    base = H.mul32(block_seed & H.MASK, H.SITE_MUL)
    cand = (H.lowbias32(s ^ ((base + H.CAND_SALT) & H.MASK))
            & 0x7FFFFFFF) % N ** 3
    starts = torch.tensor([l0 + c for l0 in range(0, n_steps, stride)
                           for c in range(0, min(stride, n_steps - l0),
                                          hold)], dtype=torch.int64)
    mover = (H.lowbias32(starts ^ ((base + H.MOVER_SALT) & H.MASK))
             & 0x7FFFFFFF) % Q
    _, w1 = H.step_words(H.chain_stream(seed & H.MASK), s)
    return (cand.numpy(), starts.numpy(), mover.numpy(),
            H.uniform24(w1).numpy())


def _launch_ends(n_steps: int, stride: int):
    return set(range(stride, n_steps, stride)) | {n_steps}


def replay_board(h0, N, draws, K, A, n_steps, stride, n_bins,
                 forced=None, lines=None):
    """Walk one board chain of initial heights ``h0`` ((N, N) ints)
    through ``n_steps`` steps; ``(K, A)`` per step from
    :func:`accept_limits`."""
    forced = forced or {}
    lines = lines or board_lines(N)
    cell_l, kr_l, _ = (x.tolist() for x in draws)
    K, A = K.tolist(), A.tolist()
    h = [int(x) for x in np.asarray(h0).reshape(-1)]
    cnt = [0] * (13 * 16 * N * N)
    for c in range(N * N):
        for line in lines[c * N + h[c]]:
            cnt[line] += 1
    e = sum(n * (n - 1) // 2 for n in cnt)
    e0 = be = e
    best, bs = list(h), 0
    hist, ends = [e0], _launch_ends(n_steps, stride)
    starts = bin_starts(n_steps, n_bins)
    acc_bins, tot_bins = [0] * n_bins, [0] * n_bins
    get = cnt.__getitem__
    for b in range(n_bins):
        n_acc = 0
        for t in range(starts[b], starts[b + 1]):
            c = cell_l[t]
            old = h[c]
            new = old + 1 + kr_l[t]
            if new >= N:
                new -= N
            lo, ln = lines[c * N + old], lines[c * N + new]
            de = sum(map(get, ln)) - sum(map(get, lo)) + len(lo)
            if _decide(de, K[t], A[t], t, forced):
                for line in lo:
                    cnt[line] -= 1
                for line in ln:
                    cnt[line] += 1
                h[c] = new
                e += de
                n_acc += 1
                if e < be:
                    be, bs, best = e, t + 1, list(h)
            if t + 1 in ends:
                hist.append(e)
        acc_bins[b] = n_acc
        tot_bins[b] = starts[b + 1] - starts[b]
    return {"energy_history": hist, "final_energy": e, "final_state": h,
            "best_energy": be, "best_state": best, "best_step": bs,
            "accept_bins": acc_bins, "total_bins": tot_bins}


def replay_full3d(q0, N, draws, K, A, n_steps, stride, n_bins,
                  forced=None, lines=None):
    """Walk one full-3D chain of initial queens ``q0`` ((Q, 3) ints)
    through ``n_steps`` steps (``draws`` from :func:`full3d_draws`)."""
    forced = forced or {}
    lines = lines or full3d_lines(N)
    cand_l, chunk_l, mover_l, _ = (x.tolist() for x in draws)
    K, A = K.tolist(), A.tolist()
    q0 = np.asarray(q0).tolist()
    pos = [(i * N + j) * N + k for i, j, k in q0]
    occ = bytearray(N ** 3)
    cnt = [0] * (13 * 16 * N * N)
    for p in pos:
        occ[p] = 1
        for line in lines[p]:
            cnt[line] += 1
    e = sum(n * (n - 1) // 2 for n in cnt)
    be, best, bs = e, list(pos), 0
    hist, ends = [e], _launch_ends(n_steps, stride)
    starts = bin_starts(n_steps, n_bins)
    acc_bins = [0] * n_bins
    get = cnt.__getitem__
    chunk_l = chunk_l + [n_steps]
    NN = N * N
    for m, mv in enumerate(mover_l):
        mp = pos[mv]
        mi, mj, mk = mp // NN, (mp // N) % N, mp % N
        old_conf = sum(map(get, lines[mp])) - 13
        for t in range(chunk_l[m], chunk_l[m + 1]):
            c = cand_l[t]
            if not occ[c]:
                di, dj, dk = (abs(c // NN - mi), abs((c // N) % N - mj),
                              abs(c % N - mk))
                top = max(di, dj, dk)
                aligned = (di in (0, top) and dj in (0, top)
                           and dk in (0, top))
                new_conf = sum(map(get, lines[c])) - aligned
                de = new_conf - old_conf
                if _decide(de, K[t], A[t], t, forced):
                    for line in lines[mp]:
                        cnt[line] -= 1
                    for line in lines[c]:
                        cnt[line] += 1
                    occ[mp], occ[c] = 0, 1
                    mp = pos[mv] = c
                    mi, mj, mk = c // NN, (c // N) % N, c % N
                    old_conf = new_conf
                    e += de
                    b = min(t * n_bins // n_steps, n_bins - 1)
                    acc_bins[b] += 1
                    if e < be:
                        be, bs, best = e, t + 1, list(pos)
            if t + 1 in ends:
                hist.append(e)
    tot_bins = [starts[b + 1] - starts[b] for b in range(n_bins)]

    def coords(cells):
        return [[p // NN, (p // N) % N, p % N] for p in cells]

    return {"energy_history": hist, "final_energy": e,
            "final_state": coords(pos), "best_energy": be,
            "best_state": coords(best), "best_step": bs,
            "accept_bins": acc_bins, "total_bins": tot_bins}


def replay(walk, *args, max_branches: int = 16, **kw):
    """Every result of ``walk(*args, forced=..., **kw)`` over both branches
    of each ambiguous step (at most ``max_branches`` of them)."""
    out, todo = [], [{}]
    while todo:
        forced = todo.pop()
        try:
            out.append(walk(*args, forced=forced, **kw))
        except Ambiguous as amb:
            if len(out) + len(todo) + 2 > max_branches:
                raise
            todo += [{**forced, amb.step: True}, {**forced, amb.step: False}]
    return out


def block_size(rows: int, chains: int, shards: int = 1) -> int:
    """Chains a block: the JAX package's partition, which decides which
    chains share a site stream.  The cap fits ``rows`` rows of a chain's
    state a block into 90 MiB of TPU memory at 4.6x; a mesh sizes the
    block from one shard's share."""
    cap = int(90 * 2 ** 20 / (4.6 * 4.0 * rows * 128)) * 128
    cap = max(128, min(2048, cap))
    n = -(-chains // shards)
    return cap if n >= cap else min(cap, -(-n // 128) * 128)


def block_of(chain: int, block: int, first_seed: int) -> int:
    """The block seed of ``chain``: int32(seeds[0]) + 7919 * block index,
    as uint32."""
    return (first_seed + H.BLOCK_SEED_STRIDE * (chain // block)) & H.MASK

