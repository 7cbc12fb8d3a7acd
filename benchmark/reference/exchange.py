"""Replica exchange of a tempered search, worked out from its energies.

Chain ``c`` starts at ladder level ``c % L`` of group ``c // L``.  After
every round but the last, adjacent levels of each group try to swap their
betas, pairs (0,1), (2,3), ... in even rounds and (1,2), (3,4), ... in odd
ones: the pair swaps when ``log(u) < (b_lo - b_hi) * (E_lo - E_hi)`` in
float32, ``u`` the pair's 24-bit uniform (at least 1e-12) hashed from
(swap seed, round, group, pair).  Given each chain's energy after every
round, the betas of every round follow.

``log`` on the card is float32 and not correctly rounded, so a test within
a few ulps of its threshold is ambiguous; a group that meets one is marked
and left out of what is compared from that round on.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import hashing as H

_ULPS = 3


def ladder(beta_min: float, beta_max: float, levels: int) -> np.ndarray:
    """The geometric ladder, float32."""
    return np.geomspace(beta_min, beta_max, levels).astype(np.float32)


def betas_by_round(history: np.ndarray, lad: np.ndarray, swap_seed: int,
                   keep=()):
    """``(final betas (C,), betas of the chains ``keep`` in every round
    (R, len(keep)), ambiguous groups (G,) bool)`` of a search whose chains
    had energies ``history`` (C, R + 1): the initial energy, then one a
    round."""
    C, R = history.shape[0], history.shape[1] - 1
    L = lad.shape[0]
    G = C // L
    paired = G * L
    betas = np.tile(lad, -(-C // L))[:C].copy()
    kept = np.empty((R, len(keep)), np.float32)
    amb = np.zeros(G, bool)
    gid = np.arange(G, dtype=np.int64)[:, None]
    f32 = np.float32
    for r in range(R):
        kept[r] = betas[list(keep)]
        if r + 1 == R:
            break
        phase = r % 2
        lo = np.arange(phase, L - 1, 2)
        hi = lo + 1
        b = betas[:paired].reshape(G, L)
        e = history[:paired, r + 1].reshape(G, L).astype(f32)
        bl, bh = b[:, lo], b[:, hi]
        log_a = ((bl - bh).astype(f32) * (e[:, lo] - e[:, hi]).astype(f32)
                 ).astype(f32)
        key = H.round_key(swap_seed, r)
        w = H.lowbias32((H.lowbias32(key ^ H.mul32(gid, H.GROUP_K)
                                     ^ H.PAIR_K)
                         + H.mul32(lo[None, :].astype(np.int64), H.PAIR_K))
                        & H.MASK)
        u = np.maximum(H.uniform24(w).astype(f32) * f32(2.0 ** -24),
                       f32(1e-12))
        log_u = np.log(u.astype(np.float64))
        tol = _ULPS * np.spacing(log_u.astype(f32)).astype(np.float64)
        gap = log_u - log_a.astype(np.float64)
        amb |= (np.abs(gap) <= np.abs(tol)).any(1)
        swap = gap < 0
        nb = b.copy()
        nb[:, lo] = np.where(swap, bh, bl)
        nb[:, hi] = np.where(swap, bl, bh)
        betas[:paired] = nb.reshape(-1)
    return betas, kept, amb
