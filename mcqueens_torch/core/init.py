"""Initializer constants, port of the part of :mod:`mcqueens.core.init` that
the hash-based initializers (:mod:`mcqueens_torch.core.fastinit`) use."""

from __future__ import annotations

import math

INIT_MODES = ("random", "latin", "klarner")


def _klarner_core_m(N: int) -> int:
    """Largest M < N with gcd(M, 210) == 1."""
    for m in range(N - 1, 0, -1):
        if math.gcd(m, 210) == 1:
            return m
    raise ValueError(f"Could not find M < {N} with gcd(M,210)==1 (N={N}).")
