"""The reference of the per-chain board sampler (family
``board_perchain``).

A chain is a board of N^2 heights, as in the shared-site family, whose
initial states and queens it shares.  No draw is shared between chains:
at every step a chain draws ``w0, w1`` from its own seed's stream
(:func:`benchmark.reference.hashing.step_words`); the site is ``i = w0 %
N``, ``j = (w0 // N) % N``, the height offset ``(w0 // N^2) % (N - 1)``,
the uniform ``uniform24(w1)``.  So the block partition plays no part.
"""

from __future__ import annotations

import torch

from benchmark.reference import chains as R
from benchmark.reference import hashing as H
from benchmark.reference.board_shared import (STATE_SHAPE,  # noqa: F401
                                              initial_states, queens)


def draws(seed: int, N: int, n_steps: int):
    """The site cell ``i * N + j``, height offset and 24-bit uniform of
    every step of the chain with seed ``seed``."""
    s = torch.arange(n_steps, dtype=torch.int64)
    w0, w1 = H.step_words(H.chain_stream(seed & H.MASK), s)
    cell = (w0 % N) * N + (w0 // N) % N
    return (cell.numpy(), ((w0 // (N * N)) % (N - 1)).numpy(),
            H.uniform24(w1).numpy())


def walk(spec, base: int, chain: int, init, betas,
         precision: str = "float32"):
    """Every result of the walk of chain ``chain`` of the search with base
    seed ``base`` from ``init``, with step betas ``betas``: one, or one
    for each branch of an ambiguous accept test."""
    N, n_steps = spec.config["N"], spec.n_steps
    d = draws(base + chain, N, n_steps)
    K, A = R.accept_limits(d[2], betas, precision)
    return R.replay(R.replay_board, init, N, d, K, A, n_steps, spec.stride,
                    spec.n_bins)
