"""The reference of the shared-site board sampler (family ``board_shared``).

A configuration of this family names N; a chain is a board of N^2
heights.  :mod:`benchmark.check` asks a family for the chains' initial
states, the queens of a state (for its energy) and a walk of one chain.
"""

from __future__ import annotations

from benchmark.reference import chains as R
from benchmark.reference import states as S

# A reported state row, as the walk gives it: the N^2 heights.
STATE_SHAPE = (-1,)


def _block_rows(config: dict) -> int:
    """Rows of state a chain takes in the sampler's block partition."""
    N = config["N"]
    return 5 * (-(-N // 8) * 8) * N


def initial_states(config: dict, seeds):
    """(C, N, N) initial heights of the chains with ``seeds``."""
    return S.board_init(seeds, config["N"])


def queens(config: dict, states):
    """(C, N^2, 3) queens of ``states``."""
    return S.board_cells(states)


def walk(spec, base: int, chain: int, init, betas,
         precision: str = "float32"):
    """Every result of the walk of chain ``chain`` of the search with base
    seed ``base`` from ``init``, with step betas ``betas``: one, or one
    for each branch of an ambiguous accept test."""
    config, n_steps, stride = spec.config, spec.n_steps, spec.stride
    N = config["N"]
    block = R.block_size(_block_rows(config), spec.chains, spec.shards)
    seed, block_seed = base + chain, R.block_of(chain, block, base)
    draws = R.board_draws(seed, block_seed, N, n_steps)
    K, A = R.accept_limits(draws[2], betas, precision)
    return R.replay(R.replay_board, init, N, draws, K, A, n_steps, stride,
                    spec.n_bins)
