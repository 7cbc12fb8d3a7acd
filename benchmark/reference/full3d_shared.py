"""The reference of the shared-site full-3D sampler (family
``full3d_shared``).

A configuration of this family names N and Q; a chain is Q queens on
distinct cells of the N^3 cube, one of them (the mover) held for ``HOLD``
steps at a time.  :mod:`benchmark.check` asks a family for the chains'
initial states, the queens of a state (for its energy) and a walk of one
chain.
"""

from __future__ import annotations

from benchmark.reference import chains as R
from benchmark.reference import states as S

# The mover hold: the JAX kernel's and the port's.
HOLD = 8
# A reported state row, as the walk gives it: Q (i, j, k) queens.
STATE_SHAPE = (-1, 3)


def _block_rows(config: dict) -> int:
    """Rows of state a chain takes in the sampler's block partition."""
    return 6 * (-(-config["Q"] // 8) * 8)


def initial_states(config: dict, seeds):
    """(C, Q, 3) initial placements of the chains with ``seeds``."""
    return S.full3d_init(seeds, config["N"], config["Q"])


def queens(config: dict, states):
    """(C, Q, 3) queens of ``states``: the states themselves."""
    return states


def walk(spec, base: int, chain: int, init, betas,
         precision: str = "float32"):
    """Every result of the walk of chain ``chain`` of the search with base
    seed ``base`` from ``init``, with step betas ``betas``: one, or one
    for each branch of an ambiguous accept test."""
    config, n_steps, stride = spec.config, spec.n_steps, spec.stride
    N, Q = config["N"], config["Q"]
    block = R.block_size(_block_rows(config), spec.chains, spec.shards)
    seed, block_seed = base + chain, R.block_of(chain, block, base)
    draws = R.full3d_draws(seed, block_seed, N, Q, n_steps, stride, HOLD)
    K, A = R.accept_limits(draws[3], betas, precision)
    return R.replay(R.replay_full3d, init, N, draws, K, A, n_steps, stride,
                    spec.n_bins)
