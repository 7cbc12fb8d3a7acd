"""Chain-block sizing, copied from :mod:`mcqueens.kernels.sizing`.

On the TPU these constants fit a block into scoped VMEM.  Here they are
semantics, not tuning: the block decides which chains share a proposal-site
stream and fixes the block seeds, so the port keeps the TPU's partition
exactly (4.6x pipeline factor, 90 MiB budget) to reproduce its trajectories.
"""

from __future__ import annotations

_LANE = 128
_PIPELINE_FACTOR = 4.6
_BUDGET = 90 * 1024 * 1024


def block_cap(state_rows: int, default_block: int) -> int:
    """Largest lane-multiple block whose (TPU) VMEM estimate fits."""
    per_chain = _PIPELINE_FACTOR * 4.0 * state_rows
    cap = int(_BUDGET / (per_chain * _LANE)) * _LANE
    return max(_LANE, min(default_block, cap))


def block_size(n_chains: int, cap: int) -> int:
    """Block for ``n_chains`` chains under ``cap``: whole cap-sized blocks
    when chains are plentiful, one lane-rounded block otherwise."""
    if n_chains >= cap:
        return cap
    return min(cap, -(-n_chains // _LANE) * _LANE)
