"""Work of one launch of the per-chain board sampler.

Frozen from ``chip_smoke.metropolis_work``, counted from
``csrc/metropolis.cu``: a move at site (i, j) scores the same lines as the
shared-site sampler, 12 int32 operations a cell averaged over the N^2
sites, plus 24 for the step's three hashes and 16 for its site, height and
bin arithmetic.  Bytes: the launch's state read once and written once,
counted from its shapes as for the shared-site sampler (the carries hold
the same fields).
"""

from benchmark.work import board_shared


def launch(config: dict, chains: int, n_inner: int, n_bins: int = 100):
    """(int32 operations, bytes) of one launch of ``n_inner`` steps over
    ``chains`` chains of the board configuration ``config``."""
    ops = chains * n_inner * (12 * board_shared.line_cells(config["N"]) + 40)
    return ops, board_shared.launch(config, chains, n_inner, n_bins)[1]
