"""Work of one launch of the shared-site board sampler.

Operations per proposal are fixed by the algorithm: a move at site (i, j)
scores every other cell of row i, column j and the two diagonals through
(i, j), 12 int32 operations a cell (two differences, their squares against
the offset's, four compares and the sum), averaged over the N^2 sites the
site hash draws uniformly, and 32 for the step's four hashes.  Bytes: the
launch's state read once and written once, counted from its shapes: each
chain's heights and best heights (N^2 words each), six scalars and two rows
of bins, and the launch's betas.
"""


def line_cells(n: int) -> float:
    """Off-site cells on the row, column and both diagonals of a site,
    averaged over the n^2 sites."""
    cells = 0
    for i in range(n):
        for j in range(n):
            cells += 2 * (n - 1)
            for x in range(n):
                d = x - i
                cells += (d != 0 and 0 <= j + d < n) + (
                    d != 0 and 0 <= j - d < n)
    return cells / (n * n)


def launch(config: dict, chains: int, n_inner: int, n_bins: int = 100):
    """(int32 operations, bytes) of one launch of ``n_inner`` steps over
    ``chains`` chains of the board configuration ``config``."""
    N = config["N"]
    ops = chains * n_inner * (12 * line_cells(N) + 32)
    words = chains * (2 * N * N + 6 + 2 * n_bins)
    return ops, 4 * (2 * words + n_inner)
