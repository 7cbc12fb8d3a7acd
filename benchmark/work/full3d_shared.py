"""Work of one launch of the shared-site full-3D sampler.

Operations are fixed by the algorithm: 22 int32 operations a (queen,
target) pair of the attack test (the JAX kernel's count), with a chain's
targets the candidates of its steps plus its mover's own cell once a chunk
of ``HOLD`` steps; the hold is the reference's 8, whatever the program
runs.  Bytes: the launch's state read once and written once, counted from
its shapes: each chain's queens and best queens (3Q words each), six
scalars and two rows of bins, and the launch's betas.
"""

HOLD = 8
OPS_PER_PAIR = 22


def launch(config: dict, chains: int, n_inner: int, n_bins: int = 100):
    """(int32 operations, bytes) of one launch of ``n_inner`` steps over
    ``chains`` chains of the full-3D configuration ``config``."""
    Q = config["Q"]
    targets = n_inner + -(-n_inner // HOLD)
    ops = chains * targets * Q * OPS_PER_PAIR
    words = chains * (6 * Q + 6 + 2 * n_bins)
    return ops, 4 * (2 * words + n_inner)
