"""Static chain configuration, port of :mod:`mcqueens.chain.spec`.

Same fields, defaults and guards as the JAX :class:`ChainSpec`; only its
schedule type is the port's.  The port runs all four kernels: the scan
samplers ``tables`` (the default) and ``naive``, and the ``pallas`` and
``pallas_shared`` samplers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from mcqueens_torch.core.schedules import Schedule

KERNELS = ("tables", "naive", "pallas", "pallas_shared")
MCMC_TYPES = ("board", "full_3d")


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Everything static about a batch of Metropolis chains (see the JAX
    :class:`mcqueens.chain.spec.ChainSpec` for each field's meaning)."""

    N: int
    n_steps: int
    schedule: Schedule
    init_mode: str = "random"
    mcmc_type: str = "board"
    Q: Optional[int] = None
    early_stop_patience: Optional[int] = None
    history_stride: int = 1
    n_bins: int = 100
    kernel: str = "tables"

    def __post_init__(self):
        if self.kernel not in KERNELS:
            raise ValueError(f"Unknown kernel: {self.kernel}")
        if self.mcmc_type not in MCMC_TYPES:
            raise ValueError(f"Unknown mcmc_type: {self.mcmc_type}")
        if (self.mcmc_type == "full_3d"
                and self.Q is not None and self.Q >= self.N ** 3):
            raise ValueError("full_3d requires Q < N^3 (a free cell must "
                             "exist for the move proposal)")
        if self.init_mode not in ("random", "latin", "klarner"):
            raise ValueError(f"Unknown init_mode: {self.init_mode}")
        if self.history_stride < 1:
            raise ValueError("history_stride must be >= 1")
        if self.N < 2:
            raise ValueError("N must be >= 2")
        if self.n_steps * self.n_bins >= 2 ** 31:
            # Bin indices are computed in exact int32 arithmetic on device.
            raise ValueError(
                f"n_steps * n_bins must fit in int32; got {self.n_steps} * "
                f"{self.n_bins}. Reduce n_bins or split the run."
            )

    @property
    def n_history_points(self) -> int:
        """History length: initial energy + one point per stride chunk."""
        return self.n_outer + 1

    @property
    def n_outer(self) -> int:
        return -(-self.n_steps // self.history_stride)

    @property
    def q_eff(self) -> int:
        return self.Q if self.Q is not None else self.N * self.N
