"""The board sampler's carry, port of ``PallasBoardCarry``.

In the JAX package the carry lives in ``mcqueens/kernels/metropolis_pallas.py``
(the per-chain kernel); here it has a neutral home so the shared-site path
does not depend on the per-chain sampler.  Same fields, shapes and dtypes,
chains-major, padded to whole blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BoardCarry:
    """Sampler state between segments (all int32 tensors on one device)."""

    block_seeds: torch.Tensor   # (n_blocks, 1) per-block site-stream seed
    chain_seeds: torch.Tensor   # (C, 1) per-chain stream seeds
    heights: torch.Tensor       # (C, N*N)
    best_heights: torch.Tensor  # (C, N*N)
    energy: torch.Tensor        # (C, 1)
    best_energy: torch.Tensor   # (C, 1)
    best_step: torch.Tensor     # (C, 1)
    no_improve: torch.Tensor    # (C, 1)
    stop_step: torch.Tensor     # (C, 1) (== n_steps when never stopped)
    accept_bins: torch.Tensor   # (C, n_bins)
    total_bins: torch.Tensor    # (C, n_bins)

    @property
    def device(self) -> torch.device:
        return self.heights.device


FIELDS = tuple(f.name for f in dataclasses.fields(BoardCarry))


def carry_from_numpy(arrays, device) -> BoardCarry:
    """A carry from numpy arrays (a mapping, or a JAX ``PallasBoardCarry``
    converted field by field), placed on ``device``.

    This is how a JAX run's state crosses into the port: the same fields,
    shapes and int32 values, so the port resumes the JAX trajectory exactly.
    """
    if not isinstance(arrays, Mapping):
        arrays = arrays._asdict()
    missing = set(FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"carry arrays lack fields {sorted(missing)}")
    out = {}
    for name in FIELDS:
        a = np.asarray(arrays[name])
        if a.dtype != np.int32 or a.ndim != 2:
            raise ValueError(f"{name}: want a 2-D int32 array, got "
                             f"{a.ndim}-D {a.dtype}")
        out[name] = torch.from_numpy(np.array(a, order="C")).to(device)
    return BoardCarry(**out)


def carry_to_numpy(carry: BoardCarry) -> dict[str, np.ndarray]:
    """The carry's fields as host numpy arrays (inverse of
    :func:`carry_from_numpy`)."""
    return {name: getattr(carry, name).cpu().numpy() for name in FIELDS}
