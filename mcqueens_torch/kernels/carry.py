"""The samplers' carries, ports of ``PallasBoardCarry`` and
``PallasFull3DCarry``.

In the JAX package the carries live with the per-chain kernels
(``mcqueens/kernels/metropolis_pallas.py``, ``full3d_pallas.py``); here they
have a neutral home so the shared-site paths do not depend on the per-chain
samplers.  Same fields, field order, shapes and dtypes, chains-major, padded
to whole blocks.
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


@dataclasses.dataclass(frozen=True)
class Full3DCarry:
    """Full-3D sampler state between segments (all int32 tensors on one
    device).  ``occ`` is built at init and passed through unchanged by the
    shared-site sampler, which reads occupancy off the coordinate planes."""

    block_seeds: torch.Tensor   # (n_blocks, 1) per-block stream seed
    chain_seeds: torch.Tensor   # (C, 1) per-chain stream seeds
    qi: torch.Tensor            # (C, Q) queen coordinates
    qj: torch.Tensor
    qk: torch.Tensor
    occ: torch.Tensor           # (C, ceil(N^3/32)) occupancy bitfield
    best_qi: torch.Tensor       # (C, Q) best placement
    best_qj: torch.Tensor
    best_qk: torch.Tensor
    energy: torch.Tensor        # (C, 1)
    best_energy: torch.Tensor   # (C, 1)
    best_step: torch.Tensor     # (C, 1)
    no_improve: torch.Tensor    # (C, 1)
    stop_step: torch.Tensor     # (C, 1) (== n_steps when never stopped)
    accept_bins: torch.Tensor   # (C, n_bins)
    total_bins: torch.Tensor    # (C, n_bins)

    @property
    def device(self) -> torch.device:
        return self.qi.device


FIELDS = tuple(f.name for f in dataclasses.fields(BoardCarry))
FULL3D_FIELDS = tuple(f.name for f in dataclasses.fields(Full3DCarry))


def fields_of(carry) -> tuple[str, ...]:
    """The field names of a carry of either kind, in order."""
    return tuple(f.name for f in dataclasses.fields(carry))


def carry_from_numpy(arrays, device):
    """A carry from numpy arrays (a mapping, or a JAX ``PallasBoardCarry`` /
    ``PallasFull3DCarry`` converted field by field), placed on ``device``;
    the kind follows the fields (``qi`` marks a full-3D carry).

    This is how a JAX run's state crosses into the port: the same fields,
    shapes and int32 values, so the port resumes the JAX trajectory exactly.
    """
    if not isinstance(arrays, Mapping):
        arrays = arrays._asdict()
    cls, names = ((Full3DCarry, FULL3D_FIELDS) if "qi" in arrays
                  else (BoardCarry, FIELDS))
    missing = set(names) - set(arrays)
    if missing:
        raise ValueError(f"carry arrays lack fields {sorted(missing)}")
    out = {}
    for name in names:
        a = np.asarray(arrays[name])
        if a.dtype != np.int32 or a.ndim != 2:
            raise ValueError(f"{name}: want a 2-D int32 array, got "
                             f"{a.ndim}-D {a.dtype}")
        out[name] = torch.from_numpy(np.array(a, order="C")).to(device)
    return cls(**out)


def carry_to_numpy(carry) -> dict[str, np.ndarray]:
    """The carry's fields as host numpy arrays (inverse of
    :func:`carry_from_numpy`)."""
    return {name: getattr(carry, name).cpu().numpy()
            for name in fields_of(carry)}
