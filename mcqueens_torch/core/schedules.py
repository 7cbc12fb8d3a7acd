"""Inverse-temperature (beta) schedules, port of :mod:`mcqueens.core.schedules`.

The same five closed forms, evaluated in float32 with the JAX package's
operation order: the step goes to float32 first, every constant is a float32
tensor (never a Python scalar, which CUDA turns into a reciprocal multiply),
and each operation is its own torch op, so nothing is contracted into an FMA.
``constant`` and ``linear_annealing`` therefore equal eager JAX bit for bit;
the exp/log/cos kinds can differ in the last bits wherever torch's and
XLA's transcendental functions round differently.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from mcqueens_torch.utils import profiling

SCHEDULE_TYPES = (
    "constant",
    "linear_annealing",
    "exponential_annealing",
    "logarithmic_annealing",
    "sinusoidal_annealing",
)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A beta schedule: a pure map ``step -> beta`` (float32)."""

    kind: str
    n_steps: int
    beta_const: Optional[float] = None
    beta_start: Optional[float] = None
    beta_end: Optional[float] = None

    def __post_init__(self):
        if self.kind not in SCHEDULE_TYPES:
            raise ValueError(f"Unknown betta_scheduling type: {self.kind}")
        if self.kind == "constant":
            if self.beta_const is None:
                raise ValueError("beta_const required for constant schedule")
        else:
            if self.beta_start is None or self.beta_end is None:
                raise ValueError(
                    f"beta_start and beta_end required for {self.kind} schedule"
                )

    def __call__(self, step: torch.Tensor) -> torch.Tensor:
        """Evaluate beta at ``step`` (any numeric tensor) as float32."""
        kind, n = self.kind, self.n_steps
        t = step.to(torch.float32)

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=t.device)

        if kind == "constant":
            return torch.full_like(t, self.beta_const)
        if n <= 1:
            return torch.full_like(t, self.beta_end)
        b0, b1 = f32(self.beta_start), f32(self.beta_end)
        if kind == "linear_annealing":
            frac = t / f32(n - 1)
            return b0 + frac * (b1 - b0)
        if kind == "exponential_annealing":
            log_ratio = math.log(self.beta_end / self.beta_start)
            frac = torch.clamp(t, 0, n - 1) / f32(n - 1)
            return b0 * torch.exp(f32(log_ratio) * frac)
        if kind == "logarithmic_annealing":
            tc = torch.clamp(t, 0, n)
            return b0 + (b1 - b0) * (torch.log1p(tc) / f32(math.log(1 + n)))
        if kind == "sinusoidal_annealing":
            tc = torch.clamp(t, 0, n)
            x = f32(math.pi) * tc / f32(n)
            return b0 + (b1 - b0) * (f32(1.0) - torch.cos(x)) / f32(2.0)
        raise AssertionError(kind)

    @property
    def desc(self) -> str:
        if self.kind == "constant":
            return f"constant beta={self.beta_const}"
        short = {
            "linear_annealing": "linear",
            "exponential_annealing": "exp",
            "logarithmic_annealing": "log",
            "sinusoidal_annealing": "sinusoidal",
        }[self.kind]
        return f"{short} beta: {self.beta_start}->{self.beta_end}"

    @property
    def label(self) -> str:
        if self.kind == "constant":
            return f"Constant beta={self.beta_const}"
        name = {
            "linear_annealing": "Linear",
            "exponential_annealing": "Exponential",
            "logarithmic_annealing": "Logarithmic",
            "sinusoidal_annealing": "Sinusoidal",
        }[self.kind]
        return f"{name} {self.beta_start}->{self.beta_end}"


def chunk_betas(schedule: Schedule, step0: int, n: int,
                device) -> torch.Tensor:
    """(n,) float32 betas of steps ``step0 .. step0 + n - 1``: int32 step
    -> float32 -> schedule, as the JAX kernels evaluate them per step.  A
    sampler computes them once per launch and hands the same tensor to its
    CUDA kernel and to the kernel's plain-torch twin (span ``mcq.betas``)."""
    with profiling.span("mcq.betas"):
        steps = torch.arange(step0, step0 + n, dtype=torch.int32,
                             device=device)
        return schedule(steps).to(torch.float32).contiguous()


def build_schedule(sched_type: str, n_steps: int, beta_const=None,
                   beta_start=None, beta_end=None) -> Schedule:
    """Factory from a flat parameter set."""
    return Schedule(kind=sched_type, n_steps=int(n_steps),
                    beta_const=beta_const, beta_start=beta_start,
                    beta_end=beta_end)


def schedule_from_params(params: dict, n_steps: int) -> Schedule:
    """Factory from a param dict ``{"type": ..., "beta_*": ...}``."""
    return build_schedule(
        sched_type=params["type"],
        n_steps=n_steps,
        beta_const=params.get("beta_const"),
        beta_start=params.get("beta_start"),
        beta_end=params.get("beta_end"),
    )


def schedule_from_common(common_cfg: dict, n_steps: int):
    """``(schedule, base_seed)`` from a config's ``common`` section (the
    reference YAML schema, ``betta_scheduling`` spelling included)."""
    sched_cfg = common_cfg["betta_scheduling"]
    return (build_schedule(sched_type=sched_cfg["type"], n_steps=n_steps,
                           beta_const=sched_cfg.get("beta_const"),
                           beta_start=sched_cfg.get("beta_start"),
                           beta_end=sched_cfg.get("beta_end")),
            sched_cfg.get("base_seed", 0))


def schedules_from_types(sched_types, sched_cfg: dict, n_steps: int):
    """One ``(schedule, base_seed)`` per type, all sharing the config's
    ``base_seed`` and beta values (the multi-schedule comparison)."""
    base_seed = sched_cfg["base_seed"]
    return [(build_schedule(sched_type=kind, n_steps=n_steps,
                            beta_const=sched_cfg.get("beta_const"),
                            beta_start=sched_cfg.get("beta_start"),
                            beta_end=sched_cfg.get("beta_end")), base_seed)
            for kind in sched_types]
