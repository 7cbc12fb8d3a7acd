"""Experiment configs, port of :mod:`mcqueens.experiments.config`.

The reference YAML schema verbatim (``experiment_type``, ``common`` with the
``betta_scheduling`` spelling, one section per experiment type) plus the
optional ``tpu:`` section, which keeps its name because the repo's configs
use it:

    tpu:
      kernel: tables | naive | pallas | pallas_shared
      history_stride: int
      n_bins: int
      mesh: false                 # true: every device; n: the first n
      checkpoint_dir: null        # one resumable checkpoint a sweep cell
      profile_dir: null           # torch.profiler trace of the sweep
      allow_correlated_runs: bool # required (true) for pallas_shared

``mesh`` shards every run's chains over a device mesh
(:func:`mcqueens_torch.dist.mesh.mesh_for`: on CUDA every visible card or
the first n; on the CPU one shard or n shards of the one CPU device).
``yaml`` is imported only by :func:`load_config`, so a config built as a
dict needs no YAML package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

EXPERIMENT_TYPES = (
    "single_N",
    "measure_min_energy_vs_N",
    "beta_start_end_pairs",
    "compare_beta_end",
)


@dataclasses.dataclass
class TpuConfig:
    kernel: str = "tables"
    history_stride: int = 1
    n_bins: int = 100
    mesh: Any = False          # False | True (all devices) | int (first n)
    checkpoint_dir: Optional[str] = None
    profile_dir: Optional[str] = None
    allow_correlated_runs: bool = False  # opt-in for pallas_shared sweeps


@dataclasses.dataclass
class Config:
    raw: dict
    experiment_type: str
    common: dict
    tpu: TpuConfig

    def _req(self, key: str):
        try:
            return self.common[key]
        except KeyError:
            raise ValueError(
                f"config is missing required key common.{key}") from None

    @property
    def n_steps(self) -> int:
        return int(self._req("n_steps"))

    @property
    def n_runs(self) -> int:
        return int(self._req("n_runs"))

    @property
    def verbose(self) -> bool:
        return bool(self._req("verbose"))

    @property
    def init_mode(self) -> str:
        return self._req("initialization")

    @property
    def mcmc_type(self) -> str:
        return self.common.get("mcmc_type", "board")

    @property
    def early_stop_patience(self):
        # The reference accepts the literal string 'None'.
        v = self.common.get("early_stop_patience", 100000)
        if v in (None, "None", "null"):
            return None
        return int(v)

    @property
    def output_path(self) -> str:
        return self._req("output_path")

    @property
    def sched_cfg(self) -> dict:
        return self._req("betta_scheduling")

    def section(self, name: str) -> dict:
        try:
            return self.raw[name]
        except KeyError:
            raise ValueError(
                f"config is missing the '{name}' section required by "
                f"experiment_type: {self.experiment_type}") from None


def load_config(path: str) -> Config:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    return parse_config(raw)


def parse_config(raw: dict) -> Config:
    for key in ("experiment_type", "common"):
        if key not in raw:
            raise ValueError(f"config is missing the required top-level "
                             f"'{key}' key")
    experiment_type = raw["experiment_type"]
    if experiment_type not in EXPERIMENT_TYPES:
        raise ValueError(f"Unknown experiment_type: {experiment_type}")
    tpu_raw = raw.get("tpu", {}) or {}
    allowed = {f.name for f in dataclasses.fields(TpuConfig)}
    unknown = set(tpu_raw) - allowed
    if unknown:
        raise ValueError(f"Unknown tpu config keys: {sorted(unknown)}")
    tpu = TpuConfig(**tpu_raw)
    if tpu.kernel == "pallas_shared" and not tpu.allow_correlated_runs:
        # The experiment types report statistics over independent runs; the
        # shared-site kernel correlates the chains of each block.
        raise ValueError(
            "tpu.kernel 'pallas_shared' shares proposal sites across each "
            "chain block, so the experiment drivers' runs would NOT be "
            "statistically independent (the reference's n_runs contract). "
            "Use kernel 'pallas' or 'tables', or set "
            "tpu.allow_correlated_runs: true to accept correlated runs.")
    if not isinstance(tpu.mesh, (bool, int)) or (
            not isinstance(tpu.mesh, bool) and tpu.mesh < 0):
        raise ValueError(f"tpu.mesh must be true, false or a device count, "
                         f"got {tpu.mesh!r}")
    return Config(raw=raw, experiment_type=experiment_type,
                  common=raw["common"], tpu=tpu)
