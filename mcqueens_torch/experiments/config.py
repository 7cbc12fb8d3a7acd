"""Experiment configs, port of :mod:`mcqueens.experiments.config`.

The reference YAML schema verbatim (``experiment_type``, ``common`` with the
``betta_scheduling`` spelling, one section per experiment type) plus the
optional ``tpu:`` section, which keeps its name because the repo's configs
use it:

    tpu:
      kernel: tables | naive | pallas | pallas_shared
      history_stride: int
      n_bins: int
      mesh: false                 # multi-GPU sharding: not ported yet
      checkpoint_dir: null        # one resumable checkpoint a sweep cell
      profile_dir: null           # profiler traces: not ported yet
      allow_correlated_runs: bool # required (true) for pallas_shared

``mesh`` and ``profile_dir`` set to anything but off raise
``NotImplementedError`` (ROADMAP.md queue 1 item 7).  ``yaml`` is imported
only by :func:`load_config`, so a config built as a dict needs no YAML
package.
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
    for key in ("mesh", "profile_dir"):
        if getattr(tpu, key):
            raise NotImplementedError(
                f"tpu.{key}: not ported to mcqueens_torch yet (ROADMAP.md "
                f"queue 1 item 7); leave it off or use python -m "
                f"mcqueens.cli.experiments")
    return Config(raw=raw, experiment_type=experiment_type,
                  common=raw["common"], tpu=tpu)
