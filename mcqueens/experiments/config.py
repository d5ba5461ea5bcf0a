"""Config system: accepts the reference YAML schema verbatim, plus a sampler section.

Schema (reference ``config.yaml:1-38``, parsed at ``experiments.py:1204-1218``):

    experiment_type: single_N | measure_min_energy_vs_N | beta_start_end_pairs
                     | compare_beta_end
    common:
      n_steps, n_runs, verbose, initialization, mcmc_type (default "board"),
      early_stop_patience (int | None | the literal string 'None'),
      output_path,
      betta_scheduling:           # (sic — reference key spelling)
        type: <schedule> | [<schedule>, ...]
        base_seed, beta_const, beta_start, beta_end
    single_N: {N}
    measure_min_energy_vs_N: {Ns, init_modes}
    beta_start_end_pairs: {N, beta_start_ends, annealing_type, output_path,
                           output_path_acceptance}
    compare_beta_end: {Ns (exactly 2), beta_start_ends, annealing_type,
                       output_path}

New, optional section (all defaulted so reference configs run unchanged):

    sampler:
      kernel: tables | naive              # delta-E kernel
      history_stride: int                 # energy-history thinning
      n_bins: int                         # acceptance bins (default 100)
      mesh: bool | int                    # shard chains over devices
      checkpoint_dir: str | null          # segment checkpoint/resume
      profile_dir: str | null             # jax.profiler trace output

Any other top-level key is an error, so a misspelled or retired section
cannot be silently ignored.  ``yaml`` is imported only by :func:`load_config`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from mcqueens.chain.spec import KERNELS, REMOVED_KERNELS, REMOVED_MESSAGE

EXPERIMENT_TYPES = (
    "single_N",
    "measure_min_energy_vs_N",
    "beta_start_end_pairs",
    "compare_beta_end",
)


SAMPLER_SECTION = "sampler"


@dataclasses.dataclass
class SamplerConfig:
    kernel: str = "tables"
    history_stride: int = 1
    n_bins: int = 100
    mesh: Any = False          # False | True (all devices) | int (first n)
    checkpoint_dir: Optional[str] = None
    profile_dir: Optional[str] = None


@dataclasses.dataclass
class Config:
    raw: dict
    experiment_type: str
    common: dict
    sampler: SamplerConfig

    def _req(self, key: str):
        # The reference config schema makes these mandatory
        # (``/root/reference/config.yaml:2-18``); name the missing key
        # instead of dying with a bare KeyError deep in a driver.
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
        # The reference accepts the literal string 'None'
        # (config.yaml:9, experiments.py:1216-1218).
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
    common = raw["common"]
    known = {"experiment_type", "common", SAMPLER_SECTION, *EXPERIMENT_TYPES}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(
            f"Unknown top-level config keys: {sorted(unknown)} (run knobs "
            f"such as kernel, history_stride and mesh live under "
            f"'{SAMPLER_SECTION}:')")
    sampler_raw = raw.get(SAMPLER_SECTION, {}) or {}
    if "allow_correlated_runs" in sampler_raw:
        raise ValueError(REMOVED_MESSAGE.format("pallas_shared"))
    allowed = {f.name for f in dataclasses.fields(SamplerConfig)}
    unknown = set(sampler_raw) - allowed
    if unknown:
        raise ValueError(
            f"Unknown {SAMPLER_SECTION} config keys: {sorted(unknown)}")
    sampler = SamplerConfig(**sampler_raw)
    if sampler.kernel in REMOVED_KERNELS:
        raise ValueError(REMOVED_MESSAGE.format(sampler.kernel))
    if sampler.kernel not in KERNELS:
        raise ValueError(f"Unknown kernel: {sampler.kernel}")
    return Config(raw=raw, experiment_type=experiment_type, common=common,
                  sampler=sampler)
