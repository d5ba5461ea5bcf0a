"""Profiling and throughput observability.

The reference computes per-run durations but never reports them
(``experiments.py:415-427``; SURVEY §5.1).  This module surfaces the metrics
that matter for a batched sampler: proposed moves/sec per device, wall time,
and optional ``jax.profiler`` traces viewable in TensorBoard/XProf.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import time

import jax

NVIDIA_SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader")


@dataclasses.dataclass
class ThroughputReport:
    proposals: int
    wall_time_s: float
    n_devices: int

    @property
    def moves_per_sec(self) -> float:
        return self.proposals / max(self.wall_time_s, 1e-9)

    @property
    def moves_per_sec_per_chip(self) -> float:
        return self.moves_per_sec / max(self.n_devices, 1)

    def __str__(self) -> str:
        return (
            f"{self.proposals:.3e} proposals in {self.wall_time_s:.3f}s "
            f"= {self.moves_per_sec:.3e} moves/s "
            f"({self.moves_per_sec_per_chip:.3e} /chip on {self.n_devices})"
        )


def throughput_of(result, n_devices: int | None = None) -> ThroughputReport:
    """Throughput of a :class:`mcqueens.dist.runner.ChainResult`."""
    if n_devices is None:
        n_devices = jax.device_count()
    return ThroughputReport(
        proposals=result.proposals,
        wall_time_s=result.wall_time,
        n_devices=n_devices,
    )


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``jax.profiler`` trace context; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield


@contextlib.contextmanager
def timed(label: str, sink=print):
    t0 = time.time()
    yield
    sink(f"[mcqueens] {label}: {time.time() - t0:.3f}s")


def device_summary(devices=None) -> dict:
    """The device a result was measured on, as JAX reports it."""
    devices = jax.devices() if devices is None else devices
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def require_gpu(devices=None) -> dict:
    """:func:`device_summary`, or RuntimeError unless the devices are GPUs.

    Device measurements never fall back to the CPU: a number taken there
    says nothing about the card.
    """
    info = device_summary(devices)
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"needs an NVIDIA GPU, but JAX found platform "
            f"{info['platform']!r} ({info['kind']})")
    return info


def nvidia_smi_lines() -> list[str]:
    """``name, power.limit`` per card, as ``nvidia-smi`` prints them (empty
    when nvidia-smi cannot be run).

    A card may be power-capped below its maximum and then runs slower, so
    every device number is reported beside these lines.
    """
    try:
        out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True,
                             text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def parse_nvidia_smi(line: str) -> tuple[str, float]:
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` -> (name, power limit in W)."""
    name, limit = line.rsplit(",", 1)
    return name.strip(), float(limit.split()[0])


def peak_bytes(device) -> int | None:
    """``peak_bytes_in_use`` of a device (None where it is not reported)."""
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def run_environment() -> dict:
    """What shapes a measurement besides the code: JAX, flags, cache."""
    from mcqueens.utils import cache

    return {"jax": jax.__version__,
            "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
            "compile_cache": cache.cache_dir()}
