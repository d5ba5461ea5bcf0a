"""Static chain configuration.

A :class:`ChainSpec` is hashable and frozen so the whole sampler — proposal,
delta-E kernel, schedule, early stopping, stats layout — specializes at trace
time with zero dynamic control flow inside the compiled step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from mcqueens.core.schedules import Schedule

KERNELS = ("tables", "naive")
# Kernel names of earlier releases.  They selected fused kernels for Google's
# tensor processing units (Mosaic compiler) and were removed together with
# that target; naming one fails with this message instead of "unknown".
REMOVED_KERNELS = ("pallas", "pallas_shared")
REMOVED_MESSAGE = (
    "kernel {!r} was removed: the 'pallas' and 'pallas_shared' kernels (and "
    "the allow_correlated_runs option) compiled only for tensor processing "
    "units through the Mosaic compiler.  Use kernel 'tables' (the default) "
    "or 'naive'."
)
MCMC_TYPES = ("board", "full_3d")


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Everything static about a batch of Metropolis chains.

    Attributes:
        N: board size.
        n_steps: proposals per chain.
        schedule: beta schedule (static, evaluated on device from the step
            counter).
        init_mode: "random" | "latin" | "klarner".
        mcmc_type: "board" (one queen per (i, j) column, state = heights) or
            "full_3d" (Q queens at arbitrary distinct cells).
        Q: queen count for full_3d (default N^2; board mode is always N^2).
        early_stop_patience: freeze a chain after this many steps without a
            new best energy (board-mode reference semantics,
            ``experiments.py:340-353``); None disables.  The reference's
            full_3d sampler silently ignores this parameter
            (``experiments.py:199`` accepts it but never reads it) — here it
            works for both variants and the experiment runner reproduces the
            reference default by not setting it for full_3d.
        history_stride: record the energy every this many steps (1 = the
            reference's full per-step history).  At pod scale a 5M-step,
            4096-chain float history cannot be materialized; striding keeps
            it on device at a fixed size (SURVEY §5.5).
        n_bins: acceptance-rate bins (the reference's plotting granularity,
            ``experiments.py:643-738``); counters accumulate on device
            instead of materializing per-step accept/reject index lists.
        kernel: "tables" (O(1) incremental delta-E from line-family count
            tables, the default) or "naive" (O(N^2) one-vs-all rescan, the
            reference algorithm vectorized — the plain reference the fast
            path is checked against; both draw the same threefry streams,
            so their trajectories are bitwise equal).
    """

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
        if self.kernel in REMOVED_KERNELS:
            raise ValueError(REMOVED_MESSAGE.format(self.kernel))
        if self.kernel not in KERNELS:
            raise ValueError(f"Unknown kernel: {self.kernel}")
        if self.mcmc_type not in MCMC_TYPES:
            raise ValueError(f"Unknown mcmc_type: {self.mcmc_type}")
        if (self.mcmc_type == "full_3d"
                and self.Q is not None and self.Q >= self.N ** 3):
            # Rejection sampling of an unoccupied cell requires a free cell;
            # any occupancy below 1 is accepted.
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
