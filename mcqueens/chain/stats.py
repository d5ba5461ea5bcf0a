"""On-device/host statistics matching the reference's reporting semantics.

The reference materializes per-step energy lists and accept/reject step-index
lists per run, then aggregates at plot time (``experiments.py:576-738``).  At
accelerator scale those lists are replaced by device-side accumulators; this module
turns them into the exact quantities the plots/CSVs need:

  * mean +/- std energy curves over runs (``plot_energy_histories``),
  * pooled per-bin acceptance rates with NaN for empty bins
    (``plot_acceptance_rates_binned``: rate = accepted / (accepted+rejected)
    pooled over all runs of a label),
  * best-energy / steps-to-best summaries (``measure_min_energy_vs_N``).
"""

from __future__ import annotations

import numpy as np


def energy_curve_stats(histories, lens=None):
    """(R, P) energy histories -> (mean, std) over runs.

    Population std (ddof=0), matching ``np.std`` in the reference
    (``experiments.py:594-595``).

    When ``lens`` (per-run truncated history lengths in points, from
    ``ChainResult.history_len``) is given, each run contributes only its own
    first ``lens[r]`` points — the reference's break-before-append patience
    semantics (``experiments.py:349-355``): a stopped run's history simply
    *ends*, it does not repeat its frozen value.  The returned curves are
    truncated at ``max(lens)`` (no run has data past it); the reference
    itself crashes on such ragged histories (``np.array`` of unequal-length
    lists at ``experiments.py:593``), so masked aggregation is the
    documented divergence, like the compare_beta_end TypeError fix.
    """
    h = np.asarray(histories, dtype=np.float64)
    if lens is None:
        return h.mean(axis=0), h.std(axis=0)
    lens = np.asarray(lens, dtype=np.int64)
    p_max = int(lens.max())
    h = h[:, :p_max]
    alive = np.arange(p_max)[None, :] < lens[:, None]  # (R, <=P)
    count = alive.sum(axis=0)  # >= 1 everywhere: the longest run spans p_max
    mean = np.where(alive, h, 0.0).sum(axis=0) / count
    var = np.where(alive, (h - mean) ** 2, 0.0).sum(axis=0) / count
    return mean, np.sqrt(var)


def acceptance_rate_bins(accept_bins, total_bins):
    """Pooled acceptance rate per bin over all runs; NaN where no proposals.

    accept_bins/total_bins: (R, n_bins) int arrays.
    """
    acc = np.asarray(accept_bins, dtype=np.int64).sum(axis=0)
    tot = np.asarray(total_bins, dtype=np.int64).sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        rate = np.where(tot > 0, acc / np.maximum(tot, 1), np.nan)
    return rate


def bin_centers(n_steps: int, n_bins: int = 100):
    """Bin centers identical to the reference (linspace edges midpoints)."""
    edges = np.linspace(0, n_steps, n_bins + 1)
    return (edges[:-1] + edges[1:]) / 2


def summarize_best(best_energies, steps_to_best):
    """Mean/std of best energies and steps-to-best across runs."""
    be = np.asarray(best_energies, dtype=np.float64)
    sb = np.asarray(steps_to_best, dtype=np.float64)
    return {
        "mean_min_energy": be.mean(),
        "std_min_energy": be.std(),
        "mean_steps_to_best": sb.mean(),
        "std_steps_to_best": sb.std(),
    }
