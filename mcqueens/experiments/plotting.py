"""Plot + CSV sinks with the reference's output contract.

Outputs (SURVEY §2 rows 10/13):
  * energy-history figure: mean +/- std band per label, log-y, with
    ``results/{label}.csv`` (step, mean_energy, std_energy);
  * binned acceptance-rate figure with
    ``results/acceptance_rates_{label}.csv`` (bin_center, acceptance_rate),
    NaN bins skipped in the plot;
  * two-N side-by-side energy comparison (this version accepts the
    annealing_type/init_mode kwargs whose absence crashes the reference's
    default experiment — ``experiments.py:1012-1022``, SURVEY §2.1);
  * min-energy-vs-N and steps-to-best-vs-N figures with per-init CSVs.

All sinks are rooted at an ``outdir`` (defaults to CWD like the reference).
Histories are (R, P) arrays plus a ``steps`` axis — with thinned histories the
step axis carries the true step values, so thinned and full curves overlay.

matplotlib and pandas are imported on first use (:func:`_plt`, :func:`_pd`),
so importing this module — and the drivers that import it — needs neither.
"""

from __future__ import annotations

import os

import numpy as np

from mcqueens.chain import stats

COLOR_CYCLE = [
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
]


def _plt():
    """matplotlib.pyplot on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _pd():
    import pandas as pd

    return pd


def _ensure_dir(path):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def _results_dir(outdir):
    d = os.path.join(outdir, "results")
    os.makedirs(d, exist_ok=True)
    return d


def _finish(fig_path, outdir):
    plt = _plt()
    if fig_path is not None:
        full = os.path.join(outdir, fig_path)
        _ensure_dir(full)
        plt.savefig(full, bbox_inches="tight", dpi=150)
        plt.close()
    else:
        plt.show()


def plot_energy_histories(histories_by_label, steps_by_label, title,
                          out_path=None, outdir=".", lens_by_label=None):
    """Mean +/- std energy curves per label (log-y) + per-label CSVs.

    Args:
        histories_by_label: {label: (R, P) array}.
        steps_by_label: {label: (P,) step axis}.
        lens_by_label: optional {label: (R,) truncated history lengths}
            (``ChainResult.history_len``); early-stopped runs then
            contribute only their truncated prefix (reference
            break-before-append semantics) instead of frozen tails, and the
            curve/CSV end at the longest surviving run.
    """
    plt = _plt()
    pd = _pd()
    plt.figure(figsize=(12, 7))
    for idx, (label, hist) in enumerate(histories_by_label.items()):
        lens = None if lens_by_label is None else lens_by_label.get(label)
        mean, std = stats.energy_curve_stats(hist, lens)
        steps = np.asarray(steps_by_label[label])[: len(mean)]
        color = COLOR_CYCLE[idx % len(COLOR_CYCLE)]
        pd.DataFrame(
            {"step": steps, "mean_energy": mean, "std_energy": std}
        ).to_csv(os.path.join(_results_dir(outdir), f"{label}.csv"), index=False)
        plt.plot(steps, mean, linewidth=2.5, label=label, color=color)
        plt.fill_between(steps, mean - std, mean + std, alpha=0.25, color=color)
    plt.xlabel("Step", fontsize=20)
    plt.ylabel("Energy", fontsize=20)
    plt.title(title, fontsize=18, fontweight="bold")
    plt.yscale("log")
    plt.grid(True, alpha=0.3, linestyle="--", linewidth=0.5)
    plt.legend(fontsize=12, framealpha=0.9, loc="best")
    plt.xlim(left=0)
    plt.tight_layout()
    _finish(out_path, outdir)


def plot_acceptance_rates_binned(bins_by_label, n_steps, title=None,
                                 out_path=None, outdir="."):
    """Pooled per-bin acceptance-rate curves per label + CSVs.

    Args:
        bins_by_label: {label: (accept_bins (R, B), total_bins (R, B))}.
    """
    plt = _plt()
    pd = _pd()
    plt.figure(figsize=(12, 7))
    for idx, (label, (acc, tot)) in enumerate(bins_by_label.items()):
        n_bins = np.asarray(acc).shape[1]
        rate = stats.acceptance_rate_bins(acc, tot)
        centers = stats.bin_centers(n_steps, n_bins)
        pd.DataFrame({"bin_center": centers, "acceptance_rate": rate}).to_csv(
            os.path.join(_results_dir(outdir), f"acceptance_rates_{label}.csv"),
            index=False,
        )
        valid = ~np.isnan(rate)
        plt.plot(
            centers[valid], rate[valid], linewidth=2.5, label=label,
            color=COLOR_CYCLE[idx % len(COLOR_CYCLE)],
        )
    plt.xlabel("Step", fontsize=20)
    plt.ylabel("Acceptance Rate", fontsize=20)
    if title:
        plt.title(title, fontsize=18, fontweight="bold")
    plt.grid(True, alpha=0.3, linestyle="--", linewidth=0.5)
    plt.legend(fontsize=12, framealpha=0.9, loc="best")
    plt.xlim(left=0)
    plt.tight_layout()
    _finish(out_path, outdir)


def plot_energy_histories_side_by_side(
    histories_n1, steps_n1, histories_n2, steps_n2, n1, n2, title,
    out_path=None, outdir=".", schedule_labels=None,
    annealing_type=None, init_mode=None, lens_n1=None, lens_n2=None,
):
    """Two-panel (N1 | N2) mean +/- std energy comparison.

    Unlike the reference signature (``experiments.py:848``), the
    annealing_type/init_mode kwargs are accepted (folded into the suptitle) —
    the reference's default ``compare_beta_end`` experiment crashes passing
    them (SURVEY §2.1).
    """
    plt = _plt()
    if schedule_labels is None:
        schedule_labels = list(histories_n1.keys())
    if annealing_type or init_mode:
        extras = ", ".join(
            str(x) for x in (annealing_type, init_mode) if x is not None
        )
        title = f"{title} ({extras})" if extras else title

    fig, axes = plt.subplots(1, 2, figsize=(12, 7))
    for ax, hists, steps_axis, lens_axis, n in (
        (axes[0], histories_n1, steps_n1, lens_n1, n1),
        (axes[1], histories_n2, steps_n2, lens_n2, n2),
    ):
        for idx, label in enumerate(schedule_labels):
            if label not in hists:
                continue
            lens = None if lens_axis is None else lens_axis.get(label)
            mean, std = stats.energy_curve_stats(hists[label], lens)
            steps = np.asarray(steps_axis[label])[: len(mean)]
            color = COLOR_CYCLE[idx % len(COLOR_CYCLE)]
            ax.plot(steps, mean, linewidth=2.5, label=label, color=color)
            ax.fill_between(
                steps, np.maximum(mean - std, 1e-10), mean + std,
                alpha=0.25, color=color,
            )
        ax.set_xlabel("Step", fontsize=20)
        ax.set_ylabel("Energy", fontsize=20)
        ax.set_title(f"N={n}", fontsize=18, fontweight="bold")
        ax.set_yscale("log")
        ax.grid(True, alpha=0.3, linestyle="--", linewidth=0.5)
        ax.legend(fontsize=12, framealpha=0.9, loc="best")
    fig.suptitle(title, fontsize=20, fontweight="bold", y=1.02)
    plt.tight_layout()
    if out_path is not None:
        full = os.path.join(outdir, out_path)
        _ensure_dir(full)
        fig.savefig(full, bbox_inches="tight", dpi=150)
        plt.close(fig)
    else:
        plt.show()


def plot_min_energy_vs_n(ns, results_by_init, out_path=None, outdir="."):
    """Min-energy-vs-N and steps-to-best-vs-N figures + per-init CSVs.

    Args:
        results_by_init: {init_mode: dict with mean/std arrays as produced by
            drivers.measure_min_energy_vs_N}.
    """
    plt = _plt()
    pd = _pd()
    ns_arr = np.asarray(ns)
    init_modes = list(results_by_init.keys())
    colors = plt.cm.tab10(np.linspace(0, 1, len(init_modes)))

    plt.figure(figsize=(10, 6))
    for idx, init_mode in enumerate(init_modes):
        r = results_by_init[init_mode]
        mean, std = r["mean_min_energies"], r["std_min_energies"]
        pd.DataFrame(
            {
                "N": ns_arr,
                init_mode + "_mean_min_energy": mean,
                init_mode + "_std_min_energy": std,
            }
        ).to_csv(
            os.path.join(_results_dir(outdir), f"min_energy_vs_N_{init_mode}.csv"),
            index=False,
        )
        plt.plot(ns_arr, mean, "o-", linewidth=2, markersize=6,
                 color=colors[idx], label=init_mode)
        plt.fill_between(ns_arr, mean - std, mean + std, alpha=0.2,
                         color=colors[idx])
    plt.xlabel("Board size N", fontsize=20)
    plt.ylabel("Minimal energy reached", fontsize=20)
    plt.title("MCMC: Minimal Energy vs. Board Size N", fontsize=18,
              fontweight="bold")
    plt.grid(True, alpha=0.3)
    plt.legend(fontsize=12)
    _finish(out_path, outdir)

    plt.figure(figsize=(10, 6))
    for idx, init_mode in enumerate(init_modes):
        r = results_by_init[init_mode]
        mean, std = r["mean_steps_to_best"], r["std_steps_to_best"]
        pd.DataFrame(
            {
                "N": ns_arr,
                init_mode + "_mean_steps_to_best": mean,
                init_mode + "_std_steps_to_best": std,
            }
        ).to_csv(
            os.path.join(_results_dir(outdir),
                         f"steps_to_best_vs_N_{init_mode}.csv"),
            index=False,
        )
        plt.plot(ns_arr, mean, "o-", linewidth=2, markersize=6,
                 color=colors[idx], label=init_mode)
        plt.fill_between(ns_arr, mean - std, mean + std, alpha=0.2,
                         color=colors[idx])
    plt.xlabel("Board size N", fontsize=20)
    plt.ylabel("Steps to best energy", fontsize=20)
    plt.title("MCMC: Steps to Best Energy vs. Board Size N", fontsize=18,
              fontweight="bold")
    plt.grid(True, alpha=0.3)
    plt.legend(fontsize=12)
    if out_path is not None:
        base, ext = os.path.splitext(out_path)
        conv = base + "_convergence" + (ext if ext else ".png")
        _finish(conv, outdir)
    else:
        plt.show()
