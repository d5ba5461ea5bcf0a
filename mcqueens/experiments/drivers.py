"""Experiment drivers: the four reference experiment types, batched on device.

Each driver reproduces the reference's sweep structure and *seed derivation
arithmetic exactly* (SURVEY §2.1) so config-driven sweeps are comparable
run-for-run, while execution is the fused batched sampler
(:mod:`mcqueens.dist.runner`) instead of a process pool:

  * ``single_N``        — one board size, one schedule or a schedule
                          comparison (``experiments.py:1220-1288``)
  * ``beta_start_end_pairs`` — sweep (beta_start, beta_end) pairs; per-pair
                          seed = base + 1000 * idx (``experiments.py:741-846``)
  * ``compare_beta_end`` — the pair sweep at two N, side-by-side plot; second
                          N seed = base + 10000 (``experiments.py:943-1029``;
                          the reference's plot call crashes on a TypeError —
                          fixed here, divergence documented in plotting.py)
  * ``measure_min_energy_vs_N`` — N x init-mode sweep; seed = base + 10 * idx
                          + (sum of ord(init_mode)) % 1000
                          (``experiments.py:1031-1201``)
"""

from __future__ import annotations

import numpy as np

from mcqueens.core import schedules as sched_mod
from mcqueens.dist import runner
from mcqueens.experiments import plotting
from mcqueens.experiments.config import Config


def _run(sampler, N, n_steps, init_mode, schedule, n_runs, base_seed,
         mcmc_type, early_stop_patience, verbose, mesh=None):
    """One batched experiment with the sampler-section knobs applied."""
    checkpointer = None
    if sampler.checkpoint_dir:
        from mcqueens.utils.checkpoint import Checkpointer

        # one checkpoint per sweep cell: resumable sweeps never collide
        tag = f"{mcmc_type}_N{N}_{init_mode}_{schedule.kind}_s{base_seed}"
        checkpointer = Checkpointer(sampler.checkpoint_dir, tag=tag)
    return runner.run_experiment(
        N=N,
        n_steps=n_steps,
        init_mode=init_mode,
        schedule=schedule,
        n_runs=n_runs,
        base_seed=base_seed,
        mcmc_type=mcmc_type,
        early_stop_patience=early_stop_patience,
        verbose=verbose,
        mesh=mesh,
        history_stride=sampler.history_stride,
        kernel=sampler.kernel,
        n_bins=sampler.n_bins,
        checkpointer=checkpointer,
    )


def run_single_n(cfg: Config, outdir: str = ".", mesh=None):
    """single_N: one board size; list-valued schedule type => comparison."""
    N = cfg.section("single_N")["N"]
    sched_cfg = cfg.sched_cfg
    sched_type = sched_cfg["type"]

    if isinstance(sched_type, list):
        schedules = sched_mod.schedules_from_types(sched_type, sched_cfg,
                                                   cfg.n_steps)
        histories, steps, lens, bests = {}, {}, {}, {}
        for schedule, base_seed in schedules:
            res = _run(cfg.sampler, N, cfg.n_steps, cfg.init_mode, schedule,
                       cfg.n_runs, base_seed, cfg.mcmc_type,
                       cfg.early_stop_patience, cfg.verbose, mesh)
            histories[schedule.label] = res.energy_history
            steps[schedule.label] = res.history_steps
            lens[schedule.label] = res.history_len
            bests[schedule.label] = res.best_energy
            if cfg.verbose:
                for e in res.best_energy:
                    print(e)
        title = f"Energy History (N={N}, {len(schedules)} schedules)"
        plotting.plot_energy_histories(histories, steps, title,
                                       out_path=cfg.output_path, outdir=outdir,
                                       lens_by_label=lens)
        return {"all_histories": histories, "all_best_energies": bests}

    schedule, base_seed = sched_mod.schedule_from_common(cfg.common, cfg.n_steps)
    res = _run(cfg.sampler, N, cfg.n_steps, cfg.init_mode, schedule, cfg.n_runs,
               base_seed, cfg.mcmc_type, cfg.early_stop_patience, cfg.verbose,
               mesh)
    if cfg.verbose:
        for e in res.best_energy:
            print(e)
    title = f"Energy History (N={N}, {schedule.desc})"
    plotting.plot_energy_histories(
        {"Schedule": res.energy_history}, {"Schedule": res.history_steps},
        title, out_path=cfg.output_path, outdir=outdir,
        lens_by_label={"Schedule": res.history_len},
    )
    return {
        "all_histories": {"Schedule": res.energy_history},
        "all_best_energies": {"Schedule": res.best_energy},
        "result": res,
    }


def run_beta_start_end_pairs(
    N, n_steps, beta_start_ends, annealing_type="linear_annealing",
    init_mode="random", n_runs=5, base_seed=0, verbose=True, plot=True,
    out_path=None, out_path_acceptance=None, mcmc_type="board",
    early_stop_patience=100000, sampler=None, outdir=".", mesh=None,
):
    """Sweep (beta_start, beta_end) pairs at a fixed annealing type."""
    from mcqueens.experiments.config import SamplerConfig

    sampler = sampler or SamplerConfig()
    histories, steps, lens, bests, bins = {}, {}, {}, {}, {}
    for idx, (beta_start, beta_end) in enumerate(beta_start_ends):
        schedule = sched_mod.build_schedule(
            annealing_type, n_steps, beta_start=beta_start, beta_end=beta_end
        )
        pair_seed = base_seed + idx * 1000  # experiments.py:791
        res = _run(sampler, N, n_steps, init_mode, schedule, n_runs, pair_seed,
                   mcmc_type, early_stop_patience, verbose, mesh)
        label = f"beta: {beta_start}->{beta_end}"
        histories[label] = res.energy_history
        steps[label] = res.history_steps
        lens[label] = res.history_len
        bests[label] = res.best_energy
        bins[label] = (res.accept_bins, res.total_bins)
        if verbose:
            for e in res.best_energy:
                print(e)
            print(np.mean(res.best_energy))

    if plot:
        title = (
            f"Energy History for Different beta Ranges "
            f"(N={N}, {annealing_type}, init_mode={init_mode})"
        )
        plotting.plot_energy_histories(histories, steps, title,
                                       out_path=out_path, outdir=outdir,
                                       lens_by_label=lens)
        if out_path_acceptance is not None:
            title_acc = (
                f"Acceptance Rate for Different beta Ranges "
                f"(N={N}, {annealing_type}, init_mode={init_mode})"
            )
            plotting.plot_acceptance_rates_binned(
                bins, n_steps, title=title_acc,
                out_path=out_path_acceptance, outdir=outdir,
            )
    return {
        "all_histories": histories,
        "all_history_steps": steps,
        "all_history_lens": lens,
        "all_best_energies": bests,
        "all_bins": bins,
    }


def run_compare_beta_end(
    Ns, n_steps, beta_start_ends, annealing_type="linear_annealing",
    init_mode="random", n_runs=5, base_seed=0, verbose=True, plot=True,
    out_path=None, mcmc_type="board", early_stop_patience=100000,
    sampler=None, outdir=".", mesh=None,
):
    """The pair sweep at two board sizes, plotted side by side."""
    if len(Ns) != 2:
        raise ValueError("Ns must contain exactly 2 values")
    n1, n2 = Ns
    common = dict(
        n_steps=n_steps, beta_start_ends=beta_start_ends,
        annealing_type=annealing_type, init_mode=init_mode, n_runs=n_runs,
        verbose=verbose, plot=False, mcmc_type=mcmc_type,
        early_stop_patience=early_stop_patience, sampler=sampler, outdir=outdir,
        mesh=mesh,
    )
    res1 = run_beta_start_end_pairs(N=n1, base_seed=base_seed, **common)
    res2 = run_beta_start_end_pairs(N=n2, base_seed=base_seed + 10000, **common)

    if plot:
        labels = list(res1["all_histories"].keys())
        title = "Energy History Comparison"
        plotting.plot_energy_histories_side_by_side(
            res1["all_histories"], res1["all_history_steps"],
            res2["all_histories"], res2["all_history_steps"],
            n1, n2, title=title, out_path=out_path, outdir=outdir,
            schedule_labels=labels,
            annealing_type=annealing_type, init_mode=init_mode,
            lens_n1=res1["all_history_lens"], lens_n2=res2["all_history_lens"],
        )
    return {"N1": n1, "N2": n2, "result_N1": res1, "result_N2": res2}


def measure_min_energy_vs_n(
    Ns, n_steps, schedule, init_modes=("random",), n_runs=5, base_seed=100,
    verbose=True, plot=True, out_path=None, mcmc_type="board",
    early_stop_patience=100000, sampler=None, outdir=".", mesh=None,
):
    """Sweep board sizes x init modes; collect best energies/steps-to-best."""
    from mcqueens.experiments.config import SamplerConfig

    sampler = sampler or SamplerConfig()
    if isinstance(init_modes, str):
        init_modes = [init_modes]

    results = {}
    for init_mode in init_modes:
        init_offset = sum(ord(c) for c in init_mode) % 1000
        mins_mean, mins_std, all_mins = [], [], []
        steps_mean, steps_std, all_steps = [], [], []
        for idx, N in enumerate(Ns):
            seed = base_seed + 10 * idx + init_offset  # experiments.py:1060-1067
            res = _run(sampler, N, n_steps, init_mode, schedule, n_runs, seed,
                       mcmc_type, early_stop_patience, verbose, mesh)
            all_mins.append(res.best_energy)
            mins_mean.append(res.best_energy.mean())
            mins_std.append(res.best_energy.std())
            all_steps.append(res.steps_to_best)
            steps_mean.append(res.steps_to_best.mean())
            steps_std.append(res.steps_to_best.std())
            if verbose:
                print(mins_mean[-1])
        results[init_mode] = {
            "mean_min_energies": np.asarray(mins_mean),
            "std_min_energies": np.asarray(mins_std),
            "all_min_energies": all_mins,
            "mean_steps_to_best": np.asarray(steps_mean),
            "std_steps_to_best": np.asarray(steps_std),
            "all_steps_to_best": all_steps,
        }

    if plot:
        plotting.plot_min_energy_vs_n(Ns, results, out_path=out_path,
                                      outdir=outdir)
    return {"Ns": Ns, "results": results}


def run_from_config(cfg: Config, outdir: str = ".", mesh=None):
    """Dispatch on experiment_type (reference ``__main__`` equivalent)."""
    et = cfg.experiment_type
    if et == "single_N":
        return run_single_n(cfg, outdir=outdir, mesh=mesh)

    if et == "measure_min_energy_vs_N":
        params = cfg.section("measure_min_energy_vs_N")
        schedule, base_seed = sched_mod.schedule_from_common(
            cfg.common, cfg.n_steps
        )
        init_modes = params.get("init_modes", [cfg.init_mode])
        result = measure_min_energy_vs_n(
            Ns=params["Ns"], n_steps=cfg.n_steps, schedule=schedule,
            init_modes=init_modes, n_runs=cfg.n_runs, base_seed=base_seed,
            verbose=cfg.verbose, plot=True, out_path=cfg.output_path,
            mcmc_type=cfg.mcmc_type,
            early_stop_patience=cfg.early_stop_patience, sampler=cfg.sampler,
            outdir=outdir, mesh=mesh,
        )
        if cfg.verbose:
            for init_mode in result["results"]:
                for m in result["results"][init_mode]["mean_min_energies"]:
                    print(m)
        return result

    if et == "beta_start_end_pairs":
        params = cfg.section("beta_start_end_pairs")
        base_seed = cfg.sched_cfg.get("base_seed", 0)
        result = run_beta_start_end_pairs(
            N=params["N"], n_steps=cfg.n_steps,
            beta_start_ends=params["beta_start_ends"],
            annealing_type=params.get("annealing_type", "linear_annealing"),
            init_mode=cfg.init_mode, n_runs=cfg.n_runs, base_seed=base_seed,
            verbose=cfg.verbose, plot=True,
            out_path=params.get("output_path", cfg.output_path),
            out_path_acceptance=params.get("output_path_acceptance"),
            mcmc_type=cfg.mcmc_type,
            early_stop_patience=cfg.early_stop_patience, sampler=cfg.sampler,
            outdir=outdir, mesh=mesh,
        )
        if cfg.verbose:
            for _, bests in result["all_best_energies"].items():
                print(np.mean(bests))
        return result

    if et == "compare_beta_end":
        params = cfg.section("compare_beta_end")
        base_seed = cfg.sched_cfg.get("base_seed", 0)
        result = run_compare_beta_end(
            Ns=params["Ns"], n_steps=cfg.n_steps,
            beta_start_ends=params["beta_start_ends"],
            annealing_type=params.get("annealing_type", "linear_annealing"),
            init_mode=cfg.init_mode, n_runs=cfg.n_runs, base_seed=base_seed,
            verbose=cfg.verbose, plot=True,
            out_path=params.get(
                "output_path", "figures/energy_history_compare_beta_end.png"
            ),
            mcmc_type=cfg.mcmc_type,
            early_stop_patience=cfg.early_stop_patience, sampler=cfg.sampler,
            outdir=outdir, mesh=mesh,
        )
        if cfg.verbose:
            for res in (result["result_N1"], result["result_N2"]):
                for _, bests in res["all_best_energies"].items():
                    print(np.mean(bests))
        return result

    raise ValueError(f"Unknown experiment_type: {et}")
