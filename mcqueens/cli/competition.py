"""Competition CLI: anneal hard, export the best board found.

Reference behavior (``competition.py:143-191``): N=15, 10 runs x 1e5 steps,
random init, linear beta 1.0->3.0, base seed 42; runs sorted by best energy;
the winner's heights written to ``competition_results/best_heights_{N}_{ts}.txt``
as ``i,j,k`` lines.  Here those are flag defaults, runs are one fused batch,
and --chains can oversample far beyond the reference's process count.

    python -m mcqueens.cli.competition [--n 15] [--n-runs 10]
        [--n-steps 100000] [--beta-start 1.0] [--beta-end 3.0] [--seed 42]
        [--kernel tables] [--outdir .]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n", type=int, default=15)
    parser.add_argument("--n-runs", type=int, default=10)
    parser.add_argument("--n-steps", type=int, default=100000)
    parser.add_argument("--init-mode", default="random")
    parser.add_argument("--mcmc-type", default="board",
                        choices=("board", "full_3d"),
                        help="board (reference competition default) or "
                             "full_3d; the i,j,k export format covers both "
                             "(a full_3d export lists the Q queens)")
    parser.add_argument("--q", type=int, default=None, metavar="Q",
                        help="full_3d only: queen count (default N^2).  "
                             "Sub-N^2 counts search for non-attacking "
                             "placements at the literature Q_max(N,3) "
                             "values (reference report Table 1); requires "
                             "--init-mode random")
    parser.add_argument("--beta-start", type=float, default=1.0)
    parser.add_argument("--beta-end", type=float, default=3.0)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--early-stop-patience", type=int, default=None)
    parser.add_argument("--kernel", default="tables",
                        help="tables (O(1) count-table delta-E, default) or "
                             "naive (the reference's O(N^2) rescan)")
    parser.add_argument("--history-stride", type=int, default=None,
                        help="default: full history for <=64 runs, thinned above")
    parser.add_argument("--n-bins", type=int, default=None,
                        help="acceptance-rate bins (reference granularity "
                             "100; default auto-shrinks so n_steps * n_bins "
                             "fits int32, letting >21M-step schedules run)")
    parser.add_argument("--tempering", type=int, default=0, metavar="L",
                        help="parallel tempering with an L-level geometric "
                             "beta ladder spanning [beta-start, beta-end] "
                             "(constant in time; replica exchange every "
                             "history-stride steps).  Chain c sits at "
                             "ladder level c %% L.")
    parser.add_argument("--mesh", action="store_true")
    parser.add_argument("--outdir", default=".")
    parser.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                        help="periodic checkpoint/resume: a killed search "
                             "restarts from its last completed segment "
                             "(bit-identical to an uninterrupted run); "
                             "works for both plain and --tempering searches")
    parser.add_argument("--exchange-interval", type=int, default=1,
                        metavar="SEGS",
                        help="tempering: replica-exchange sweeps every this "
                             "many history-stride segments (swap cadence "
                             "decoupled from history cadence)")
    parser.add_argument("--resume-from", default=None, metavar="BOARD_TXT",
                        help="warm-start every run from a previously exported "
                             "best_heights file (i,j,k lines)")
    args = parser.parse_args(argv)

    from mcqueens.chain.spec import (
        KERNELS, REMOVED_KERNELS, REMOVED_MESSAGE, ChainSpec)

    if args.kernel in REMOVED_KERNELS:
        parser.error(REMOVED_MESSAGE.format(args.kernel))
    if args.kernel not in KERNELS:
        parser.error(f"--kernel must be one of {KERNELS}, got {args.kernel!r}")
    if args.q is not None:
        if args.mcmc_type != "full_3d":
            parser.error("--q only applies to --mcmc-type full_3d "
                         "(board mode is always N^2 queens)")
        if not 1 <= args.q < args.n ** 3:
            parser.error(f"--q must be in [1, N^3) (N^3={args.n ** 3}; "
                         "a free cell must exist for the move proposal)")

    from mcqueens.core.schedules import build_schedule
    from mcqueens.dist import mesh as mesh_mod
    from mcqueens.dist import runner
    from mcqueens.utils import cache, profiling

    cache.enable()

    stride = args.history_stride
    if stride is None:
        stride = 1 if args.n_runs <= 64 else max(1, args.n_steps // 1024)
    # Bin indices are exact int32 on device (spec.py:94); keep the
    # reference's 100-bin granularity whenever it fits and shrink only on
    # >21M-step schedules instead of refusing to run them.
    n_bins = args.n_bins
    if n_bins is None:
        n_bins = max(1, min(100, (2 ** 31 - 1) // max(args.n_steps, 1)))

    checkpointer = None
    if args.checkpoint_dir:
        from mcqueens.utils.checkpoint import Checkpointer

        # The tag carries every run-shaping flag so two different searches
        # sharing a --checkpoint-dir never clobber (or silently ignore)
        # each other's file; the spec fingerprint inside the checkpoint
        # still guards against anything the tag misses.
        tag = (f"competition_{args.mcmc_type}_N{args.n}"
               + (f"_Q{args.q}" if args.q is not None else "")
               + f"_r{args.n_runs}"
               f"_st{args.n_steps}_b{args.beta_start:g}-{args.beta_end:g}"
               f"_s{args.seed}_{args.kernel}"
               + (f"_T{args.tempering}" if args.tempering else ""))
        # History I/O is incremental (each chunk file written once), so the
        # per-save cost is just the carry; a 30 s floor between writes keeps
        # huge-chain searches from spending their time serializing state
        # while bounding a kill's lost progress to ~30 s.
        checkpointer = Checkpointer(args.checkpoint_dir, tag=tag,
                                    min_interval_s=30.0)

    initial_states = None
    if args.resume_from:
        rows = []
        with open(args.resume_from) as f:
            for line in f:
                rows.append([int(x) for x in line.strip().split(",")])
        if args.mcmc_type == "board":
            board = np.zeros((args.n, args.n), np.int32)
            for i, j, k in rows:
                board[i, j] = k
            state = board
        else:
            state = np.asarray(rows, np.int32)  # (Q, 3) queens
        initial_states = np.repeat(state[None], args.n_runs, axis=0)

    if args.tempering:
        from mcqueens.search import tempering as tempering_mod

        spec = ChainSpec(
            N=args.n, n_steps=args.n_steps,
            schedule=build_schedule("constant", args.n_steps,
                                    beta_const=1.0),
            init_mode=args.init_mode, mcmc_type=args.mcmc_type,
            history_stride=stride, kernel=args.kernel, Q=args.q,
            n_bins=n_bins,
        )
        ladder = tempering_mod.geometric_ladder(
            args.beta_start, args.beta_end, args.tempering)
        out = tempering_mod.run_tempered(
            args.seed + np.arange(args.n_runs, dtype=np.uint32), spec,
            ladder, swap_seed=args.seed, initial_states=initial_states,
            verbose=True, exchange_interval=args.exchange_interval,
            mesh=mesh_mod.make_mesh() if args.mesh else None,
            checkpointer=checkpointer,
        )
        order = np.argsort(out["best_energy"], kind="stable")
        shown = [int(out["best_energy"][r]) for r in order[:20]]
        print(f"Best energies: {shown}{' ...' if args.n_runs > 20 else ''}")
        if args.n_runs > 20:
            print(f"(over {args.n_runs} runs: min "
                  f"{int(out['best_energy'].min())}, "
                  f"mean {out['best_energy'].mean():.1f})")
        best = out["best_state"][order[0]]
        print(best)
        print(f"{out['proposals']:.3e} proposals in {out['wall_time']:.1f}s "
              f"= {out['proposals'] / max(out['wall_time'], 1e-9):.3e} "
              f"moves/s")
        _export(args, best)
        return 0

    schedule = build_schedule(
        "linear_annealing", args.n_steps,
        beta_start=args.beta_start, beta_end=args.beta_end,
    )
    mesh = mesh_mod.make_mesh() if args.mesh else None
    if initial_states is not None:
        spec = ChainSpec(
            N=args.n, n_steps=args.n_steps, schedule=schedule,
            init_mode=args.init_mode, mcmc_type=args.mcmc_type,
            early_stop_patience=args.early_stop_patience,
            history_stride=stride, kernel=args.kernel, Q=args.q,
            n_bins=n_bins,
        )
        res = runner.run_chains(
            args.seed + np.arange(args.n_runs, dtype=np.uint32), spec,
            mesh=mesh, verbose=True, initial_states=initial_states,
            checkpointer=checkpointer,
        )
    else:
        res = runner.run_experiment(
            N=args.n, n_steps=args.n_steps, init_mode=args.init_mode,
            schedule=schedule, n_runs=args.n_runs, base_seed=args.seed,
            mcmc_type=args.mcmc_type,
            early_stop_patience=args.early_stop_patience,
            verbose=True, mesh=mesh, history_stride=stride, kernel=args.kernel,
            n_bins=n_bins, checkpointer=checkpointer, Q=args.q,
        )

    order = np.argsort(res.best_energy, kind="stable")
    shown = [int(res.best_energy[r]) for r in order[:20]]
    suffix = " ..." if args.n_runs > 20 else ""
    print(f"Best energies: {shown}{suffix}")
    if args.n_runs > 20:
        print(f"(over {args.n_runs} runs: min {int(res.best_energy.min())}, "
              f"mean {res.best_energy.mean():.1f})")
    best = res.best_state[order[0]]
    print(best)
    print(profiling.throughput_of(res))

    _export(args, best)
    return 0


def _export(args, best) -> None:
    """Write the winning state in the reference's i,j,k format
    (``competition.py:181-187``); a full_3d state lists its Q queens."""
    out_dir = os.path.join(args.outdir, "competition_results")
    os.makedirs(out_dir, exist_ok=True)
    ts = time.strftime("%Y%m%d_%H%M")
    path = os.path.join(out_dir, f"best_heights_{args.n}_{ts}.txt")
    with open(path, "w") as f:
        if best.ndim == 2 and best.shape[1] == 3 and args.mcmc_type == "full_3d":
            for i, j, k in best:
                f.write(f"{i},{j},{k}\n")
        else:
            for i in range(args.n):
                for j in range(args.n):
                    f.write(f"{i},{j},{best[i, j]}\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    raise SystemExit(main())
