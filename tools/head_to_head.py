#!/usr/bin/env python
"""Head-to-head: run the upstream reference and mcqueens on the same config.

The automated (small-budget) version of this protocol runs in
``tests/test_parity.py``; this script is the manual, full-budget variant used
for the numbers in ``artifacts/RESULTS.md`` (e.g. N=12, 5M steps: reference
best 26 at 6.2e3 moves/s/core vs mcqueens best 25-26 at >1e8 moves/s/chip).

    python tools/head_to_head.py --n 12 --n-steps 5000000 --ref-seeds 2 \
        --our-runs 64 [--reference /root/reference]

The reference runs as a black-box subprocess; none of its code enters this
repo.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import textwrap
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run_reference(ref_path, n, n_steps, beta_start, beta_end, init, seeds):
    script = textwrap.dedent(
        f"""
        import json, sys, time
        sys.path.insert(0, {ref_path!r})
        from experiments import metropolis_mcmc_board, build_schedule_from_params
        out = []
        for seed in {list(seeds)!r}:
            sched = build_schedule_from_params(
                "linear_annealing", {n_steps},
                beta_start={beta_start}, beta_end={beta_end})
            t0 = time.time()
            res = metropolis_mcmc_board(
                N={n}, n_steps={n_steps}, init_mode={init!r},
                beta_schedule=sched, verbose=False, seed=seed)
            out.append({{"best": int(res["best_energy"]),
                         "seconds": time.time() - t0}})
        print(json.dumps(out))
        """
    )
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-2000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=12)
    p.add_argument("--n-steps", type=int, default=5_000_000)
    p.add_argument("--beta-start", type=float, default=1.0)
    p.add_argument("--beta-end", type=float, default=3.0)
    p.add_argument("--init-mode", default="random")
    p.add_argument("--ref-seeds", type=int, default=2)
    p.add_argument("--our-runs", type=int, default=64)
    p.add_argument("--reference", default="/root/reference")
    p.add_argument("--skip-reference", action="store_true")
    args = p.parse_args()

    import numpy as np

    from mcqueens.chain.spec import ChainSpec
    from mcqueens.core.schedules import build_schedule
    from mcqueens.dist import runner
    from mcqueens.utils import cache

    cache.enable()
    spec = ChainSpec(
        N=args.n, n_steps=args.n_steps,
        schedule=build_schedule("linear_annealing", args.n_steps,
                                beta_start=args.beta_start,
                                beta_end=args.beta_end),
        init_mode=args.init_mode, mcmc_type="board", kernel="tables",
        history_stride=max(1, args.n_steps // 256),
    )
    t0 = time.time()
    res = runner.run_chains(
        100 + np.arange(args.our_runs, dtype=np.uint32), spec
    )
    ours = {
        "best_min": int(res.best_energy.min()),
        "best_mean": float(res.best_energy.mean()),
        "seconds": time.time() - t0,
        "moves_per_sec": res.moves_per_sec,
    }
    print("mcqueens:", json.dumps(ours))

    if not args.skip_reference:
        ref = run_reference(args.reference, args.n, args.n_steps,
                            args.beta_start, args.beta_end, args.init_mode,
                            range(100, 100 + args.ref_seeds))
        bests = [r["best"] for r in ref]
        secs = [r["seconds"] for r in ref]
        print("reference:", json.dumps({
            "bests": bests,
            "seconds_per_chain": secs,
            "moves_per_sec": args.n_steps / (sum(secs) / len(secs)),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
