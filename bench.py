#!/usr/bin/env python
"""Throughput benchmark: proposed moves/s per card on the board sampler.

Runs the served path (``dist.runner.run_chains``, ``tables`` kernel) at board
N=16, linear annealing beta 1 -> 5, tens of thousands of chains: one call
compiles and warms up, a second identical call is timed (``run_chains``
ends in ``block_until_ready``).  Set-up (first call minus the timed
sampling) is reported apart from the sampling rate.

Prints the card's ``nvidia-smi`` name and power limit, then exactly one
JSON line:

    {"metric": ..., "value": ..., "unit": "moves/s/card", "setup_s": ...,
     "device": {"platform": "gpu", "kind": ..., "count": ...}, ...}

There is no CPU fallback: without a GPU the benchmark exits non-zero.
"""

import argparse
import json
import sys
import time

import numpy as np

from mcqueens.chain.spec import ChainSpec
from mcqueens.core.schedules import build_schedule
from mcqueens.dist import runner
from mcqueens.utils import cache, profiling


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n", type=int, default=16)
    parser.add_argument("--chains", type=int, default=32768)
    parser.add_argument("--steps", type=int, default=4096,
                        help="proposals per chain in the timed run")
    parser.add_argument("--quick", action="store_true",
                        help="small shapes for smoke-testing the bench itself")
    args = parser.parse_args(argv)
    if args.quick:
        args.chains, args.steps = 1024, 512

    try:
        info = profiling.require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    cache.enable()
    spec = ChainSpec(
        N=args.n, n_steps=args.steps,
        schedule=build_schedule("linear_annealing", args.steps,
                                beta_start=1.0, beta_end=5.0),
        init_mode="random", mcmc_type="board", kernel="tables",
        history_stride=max(1, args.steps // 16),
    )
    seeds = np.arange(args.chains, dtype=np.uint32)
    t0 = time.time()
    runner.run_chains(seeds, spec)
    first = time.time() - t0
    res = runner.run_chains(seeds, spec)
    per_card = res.moves_per_sec / info["count"]
    smi = profiling.nvidia_smi_lines()
    for line in smi:
        print(f"nvidia-smi: {line}")
    print(json.dumps({
        "metric": (f"proposed moves/s per card (board N={args.n}, "
                   f"{args.chains} chains, tables kernel)"),
        "value": per_card,
        "unit": "moves/s/card",
        "setup_s": first - res.wall_time,
        "device": info,
        "cards": [dict(zip(("name", "power_limit_w"),
                           profiling.parse_nvidia_smi(line)))
                  for line in smi],
        **profiling.run_environment(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
