"""Device campaign: walk a Q_max(N, 3) lower bound up with tempered pushes.

The adaptive annealing probes in :mod:`tools.qmax_frontier` under-search
near the feasibility edge: at N = 14 the plain 3.9e10-proposal probe left
Q = 171 at 1 attack, but a 5.2e11-proposal 16-level tempering push (the
floor-search protocol: 65536 chains x 8M steps, beta ladder 0.8->9,
exchange every 62.5k steps) finds a zero-attack certificate — and likewise
Q = 161 at N = 15.  So the edge must be walked up under the tempered
protocol itself: this tool pushes Q upward from the current bound until a
push misses, archiving each certificate (oracle-verified) and recording
the outcome in ``artifacts/qmax/qmax_frontier_N{N}.json``.

Run from the repo root on the GPU:
``python -m tools.qmax_push --n 14 --start 172``.

``--warm-start`` escalates further: every chain starts from the archived
Q-1 certificate plus one extra queen dropped on a per-chain random empty
cell — the search then only has to relax a 1-attack near-miss instead of
assembling the whole placement, while the hot end of the ladder (beta 0.8)
still scrambles far from the start.  Recorded as protocol
``tempered_push_warm`` so the evidence tiers stay distinguishable.
"""
import argparse
import json
import os
import time

import numpy as np

from mcqueens.chain.spec import ChainSpec
from mcqueens.core.schedules import build_schedule
from mcqueens.search import tempering as tempering_mod
from mcqueens.utils import cache
from mcqueens.utils.checkpoint import Checkpointer
from tools.qmax import OUTDIR
from tests._oracle import full3d_energy

CHAINS = 65536
N_STEPS = 8_000_000
STRIDE = 62_500
LADDER_L = 16
BETAS = (0.8, 9.0)


def load_certificate(N, Q):
    """Archived zero-attack placement ``qmax_N{N}_Q{Q}.txt`` -> (Q, 3)."""
    path = os.path.join(OUTDIR, f"qmax_N{N}_Q{Q}.txt")
    rows = [tuple(map(int, line.split(","))) for line in open(path)]
    arr = np.asarray(rows, np.int32)
    assert arr.shape == (Q, 3) and full3d_energy(arr.astype(np.int64)) == 0
    return arr


def warm_states(N, Q, chains, seed):
    """(chains, Q, 3) starts: the Q-1 certificate + one random empty cell."""
    base = load_certificate(N, Q - 1)
    occ = set(map(tuple, base.tolist()))
    empty = np.asarray(
        [c for c in np.ndindex(N, N, N) if c not in occ], np.int32)
    rng = np.random.default_rng(seed)
    extra = empty[rng.integers(0, len(empty), size=chains)]
    states = np.repeat(base[None], chains, axis=0)
    return np.concatenate([states, extra[:, None, :]], axis=1)


def push(N, Q, seed=31337, warm=False, checkpoint_dir=None):
    spec = ChainSpec(
        N=N, n_steps=N_STEPS,
        schedule=build_schedule("constant", N_STEPS, beta_const=1.0),
        init_mode="random", mcmc_type="full_3d", kernel="tables",
        history_stride=STRIDE, Q=Q,
    )
    ladder = tempering_mod.geometric_ladder(*BETAS, LADDER_L)
    init = warm_states(N, Q, CHAINS, seed) if warm else None
    ckpt = None
    if checkpoint_dir is not None:
        # With a checkpointer a killed push relaunches losing at most
        # min_interval_s of search.  The 65536-chain carry is several GB
        # (about 5 GB at N=22), and each save pulls it to the host and
        # writes it, so cap the cadence at 5 min.
        tag = f"push_N{N}_Q{Q}_s{seed}" + ("_warm" if warm else "")
        ckpt = Checkpointer(checkpoint_dir, tag=tag, min_interval_s=300.0)
    t0 = time.time()
    out = tempering_mod.run_tempered(
        seed + np.arange(CHAINS, dtype=np.uint32), spec, ladder,
        swap_seed=seed, verbose=True, initial_states=init,
        stop_at_energy=0, checkpointer=ckpt,
    )
    if ckpt is not None:
        ckpt.clear()  # done: a stale carry must not shadow the next campaign
    r = int(np.argmin(out["best_energy"]))
    e = int(out["best_energy"][r])
    best = np.asarray(out["best_state"][r], np.int64)
    assert e == full3d_energy(best), (N, Q, e)
    return e, best, time.time() - t0, out["proposals"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--start", type=int, required=True)
    ap.add_argument("--seed", type=int, default=31337)
    ap.add_argument("--warm-start", action="store_true",
                    help="start every chain from the archived Q-1 "
                         "certificate plus one random extra queen")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="persist the tempering carry here (~5 min cadence) "
                         "so a killed/hung push resumes mid-search instead "
                         "of restarting the 5.2e11-proposal budget")
    args = ap.parse_args(argv)
    N = args.n
    cache.enable()

    protocol = "tempered_push_warm" if args.warm_start else "tempered_push"
    path = os.path.join(OUTDIR, f"qmax_frontier_N{N}.json")
    out = json.load(open(path)) if os.path.exists(path) else {}
    Q = args.start
    while Q < N * N:
        e, best, wall, proposals = push(N, Q, args.seed, warm=args.warm_start,
                                        checkpoint_dir=args.checkpoint_dir)
        rec = {"min_energy": e, "proposals": proposals,
               "wall_s": round(wall, 1), "protocol": protocol,
               "seed": args.seed}
        key = f"Q{Q}_push_warm" if args.warm_start else f"Q{Q}_push"
        if key in out and (out[key].get("seed", 31337) != args.seed
                           or out[key].get("protocol") != protocol):
            key = f"{key}_s{args.seed}"  # keep multi-seed evidence
        out[key] = rec
        if e == 0:
            bpath = os.path.join(OUTDIR, f"qmax_N{N}_Q{Q}.txt")
            with open(bpath, "w") as f:
                for i, j, k in best.tolist():
                    f.write(f"{i},{j},{k}\n")
            rec["board"] = os.path.basename(bpath)
            out["lower_bound"] = max(out.get("lower_bound") or 0, Q)
            # A certificate at (or past) a recorded edge refutes that edge:
            # downgrade the closure so the size reads OPEN again until a
            # fresh campaign re-closes it (the legacy `complete` boolean is
            # retired for the same reason — it survived walks past it).
            edge = out.get("edge")
            if edge is not None and Q >= edge["q"]:
                out.setdefault("edge_history", []).append(
                    dict(edge, broken_by=f"Q{Q} certificate, seed "
                                         f"{args.seed}"))
                del out["edge"]
            out.pop("complete", None)
        print(json.dumps({f"Q{Q}_push": rec}), flush=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        if e > 0:
            break
        Q += 1
    print(f"FINAL Q_max({N},3) >= {out.get('lower_bound')}")


if __name__ == "__main__":
    main()
