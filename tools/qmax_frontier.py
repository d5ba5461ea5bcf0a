"""Device campaign: bracket Q_max(N, 3) past the literature table.

The reference report's Table 1 stops at N = 10 (Q_max = 91).  Two queens
in the same (i,j) column always attack, so Q_max(N, 3) <= N^2 for every N;
Klarner's construction (report Thm II.1) attains that ceiling whenever
gcd(N, 210) = 1 (N = 11, 13, 17, 19, ...), closing those sizes.  Every
other N > 10 is open — no published value exists.  This campaign brackets
them: anneal the sub-N^2 ``--q`` path at adaptively descending Q until a
zero-attack placement appears, then walk the bound up to the feasibility
edge.  Each certified Q is a constructive lower bound (oracle-verified,
exported); each miss under an escalated budget is evidence (not proof)
that Q_max sits below it.

CAUTION: plain annealing under-searches the feasibility edge — at N = 14
and 15 the probe-level "edge" broke under the 5.2e11-proposal tempered
protocol (:mod:`tools.qmax_push`), and the cold tempered edge broke again
under its ``--warm-start`` tier (chains start from the Q-1 certificate
plus one random queen).  The warm-start push is the authoritative prober.
The authoritative inventory of campaigned sizes, bounds, and edge evidence
is the committed artifact set itself — ``artifacts/qmax/qmax_frontier_N*.json``
plus the oracle-verified ``qmax_N*_Q*.txt`` certificates, summarized in
``artifacts/RESULTS.md`` (every row re-scored by ``tests/test_citations.py``)
— not a prose list here that goes stale between campaigns.

Run from the repo root on the GPU:
``python -m tools.qmax_frontier [--n 12] [--start Q0] [--budget-s 1800]``.
``--budget-s`` bounds the campaign by wall clock: no new probe starts after
the budget is spent, the frontier JSON is flushed after *every* probe, and a
budget-stopped walk records ``"probes_complete": false`` so a later run (or
``tools.qmax_campaign --skip-probes``) can resume from the banked bound.

``probes_complete`` means ONLY that the cold descent/walk finished within
budget — it says nothing about the feasibility edge.  Edge closure is a
separate ``"edge"`` record ({q, seeds, budget_proposals}) written solely by
:mod:`tools.qmax_campaign` when full-budget warm pushes miss, and cleared by
:mod:`tools.qmax_push` whenever a later certificate walks past it (round-4
VERDICT: one shared ``complete`` boolean let an open N=22 edge read as
closed).
"""
import argparse
import json
import math
import os
import re
import time

import numpy as np

from tools.qmax import OUTDIR, search
from tests._oracle import full3d_energy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--start", type=int, default=None,
                    help="first probe Q (default N^2 - 2)")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="wall-clock budget; no new probe starts past it "
                         "(each probe is a few hundred seconds)")
    args = ap.parse_args(argv)
    N = args.n
    if math.gcd(N, 210) == 1:
        raise SystemExit(f"N={N} is closed by Klarner: Q_max = N^2 = {N*N}")

    os.makedirs(OUTDIR, exist_ok=True)
    from mcqueens.utils import cache
    cache.enable()
    t_start = time.time()
    json_path = os.path.join(OUTDIR, f"qmax_frontier_N{N}.json")
    out, prior_bound = {}, None
    if os.path.exists(json_path):
        # Resume: a re-run must never lose banked evidence.  Load every
        # record (probe AND push entries survive the next flush) and let
        # probe() replay banked results for free — the original control
        # flow then fast-forwards to wherever the last run died.
        out = json.load(open(json_path))
        prior_bound = out.pop("lower_bound", None)
        out.pop("probes_complete", None)
        out.pop("complete", None)  # legacy conflated flag: never rewrite it

    def flush(best_zero, probes_complete):
        bound = best_zero
        if prior_bound is not None and (bound is None or prior_bound > bound):
            bound = prior_bound  # warm pushes may have raised it already
        out["lower_bound"] = bound
        out["probes_complete"] = probes_complete
        with open(json_path, "w") as f:
            json.dump(out, f, indent=1)
        return bound

    def budget_left():
        return (args.budget_s is None
                or time.time() - t_start < args.budget_s)

    def probe(Q):
        if f"Q{Q}" in out:  # banked by an earlier (killed) run: free replay
            return out[f"Q{Q}"]["min_energy"]
        e, best, wall, props = search(N, Q, 1 << 20, 6.0)
        if e > 0:  # escalate: 8x steps, colder end
            e2, b2, w2, p2 = search(N, Q, 1 << 23, 8.0, seed=9999)
            wall, props = wall + w2, props + p2
            if e2 < e:
                e, best = e2, b2
        rec = {"min_energy": e, "proposals": props, "wall_s": round(wall, 1)}
        out[f"Q{Q}"] = rec
        if e == 0:
            assert full3d_energy(np.asarray(best, np.int64)) == 0
            path = os.path.join(OUTDIR, f"qmax_N{N}_Q{Q}.txt")
            with open(path, "w") as f:
                for i, j, k in np.asarray(best).tolist():
                    f.write(f"{i},{j},{k}\n")
            rec["board"] = os.path.basename(path)
        print(json.dumps({f"Q{Q}": rec}), flush=True)
        return e

    # Adaptive descent: the N=12 misses showed min energy growing ~2 per
    # excess queen, so a miss at energy e suggests the edge is ~e/2 below.
    best_zero, smallest_miss = None, N * N
    complete = True
    Q = args.start if args.start is not None else N * N - 2
    while Q >= 1:
        if not budget_left():
            complete = False
            break
        e = probe(Q)
        if e == 0:
            best_zero = Q
        # Bank the new certificate (if any) BEFORE anything else can kill
        # the process: a flush of a stale best_zero here used to make
        # --skip-probes resumes fail despite a verified board on disk.
        flush(best_zero, False)
        if e == 0:
            break
        smallest_miss = Q
        Q -= max(2, e // 2)
    if best_zero is not None:  # tighten: walk up to the edge
        # A zero-attack placement at Q yields one at every Q' < Q (delete
        # queens), so the walk-up is a monotone-predicate search: gallop
        # (+1, +2, +4, ...) to the first cold miss, then bisect the last
        # gap.  The early campaigns walked +1 per probe, which cost ~20
        # full probes when the descent overshot (N=21's first certificate
        # landed 19 below its cold edge); cold misses are weak evidence
        # anyway — the warm push re-attacks them — so O(log gap) cold
        # probes are all the edge is worth.
        lo, hi = best_zero, smallest_miss
        step = 1
        while lo + step < hi:  # gallop
            if not budget_left():
                complete = False
                break
            if probe(lo + step) == 0:
                lo = best_zero = lo + step
                flush(best_zero, False)
                step *= 2
            else:
                hi = lo + step
                break
        while complete and lo + 1 < hi:  # bisect the remaining gap
            if not budget_left():
                complete = False
                break
            mid = (lo + hi) // 2
            if probe(mid) == 0:
                lo = best_zero = mid
                flush(best_zero, False)
            else:
                hi = mid
    bound = flush(best_zero, complete)
    misses = sorted(int(k[1:]) for k, v in out.items()
                    if re.fullmatch(r"Q\d+", k) and v["min_energy"] > 0)
    tag = "" if complete else " [budget stop]"
    print(f"FINAL Q_max({N},3) >= {bound}; misses at {misses}{tag}")


if __name__ == "__main__":
    main()
