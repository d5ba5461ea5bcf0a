"""Device campaign: certify the literature Q_max(N,3) values on the accelerator.

The reference report's Table 1 (p.1, via Kunt) lists the best known maximum
number of mutually non-attacking queens in the N-cube for N = 3..10:
4, 7, 13, 21, 32, 48, 67, 91.  The reference never searches below Q = N^2;
with the sub-N^2 ``--q`` path and the full_3d sampler we can
re-derive those bounds ourselves:

  * at Q = Q_max the annealer must FIND a zero-energy placement
    (constructive certificate, oracle-verified, exported to
    ``artifacts/qmax/``);
  * at Q = Q_max + 1 the same budget should plateau above zero
    (consistency evidence — not a proof of impossibility).

Run from the repo root on the GPU: ``python -m tools.qmax``.
Escalates the step budget once for any Q_max instance that misses zero.
Evidence artifact: ``artifacts/qmax/qmax_certification.json``.
"""
import json
import os
import time

import numpy as np

from mcqueens.chain.spec import ChainSpec
from mcqueens.core.schedules import build_schedule
from mcqueens.dist import runner
from mcqueens.utils import cache
from tests._oracle import full3d_energy

# report Table 1: best known Q_max(N, 3), N = 3..10
QMAX = {3: 4, 4: 7, 5: 13, 6: 21, 7: 32, 8: 48, 9: 67, 10: 91}

CHAINS = 4096
OUTDIR = os.path.join("artifacts", "qmax")


def search(N, Q, n_steps, beta_end, seed=0):
    spec = ChainSpec(
        N=N, n_steps=n_steps,
        schedule=build_schedule("linear_annealing", n_steps,
                                beta_start=0.5, beta_end=beta_end),
        init_mode="random", mcmc_type="full_3d", kernel="tables",
        history_stride=max(1, n_steps // 64), Q=Q,
    )
    seeds = np.arange(seed, seed + CHAINS, dtype=np.uint32)
    t0 = time.time()
    res = runner.run_chains(seeds, spec)
    wall = time.time() - t0
    r = int(np.argmin(res.best_energy))
    best = np.asarray(res.best_state[r], np.int64)
    e = int(res.best_energy[r])
    assert e == full3d_energy(best), (N, Q, e)  # oracle on the device result
    return e, best, wall, CHAINS * n_steps


def main():
    os.makedirs(OUTDIR, exist_ok=True)
    cache.enable()
    out = {}
    for N, qmax in QMAX.items():
        for Q in (qmax, qmax + 1):
            n_steps, beta_end = 1 << 18, 5.0
            e, best, wall, props = search(N, Q, n_steps, beta_end)
            if Q == qmax and e > 0:  # escalate once: 16x steps, colder end
                n_steps, beta_end = 1 << 22, 7.0
                e2, best2, wall2, props2 = search(N, Q, n_steps, beta_end,
                                                 seed=CHAINS)
                wall, props = wall + wall2, props + props2
                if e2 < e:
                    e, best = e2, best2
            rec = {"min_energy": e, "proposals": props,
                   "wall_s": round(wall, 1),
                   "certified": bool(Q == qmax and e == 0)}
            out[f"N{N}_Q{Q}"] = rec
            if Q == qmax and e == 0:
                path = os.path.join(OUTDIR, f"qmax_N{N}_Q{Q}.txt")
                with open(path, "w") as f:
                    for i, j, k in best.tolist():
                        f.write(f"{i},{j},{k}\n")
                rec["board"] = os.path.basename(path)
            print(json.dumps({f"N{N}_Q{Q}": rec}), flush=True)
    with open(os.path.join(OUTDIR, "qmax_certification.json"), "w") as f:
        json.dump(out, f, indent=1)
    n_cert = sum(r.get("certified", False) for r in out.values())
    print(f"FINAL certified {n_cert}/{len(QMAX)} Q_max values; "
          f"artifact {OUTDIR}/qmax_certification.json")


if __name__ == "__main__":
    main()
