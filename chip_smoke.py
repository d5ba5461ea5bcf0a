#!/usr/bin/env python
"""On-card smoke test: the main paths of mcqueens on an NVIDIA GPU, checked.

    python chip_smoke.py           # phases 0-4 on one card
    python chip_smoke.py --four    # the 4-card mesh paths against one card

Phases (one card):
  0. platform — refuse anything but a GPU; print the device, the card's
     name and power limit (nvidia-smi), JAX version, XLA_FLAGS and cache.
  1. competition — ``cli.competition.main`` with the reference defaults
     (N=15, 10 runs x 1e5 steps, linear beta 1->3, seed 42); the exported
     board, re-scored by the independent oracle, must equal the best
     energy the CLI printed.
  2. board throughput — ``runner.run_chains`` at board N=16, 32,768 chains,
     linear beta 1->5; incremental energies equal the oracle on a sample;
     set-up (compile + init) and moves/s reported apart.
  3. Q_max push — ``run_tempered`` at full_3d N=22, Q=332, warm-started
     from the committed Q=331 certificate, 65,536 chains, 16-level ladder
     0.8->9; the only cut is the step budget (printed).
  4. fast path vs plain reference — ``tables`` against ``naive`` on the card:
     trajectories bitwise equal, final energies exactly equal.

``--four`` runs only the mesh paths (board N=20 x 4096 runs, and a tempered
full_3d search) over a 1-D mesh of four cards, each against the same seeds on
one card: results must be bitwise identical.

Everything runs in this one process (a JAX process reserves most of a card's
memory when it starts, so a second one would fail).  Any failed check makes
the exit code non-zero and suppresses the result line; without a GPU, or
outside a checkout of this repository, the script exits non-zero at once.
The last line of a good run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import re
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


class CheckFailed(AssertionError):
    """A smoke check did not hold."""


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def import_repo() -> None:
    """Import this checkout's package; refuse to run outside a checkout."""
    try:
        import mcqueens
    except ImportError as e:
        raise SystemExit(f"chip_smoke: mcqueens is not importable ({e}); "
                         f"run from the root of a checkout") from None
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
        mcqueens.__file__)))
    if pkg_root != HERE:
        raise SystemExit(f"chip_smoke: mcqueens imported from {pkg_root}, "
                         f"not from this checkout ({HERE})")


def final_line(info: dict) -> str:
    """The result line: exactly the keys the contract names."""
    return json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}})


def run_phases(phases, log=print) -> list[str]:
    """Run every phase, even after a failure; return the failed names."""
    failed = []
    for name, fn in phases:
        log(f"== phase {name}")
        t0 = time.time()
        try:
            fn()
        except Exception as e:  # a failed phase must not hide the others
            failed.append(name)
            traceback.print_exc(file=sys.stdout)
            log(f"FAIL {name}: {type(e).__name__}: {e}")
        else:
            log(f"PASS {name} ({time.time() - t0:.1f} s)")
    return failed


def _sample(n: int, k: int) -> np.ndarray:
    return np.unique(np.linspace(0, n - 1, min(n, k)).astype(np.int64))


def check_against_oracle(energies, states, mcmc_type: str, idx, label: str):
    """Incremental energies must equal the independent oracle exactly."""
    from tests import _oracle

    fn = (_oracle.board_energy if mcmc_type == "board"
          else _oracle.full3d_energy)
    for r in idx:
        want = fn(np.asarray(states[r], np.int64))
        check(int(energies[r]) == want,
              f"{label}: chain {r} carries energy {int(energies[r])}, "
              f"oracle says {want}")
    print(f"  {label}: {len(idx)} sampled chains equal the oracle")


def _peak(devices=None) -> str:
    import jax

    from mcqueens.utils import profiling

    devices = jax.devices() if devices is None else devices
    return ", ".join(f"{d.id}:{profiling.peak_bytes(d)}" for d in devices)


def _rate(proposals: int, seconds: float) -> float:
    return proposals / max(seconds, 1e-9)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_platform(info: dict) -> None:
    from mcqueens.utils import profiling

    print(f"  device_kind: {info['kind']}  count: {info['count']}")
    for line in profiling.nvidia_smi_lines() or ["not available"]:
        print(f"  nvidia-smi: {line}")
    env = profiling.run_environment()
    print(f"  jax: {env['jax']}")
    print(f"  XLA_FLAGS: {env['XLA_FLAGS'] or '(unset)'}")
    print(f"  compile cache: {env['compile_cache']}")


def phase_competition(extra_args=()) -> None:
    """The reference competition through its CLI, with its defaults."""
    from mcqueens.cli import competition
    from tests import _oracle

    with tempfile.TemporaryDirectory() as out:
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            rc = competition.main(["--outdir", out, *extra_args])
        wall = time.time() - t0
        text = buf.getvalue()
        print("  | " + text.rstrip().replace("\n", "\n  | "))
        check(rc == 0, f"competition exited {rc}")
        m = re.search(r"Best energies: \[(\d+)", text)
        check(m is not None, "competition printed no best energies")
        printed = int(m.group(1))
        paths = glob.glob(os.path.join(out, "competition_results",
                                       "best_heights_15_*.txt"))
        check(len(paths) == 1, f"expected one exported board, got {paths}")
        board = np.zeros((15, 15), np.int64)
        with open(paths[0]) as f:
            for line in f:
                i, j, k = map(int, line.split(","))
                board[i, j] = k
    e = _oracle.board_energy(board)
    check(e == printed,
          f"exported board scores {e} by the oracle, CLI printed {printed}")
    print(f"  exported board: oracle energy {e} == printed best {printed}; "
          f"CLI wall {wall:.2f} s (compile included)")


def _board_spec(N, n_steps, stride):
    """Board chains, random init, linear beta 1 -> 5, ``tables`` kernel."""
    from mcqueens.chain.spec import ChainSpec
    from mcqueens.core.schedules import build_schedule

    return ChainSpec(
        N=N, n_steps=n_steps,
        schedule=build_schedule("linear_annealing", n_steps,
                                beta_start=1.0, beta_end=5.0),
        init_mode="random", mcmc_type="board", kernel="tables",
        history_stride=stride,
    )


def phase_board_throughput(chains=32768, n_steps=4096, stride=256,
                           sample=256) -> None:
    """Board N=16 at throughput scale, on the served path."""
    from mcqueens.core import tables
    from mcqueens.dist import runner

    N = 16
    spec = _board_spec(N, n_steps, stride)
    seeds = np.arange(chains, dtype=np.uint32)
    carry_mb = tables.table_size(N) * 4 * chains / 2 ** 20
    print(f"  board N={N}, {chains} chains x {n_steps} steps, linear beta "
          f"1->5, stride {stride}; table carry {carry_mb:.0f} MiB")
    t0 = time.time()
    first = runner.run_chains(seeds, spec)
    t_first = time.time() - t0
    res = runner.run_chains(seeds, spec)
    for field in ("energy_history", "final_state", "best_state"):
        check(np.array_equal(getattr(first, field), getattr(res, field)),
              f"two runs with the same seeds differ in {field}")
    check(res.proposals == chains * n_steps,
          f"{res.proposals} proposals counted, expected {chains * n_steps}")
    setup = t_first - res.wall_time
    print(f"  set-up (compile + init, first call): {setup:.3f} s; "
          f"init alone (warm): {res.setup_time:.3f} s")
    print(f"  sampling: {res.proposals} proposals in {res.wall_time:.4f} s "
          f"= {_rate(res.proposals, res.wall_time):.6e} moves/s")
    print(f"  peak_bytes_in_use: {_peak()}")
    idx = _sample(chains, sample)
    check_against_oracle(res.final_energy, res.final_state, "board", idx,
                         "final_energy")
    check_against_oracle(res.best_energy, res.best_state, "board", idx,
                         "best_energy")


def _push_setup(chains, stride, rounds, seed=31337):
    """The tools.qmax_push deployment with its step budget cut."""
    from mcqueens.chain.spec import ChainSpec
    from mcqueens.core.schedules import build_schedule
    from mcqueens.search import tempering
    from tools import qmax_push

    N, Q = 22, 332
    n_steps = stride * rounds
    spec = ChainSpec(
        N=N, n_steps=n_steps,
        schedule=build_schedule("constant", n_steps, beta_const=1.0),
        init_mode="random", mcmc_type="full_3d", kernel="tables",
        history_stride=stride, Q=Q,
    )
    ladder = tempering.geometric_ladder(*qmax_push.BETAS, qmax_push.LADDER_L)
    init = qmax_push.warm_states(N, Q, chains, seed)
    seeds = seed + np.arange(chains, dtype=np.uint32)
    print(f"  full_3d N={N} Q={Q}, {chains} chains warm-started from "
          f"qmax_N{N}_Q{Q - 1}.txt, {len(ladder)}-level ladder "
          f"{qmax_push.BETAS[0]}->{qmax_push.BETAS[1]}")
    print(f"  cut: stride {qmax_push.STRIDE} -> {stride} steps, "
          f"{qmax_push.N_STEPS} -> {n_steps} steps ({rounds} rounds, "
          f"{rounds - 1} exchanges); chains, ladder and shapes as deployed")
    return spec, ladder, init, seeds, seed


def _check_ladder(betas, ladder) -> None:
    L = len(ladder)
    groups = np.asarray(betas).reshape(-1, L)
    want = np.sort(ladder)
    for g, row in enumerate(groups):
        check(np.array_equal(np.sort(row), want),
              f"group {g} holds betas {np.sort(row)}, not the ladder")
    print(f"  beta multiset == ladder in all {len(groups)} groups")


def phase_qmax_push(chains=65536, stride=250, rounds=4, sample=48) -> None:
    """The tempered Q_max push deployment, warm-started."""
    from mcqueens.core import tables
    from mcqueens.search import tempering

    spec, ladder, init, seeds, seed = _push_setup(chains, stride, rounds)
    per_chain = (tables.table_size(spec.N, full3d=True) * 4
                 + spec.N ** 3 + 2 * spec.q_eff * 3 * 4)
    print(f"  carry ~{per_chain / 1024:.1f} KiB/chain "
          f"(~{per_chain * chains / 2 ** 30:.2f} GiB)")
    kw = dict(swap_seed=seed, initial_states=init)
    t0 = time.time()
    first = tempering.run_tempered(seeds, spec, ladder, **kw)
    t_first = time.time() - t0
    out = tempering.run_tempered(seeds, spec, ladder, **kw)
    for key in ("energy_history", "betas", "final_state", "best_state"):
        check(np.array_equal(first[key], out[key]),
              f"two runs with the same seeds differ in {key}")
    setup = t_first - out["wall_time"]
    print(f"  set-up (compile + init + warm-start upload, first call): "
          f"{setup:.3f} s; init alone (warm): {out['setup_time']:.3f} s")
    print(f"  sampling: {out['proposals']} proposals in "
          f"{out['wall_time']:.4f} s = "
          f"{_rate(out['proposals'], out['wall_time']):.6e} moves/s "
          f"(exchange rounds included)")
    print(f"  best energy {int(out['best_energy'].min())}; "
          f"peak_bytes_in_use: {_peak()}")
    _check_ladder(out["betas"], ladder)
    idx = _sample(chains, sample)
    check_against_oracle(out["final_energy"], out["final_state"], "full_3d",
                         idx, "final_energy")
    check_against_oracle(out["best_energy"], out["best_state"], "full_3d",
                         idx, "best_energy")


def _compare(a, b, fields, label) -> None:
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        check(np.array_equal(x, y), f"{label}: {f} differs")
    print(f"  {label}: bitwise equal ({', '.join(fields)})")


_RESULT_FIELDS = ("energy_history", "final_energy", "final_state",
                  "best_energy", "best_state", "steps_to_best",
                  "accept_bins", "total_bins")


def phase_tables_vs_naive(cases=None) -> None:
    """The count-table fast path against the O(N^2)/O(Q) plain reference.

    Both kernels draw the same threefry streams and compute integer dE, so
    on one card their trajectories must agree bitwise (tolerance 0).
    """
    from mcqueens.chain.spec import ChainSpec
    from mcqueens.core.schedules import build_schedule
    from mcqueens.dist import runner

    if cases is None:
        cases = [("board", 12, None, 64, 2000),
                 ("full_3d", 6, 30, 64, 2000),
                 ("board", 16, None, 4096, 2000)]
    for mcmc_type, N, Q, chains, n_steps in cases:
        specs = {k: ChainSpec(
            N=N, n_steps=n_steps, Q=Q,
            schedule=build_schedule("linear_annealing", n_steps,
                                    beta_start=0.5, beta_end=4.0),
            init_mode="random", mcmc_type=mcmc_type, kernel=k,
            history_stride=1) for k in ("tables", "naive")}
        seeds = 7 + np.arange(chains, dtype=np.uint32)
        res = {k: runner.run_chains(seeds, s) for k, s in specs.items()}
        label = (f"{mcmc_type} N={N}" + (f" Q={Q}" if Q else "")
                 + f", {chains} chains x {n_steps} steps")
        _compare(res["tables"], res["naive"], _RESULT_FIELDS, label)
        for k, r in res.items():
            print(f"  {k}: {r.wall_time:.2f} s sampling, first call (the "
                  f"segment's compile included), set-up {r.setup_time:.2f} s")
        check_against_oracle(res["tables"].final_energy,
                             res["tables"].final_state, mcmc_type,
                             _sample(chains, 8), "final_energy")


def phase_four_board(runs=4096, n_steps=65536, stride=16384) -> None:
    """configs/pod_scale.yaml (board N=20, 4096 runs) over the 4-card mesh."""
    import jax

    from mcqueens.dist import mesh as mesh_mod
    from mcqueens.dist import runner

    spec = _board_spec(20, n_steps, stride)
    seeds = 42 + np.arange(runs, dtype=np.uint32)
    print(f"  board N=20, {runs} runs x {n_steps} steps (pod_scale.yaml cut "
          f"from 5,000,000 steps), linear beta 1->5, stride {stride}")
    one = runner.run_chains(seeds, spec)
    mesh = mesh_mod.make_mesh()
    four = runner.run_chains(seeds, spec, mesh=mesh)
    check(one.n_devices == 1, f"one-card run spread over {one.n_devices}")
    check(four.n_devices == len(jax.devices()),
          f"mesh run spread over {four.n_devices} of "
          f"{len(jax.devices())} devices")
    print(f"  carry spans {four.n_devices} devices")
    _compare(one, four, _RESULT_FIELDS, f"1 card vs {four.n_devices} cards")
    # Rates from second, compiled calls (a first call's wall_time includes
    # the segment's compile).
    for label, kw in (("1 card", {}), ("mesh", {"mesh": mesh})):
        r = runner.run_chains(seeds, spec, **kw)
        print(f"  {label}: {_rate(r.proposals, r.wall_time):.6e} moves/s "
              f"(warm; set-up {r.setup_time:.3f} s)")
    print(f"  peak_bytes_in_use per card: {_peak()}")


def phase_four_tempered(chains=16384, stride=250, rounds=4) -> None:
    """A tempered full_3d search over the 4-card mesh vs one card."""
    import jax

    from mcqueens.dist import mesh as mesh_mod
    from mcqueens.search import tempering

    spec, ladder, init, seeds, seed = _push_setup(chains, stride, rounds)
    kw = dict(swap_seed=seed, initial_states=init)
    mesh = mesh_mod.make_mesh()
    one = tempering.run_tempered(seeds, spec, ladder, **kw)
    four = tempering.run_tempered(seeds, spec, ladder, mesh=mesh, **kw)
    check(four["n_devices"] == len(jax.devices()),
          f"mesh run spread over {four['n_devices']} of "
          f"{len(jax.devices())} devices")
    print(f"  carry spans {four['n_devices']} devices")
    for key in ("energy_history", "betas", "final_energy", "final_state",
                "best_energy", "best_state"):
        check(np.array_equal(one[key], four[key]),
              f"1 card vs 4 cards: {key} differs")
    print(f"  1 card vs {four['n_devices']} cards: bitwise equal "
          f"(energy_history, betas, final/best energies and states)")
    _check_ladder(four["betas"], ladder)
    for label, m in (("1 card", None), ("mesh", mesh)):
        r = tempering.run_tempered(seeds, spec, ladder, mesh=m, **kw)
        print(f"  {label}: {_rate(r['proposals'], r['wall_time']):.6e} "
              f"moves/s (warm; set-up {r['setup_time']:.3f} s)")
    print(f"  peak_bytes_in_use per card: {_peak()}")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-card mesh paths and what they "
                             "are compared with")
    args = parser.parse_args(argv)

    import_repo()
    import jax

    from mcqueens.utils import cache, profiling

    try:
        info = profiling.require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}; refusing to run (no CPU fallback)",
              file=sys.stderr)
        return 2
    if args.four and info["count"] != 4:
        print(f"chip_smoke: --four needs 4 GPUs, JAX found {info['count']}",
              file=sys.stderr)
        return 2
    cache.enable()

    phases = [("0 platform", lambda: phase_platform(info))]
    if args.four:
        phases += [("four: board pod_scale", phase_four_board),
                   ("four: tempered full_3d", phase_four_tempered)]
    else:
        phases += [("1 competition", phase_competition),
                   ("2 board throughput", phase_board_throughput),
                   ("3 qmax push", phase_qmax_push),
                   ("4 tables vs naive", phase_tables_vs_naive)]
    failed = run_phases(phases)
    if failed:
        print(f"chip_smoke: FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(final_line(profiling.device_summary(jax.devices())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
