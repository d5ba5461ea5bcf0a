"""Unit tests for the Q_max campaign tooling's pure logic.

The hardware campaigns (`tools/qmax*.py`) produced the frontier table in
``artifacts/RESULTS.md``; these tests lock the host-side protocol — the
descent/walk/confirm orchestration and the warm-start construction — with
the device search calls faked out, so a refactor cannot silently change what
the evidence means.
"""

import json
import math
import os

import numpy as np
import pytest

from tools import qmax_campaign, qmax_frontier, qmax_push


def test_campaign_rejects_klarner_closed_sizes():
    for n in (11, 13, 17, 19):
        assert math.gcd(n, 210) == 1
        with pytest.raises(SystemExit):
            qmax_campaign.main(["--n", str(n)])


def _wire(tmp_path, monkeypatch, edge_by_seed):
    """Fake the two hardware tools around a shared frontier JSON.

    ``edge_by_seed[seed]`` = highest Q that seed's warm push can certify;
    pushes walk up from --start and record a miss one past their edge,
    exactly like ``tools.qmax_push.main``.
    """
    outdir = str(tmp_path)
    monkeypatch.setattr(qmax_campaign, "OUTDIR", outdir)
    calls = []

    def path(n):
        return os.path.join(outdir, f"qmax_frontier_N{n}.json")

    def fake_frontier(argv):
        n = int(argv[argv.index("--n") + 1])
        calls.append(("frontier", n))
        with open(path(n), "w") as f:
            json.dump({"lower_bound": 10}, f)

    def fake_push(argv):
        n = int(argv[argv.index("--n") + 1])
        start = int(argv[argv.index("--start") + 1])
        seed = int(argv[argv.index("--seed") + 1])
        assert "--warm-start" in argv
        calls.append(("push", start, seed))
        out = json.load(open(path(n)))
        q = start
        while q <= edge_by_seed[seed]:
            out["lower_bound"] = max(out.get("lower_bound") or 0, q)
            edge = out.get("edge")
            if edge is not None and q >= edge["q"]:
                out.setdefault("edge_history", []).append(edge)
                del out["edge"]
            out.pop("complete", None)
            q += 1
        # full-budget warm miss at q, recorded like tools.qmax_push.main
        key = f"Q{q}_push_warm"
        if key in out and out[key].get("seed", 31337) != seed:
            key = f"{key}_s{seed}"
        out[key] = {"min_energy": 1, "wall_s": 1.0,
                    "proposals": qmax_campaign.FULL_BUDGET,
                    "protocol": "tempered_push_warm", "seed": seed}
        with open(path(n), "w") as f:
            json.dump(out, f)

    monkeypatch.setattr(qmax_campaign.qmax_frontier, "main", fake_frontier)
    monkeypatch.setattr(qmax_campaign.qmax_push, "main", fake_push)
    return calls, path


def test_campaign_walk_and_two_seed_confirmation(tmp_path, monkeypatch):
    # Primary seed certifies through 12; the confirm seed breaks the miss
    # at 13 once (certifies 13), after which the primary walk resumes and
    # misses at 14, and the confirm seed then agrees (miss held).
    calls, path = _wire(tmp_path, monkeypatch,
                        edge_by_seed={31337: 12, 4242: 13})
    qmax_campaign.main(["--n", "12", "--seed", "31337",
                        "--confirm-seed", "4242"])
    assert calls == [
        ("frontier", 12),
        ("push", 11, 31337),   # walk from probes' bound+1 -> certifies 12
        ("push", 13, 4242),    # confirm attacks the miss -> breaks it (13)
        ("push", 14, 31337),   # primary walk resumes -> misses at 14
        ("push", 14, 4242),    # confirm re-attacks -> miss holds: done
    ]
    out = json.load(open(path(12)))
    assert out["lower_bound"] == 13
    # Closure is an explicit edge record derived from the banked misses —
    # both seeds missed Q=14 at the full budget (VERDICT r4: never a bare
    # boolean a probe-phase stop could also write).
    assert out["edge"] == {"q": 14, "seeds": [4242, 31337],
                           "budget_proposals": qmax_campaign.FULL_BUDGET}
    assert "complete" not in out


def test_campaign_without_confirm_stops_at_first_miss(tmp_path, monkeypatch):
    calls, path = _wire(tmp_path, monkeypatch, edge_by_seed={31337: 12})
    qmax_campaign.main(["--n", "12", "--seed", "31337"])
    assert calls == [("frontier", 12), ("push", 11, 31337)]
    out = json.load(open(path(12)))
    assert out["lower_bound"] == 12
    assert out["edge"] == {"q": 13, "seeds": [31337],
                           "budget_proposals": qmax_campaign.FULL_BUDGET}
    assert "complete" not in out


def test_campaign_forwards_probe_budget(tmp_path, monkeypatch):
    calls, path = _wire(tmp_path, monkeypatch, edge_by_seed={31337: 12})
    seen = []

    def budget_frontier(argv):
        seen.append(argv)
        n = int(argv[argv.index("--n") + 1])
        with open(path(n), "w") as f:
            json.dump({"lower_bound": 10}, f)

    monkeypatch.setattr(qmax_campaign.qmax_frontier, "main", budget_frontier)
    qmax_campaign.main(["--n", "12", "--budget-s", "900"])
    assert seen == [["--n", "12", "--budget-s", "900.0"]]


def test_campaign_skip_probes_reuses_bound(tmp_path, monkeypatch):
    calls, path = _wire(tmp_path, monkeypatch, edge_by_seed={31337: 12})
    with open(path(12), "w") as f:
        json.dump({"lower_bound": 11}, f)
    qmax_campaign.main(["--n", "12", "--skip-probes"])
    assert calls == [("push", 12, 31337)]


def test_campaign_forwards_checkpoint_dir(tmp_path, monkeypatch):
    # Default on: every push gets OUTDIR/.ckpt so a hung/killed push
    # resumes mid-search; '' disables the forwarding entirely.
    calls, path = _wire(tmp_path, monkeypatch, edge_by_seed={31337: 12})
    argvs = []
    real_push = qmax_campaign.qmax_push.main

    def spy_push(argv):
        argvs.append(list(argv))
        real_push(argv)

    monkeypatch.setattr(qmax_campaign.qmax_push, "main", spy_push)
    qmax_campaign.main(["--n", "12", "--seed", "31337"])
    expected = os.path.join(str(tmp_path), ".ckpt")
    for argv in argvs:
        assert argv[argv.index("--checkpoint-dir") + 1] == expected

    argvs.clear()
    qmax_campaign.main(["--n", "12", "--seed", "31337",
                        "--checkpoint-dir", ""])
    assert argvs and all("--checkpoint-dir" not in a for a in argvs)


def test_push_checkpoints_and_clears_on_success(tmp_path, monkeypatch):
    # push() hands run_tempered a Checkpointer rooted at checkpoint_dir
    # (tagged by N/Q/seed/protocol so campaigns never cross-restore) and
    # clears it once the push completes.
    from mcqueens.utils.checkpoint import Checkpointer
    seen = {}

    def fake_run_tempered(seeds, spec, ladder, **kw):
        ck = kw["checkpointer"]
        seen["ckpt"] = ck
        # simulate a mid-run save so clear() has something real to remove
        ck._last_save_t = None
        np.save(open(ck.chunk_path(0, "fp"), "wb"), np.zeros(1))
        open(ck.path, "wb").write(b"x")
        return {"best_energy": np.asarray([3]),
                "best_state": np.zeros((1, 5, 3), np.int64),
                "proposals": 7}

    monkeypatch.setattr(qmax_push.tempering_mod, "run_tempered",
                        fake_run_tempered)
    monkeypatch.setattr(qmax_push, "full3d_energy", lambda a: 3)
    e, best, wall, proposals = qmax_push.push(
        6, 5, seed=9, warm=False, checkpoint_dir=str(tmp_path))
    ck = seen["ckpt"]
    assert isinstance(ck, Checkpointer)
    assert ck.directory == str(tmp_path)
    assert ck.tag == "push_N6_Q5_s9"
    assert ck.min_interval_s > 0   # GB-sized carry pulls: rate-limit
    assert not os.path.exists(ck.path)
    assert not os.path.exists(ck.chunk_path(0, "fp"))
    # without a dir, no checkpointer is constructed at all
    def no_ckpt_run(seeds, spec, ladder, **kw):
        assert kw["checkpointer"] is None
        return {"best_energy": np.asarray([3]),
                "best_state": np.zeros((1, 5, 3), np.int64),
                "proposals": 7}

    monkeypatch.setattr(qmax_push.tempering_mod, "run_tempered", no_ckpt_run)
    qmax_push.push(6, 5, seed=9, warm=False, checkpoint_dir=None)


def test_campaign_errors_when_probes_find_nothing(tmp_path, monkeypatch):
    calls, path = _wire(tmp_path, monkeypatch, edge_by_seed={})

    def no_cert(argv):
        n = int(argv[argv.index("--n") + 1])
        with open(path(n), "w") as f:
            json.dump({"lower_bound": None}, f)

    monkeypatch.setattr(qmax_campaign.qmax_frontier, "main", no_cert)
    with pytest.raises(SystemExit):
        qmax_campaign.main(["--n", "12"])


class _FakeClock:
    """time.time() stand-in advancing a fixed step per call."""

    def __init__(self, step):
        self.now, self.step = 0.0, step

    def time(self):
        t = self.now
        self.now += self.step
        return t


def _wire_frontier(tmp_path, monkeypatch, energy_by_q, clock_step=0.0):
    """Fake the device search under qmax_frontier's real orchestration.

    Returns (probed, banked): ``banked[i]`` is the frontier JSON as it sat
    on disk when probe ``i`` *started* — i.e. what a kill mid-probe would
    leave behind, independent of the unconditional final flush.
    """
    monkeypatch.setattr(qmax_frontier, "OUTDIR", str(tmp_path))
    monkeypatch.setattr(qmax_frontier, "full3d_energy", lambda a: 0)
    monkeypatch.setattr(qmax_frontier, "time", _FakeClock(clock_step))
    probed, banked = [], []
    json_path = os.path.join(str(tmp_path), "qmax_frontier_N12.json")

    def fake_search(N, Q, n_steps, beta_end, seed=0):
        if os.path.exists(json_path):
            banked.append(json.load(open(json_path)))
        else:
            banked.append(None)
        probed.append(Q)
        board = np.zeros((Q, 3), np.int32)
        return energy_by_q[Q], board, 1.0, 4096 * n_steps

    monkeypatch.setattr(qmax_frontier, "search", fake_search)
    return probed, banked


def test_frontier_budget_stops_walk_and_flushes(tmp_path, monkeypatch):
    # Certificates exist up to Q=13; each probe advances the fake clock by
    # ~30s (two time() calls per budget check + probes), so --budget-s 100
    # stops the walk before it can reach the Q=14 miss.
    energy = {10: 0, 11: 0, 12: 0, 13: 0, 14: 4}
    probed, banked = _wire_frontier(tmp_path, monkeypatch, energy,
                                    clock_step=30.0)
    qmax_frontier.main(["--n", "12", "--start", "10", "--budget-s", "100"])
    out = json.load(open(os.path.join(str(tmp_path),
                                      "qmax_frontier_N12.json")))
    assert out["probes_complete"] is False
    assert out["lower_bound"] == max(q for q in probed if energy[q] == 0)
    assert 14 not in probed  # the edge probe never started
    # Every earlier probe was already banked on disk when the next one
    # started (a kill mid-probe loses nothing) — asserted mid-run, not via
    # the unconditional final flush.
    for i, q in enumerate(probed[1:], start=1):
        assert banked[i] is not None
        for prev in probed[:i]:
            assert f"Q{prev}" in banked[i]


def test_frontier_unbudgeted_walks_to_the_edge(tmp_path, monkeypatch):
    energy = {10: 4, 8: 0, 9: 0}  # descent 10 -> miss e=4 -> 8, walk up to 9
    probed, banked = _wire_frontier(tmp_path, monkeypatch, energy)
    qmax_frontier.main(["--n", "12", "--start", "10"])
    out = json.load(open(os.path.join(str(tmp_path),
                                      "qmax_frontier_N12.json")))
    assert probed == [10, 10, 8, 9]  # the miss at 10 escalates (2nd search)
    assert out["probes_complete"] is True
    assert out["lower_bound"] == 9
    assert out["Q10"]["min_energy"] == 4
    # Regression (ADVICE r3): the flush right after a zero-energy descent
    # probe must bank the NEW certificate, not a stale/None bound — i.e. by
    # the time the walk-up probe at Q=9 starts, lower_bound is already 8.
    assert banked[3]["lower_bound"] == 8


def test_frontier_resumes_from_banked_json(tmp_path, monkeypatch):
    # A killed run banked the descent (miss at 10, certificate at 8).  The
    # re-run must replay those records WITHOUT searching and continue the
    # walk-up where it died — here one real probe at 9 closes the edge.
    banked = {
        "Q10": {"min_energy": 4, "proposals": 1, "wall_s": 1.0},
        "Q8": {"min_energy": 0, "proposals": 1, "wall_s": 1.0,
               "board": "qmax_N12_Q8.txt"},
        "lower_bound": 8, "complete": False,  # legacy conflated flag
    }
    json_path = os.path.join(str(tmp_path), "qmax_frontier_N12.json")
    with open(json_path, "w") as f:
        json.dump(banked, f)
    probed, _ = _wire_frontier(tmp_path, monkeypatch, {9: 0})
    qmax_frontier.main(["--n", "12", "--start", "10"])
    assert probed == [9]  # banked 10 and 8 never re-searched
    out = json.load(open(json_path))
    assert out["lower_bound"] == 9 and out["probes_complete"] is True
    assert "complete" not in out  # the legacy flag is retired, not rewritten
    assert out["Q10"]["min_energy"] == 4  # banked evidence preserved


def test_frontier_resume_never_lowers_a_pushed_bound(tmp_path, monkeypatch):
    # Warm pushes raised the banked bound past every cold certificate; a
    # frontier re-run (cold probes only) must keep the pushed bound and the
    # push record itself through its flushes.
    banked = {
        "Q8": {"min_energy": 0, "proposals": 1, "wall_s": 1.0},
        "Q12_push_warm": {"min_energy": 0, "proposals": 1, "wall_s": 1.0,
                          "protocol": "tempered_push_warm", "seed": 31337},
        "lower_bound": 12, "edge": {"q": 13, "seeds": [31337],
                                    "budget_proposals": 524288000000},
    }
    json_path = os.path.join(str(tmp_path), "qmax_frontier_N12.json")
    with open(json_path, "w") as f:
        json.dump(banked, f)
    probed, _ = _wire_frontier(tmp_path, monkeypatch, {9: 2})
    qmax_frontier.main(["--n", "12", "--start", "8"])
    assert probed == [9, 9]  # one real (escalated) cold probe at the edge
    out = json.load(open(json_path))
    assert out["lower_bound"] == 12  # pushed bound survives cold flushes
    assert "Q12_push_warm" in out   # push record survives too
    assert out["edge"] == banked["edge"]  # cold probes never touch closure


def test_frontier_walkup_gallops_and_bisects_wide_gaps(tmp_path, monkeypatch):
    # Descent overshoots (miss 20 at Q=30 -> jump to 20); the walk-up must
    # NOT probe every Q in between: gallop 21, 23, 27, then bisect 28.
    energy = {30: 20, 20: 0, 21: 0, 23: 0, 27: 0, 28: 2}
    probed, _ = _wire_frontier(tmp_path, monkeypatch, energy)
    qmax_frontier.main(["--n", "12", "--start", "30"])
    out = json.load(open(os.path.join(str(tmp_path),
                                      "qmax_frontier_N12.json")))
    # 30 probes twice (escalation), then descent cert at 20, gallop, bisect
    assert probed == [30, 30, 20, 21, 23, 27, 28, 28]
    for skipped in (22, 24, 25, 26, 29):
        assert skipped not in probed
    assert out["probes_complete"] is True
    assert out["lower_bound"] == 27
    assert out["Q28"]["min_energy"] == 2


def test_push_past_closed_edge_reopens_it(tmp_path, monkeypatch):
    # VERDICT r4 demand: a warm push that certifies at (or past) a recorded
    # edge must leave the JSON UN-closed — the old shared `complete` flag
    # survived exactly this walk at N=22 and lied about the frontier.
    monkeypatch.setattr(qmax_push, "OUTDIR", str(tmp_path))
    json_path = os.path.join(str(tmp_path), "qmax_frontier_N12.json")
    with open(json_path, "w") as f:
        json.dump({"lower_bound": 12, "complete": True,
                   "edge": {"q": 13, "seeds": [31337],
                            "budget_proposals": 524288000000}}, f)
    edge_q = 14  # certs at 13, 14; miss at 15

    def fake_push(N, Q, seed, warm, checkpoint_dir=None):
        e = 0 if Q <= edge_q else 1
        return e, np.zeros((Q, 3), np.int64), 1.0, qmax_campaign.FULL_BUDGET

    monkeypatch.setattr(qmax_push, "push", fake_push)
    qmax_push.main(["--n", "12", "--start", "13", "--seed", "777",
                    "--warm-start"])
    out = json.load(open(json_path))
    assert out["lower_bound"] == 14
    assert "edge" not in out        # the certified walk refuted the closure
    assert "complete" not in out    # and retired the legacy flag
    assert out["edge_history"][0]["q"] == 13  # refutation stays auditable
    # the new miss at 15 is banked as full-budget warm evidence, so a
    # campaign can re-close the size from it
    assert qmax_campaign.derive_edge(out, 14) == {
        "q": 15, "seeds": [777],
        "budget_proposals": qmax_campaign.FULL_BUDGET}


def test_campaign_stays_open_without_full_budget_miss(tmp_path, monkeypatch):
    # An early-stopped (below-budget) miss is NOT edge evidence: the
    # campaign must refuse to write an edge record.
    calls, path = _wire(tmp_path, monkeypatch, edge_by_seed={31337: 12})

    def truncated_push(argv):
        n = int(argv[argv.index("--n") + 1])
        out = json.load(open(path(n)))
        out["lower_bound"] = 12
        out["Q13_push_warm"] = {
            "min_energy": 1, "proposals": qmax_campaign.FULL_BUDGET // 2,
            "protocol": "tempered_push_warm", "seed": 31337}
        with open(path(n), "w") as f:
            json.dump(out, f)

    monkeypatch.setattr(qmax_campaign.qmax_push, "main", truncated_push)
    qmax_campaign.main(["--n", "12", "--seed", "31337"])
    out = json.load(open(path(12)))
    assert "edge" not in out and "complete" not in out


def test_derive_edge_filters_non_evidence():
    full = qmax_campaign.FULL_BUDGET
    out = {
        "lower_bound": 12,
        # qualifying: warm, full budget, miss, at Q=13
        "Q13_push_warm": {"min_energy": 1, "proposals": full,
                          "protocol": "tempered_push_warm", "seed": 31337},
        "Q13_push_warm_s4242": {"min_energy": 1, "proposals": full,
                                "protocol": "tempered_push_warm",
                                "seed": 4242},
        # non-evidence: cold push, below budget, certificate, wrong Q
        "Q13_push": {"min_energy": 2, "proposals": full,
                     "protocol": "tempered_push", "seed": 1},
        "Q13_push_warm_s9": {"min_energy": 1, "proposals": full - 1,
                             "protocol": "tempered_push_warm", "seed": 9},
        "Q12_push_warm": {"min_energy": 0, "proposals": full,
                          "protocol": "tempered_push_warm", "seed": 31337},
        "Q14_push_warm": {"min_energy": 3, "proposals": full,
                          "protocol": "tempered_push_warm", "seed": 31337},
    }
    assert qmax_campaign.derive_edge(out, 12) == {
        "q": 13, "seeds": [4242, 31337], "budget_proposals": full}
    assert qmax_campaign.derive_edge({"Q13": {"min_energy": 1}}, 12) is None


def test_warm_states_structure(tmp_path, monkeypatch):
    # Warm starts = the archived Q-1 certificate plus ONE extra queen on a
    # per-chain random EMPTY cell: every chain's cells stay distinct and
    # the first Q-1 rows are the certificate itself.
    N, Q = 4, 8
    rng = np.random.default_rng(3)
    cells = rng.choice(N ** 3, size=Q - 1, replace=False)
    base = np.stack([cells // (N * N), (cells // N) % N, cells % N],
                    axis=-1).astype(np.int32)
    # zero-attack not required for the structural test, but the loader
    # asserts it -- so write a file and monkeypatch the oracle check away.
    monkeypatch.setattr(qmax_push, "OUTDIR", str(tmp_path))
    with open(os.path.join(str(tmp_path), f"qmax_N{N}_Q{Q-1}.txt"), "w") as f:
        for i, j, k in base.tolist():
            f.write(f"{i},{j},{k}\n")
    monkeypatch.setattr(qmax_push, "full3d_energy", lambda a: 0)
    states = qmax_push.warm_states(N, Q, chains=32, seed=5)
    assert states.shape == (32, Q, 3)
    occ = set(map(tuple, base.tolist()))
    for r in range(32):
        rows = [tuple(q) for q in states[r].tolist()]
        assert rows[:Q - 1] == [tuple(q) for q in base.tolist()]
        assert len(set(rows)) == Q          # extra cell was empty
        assert tuple(states[r, -1]) not in occ


def _wire_floors(tmp_path, monkeypatch, energies):
    """Fake tools.full3d_floors_campaign._search; energies is a list popped
    per call (fresh, confirm, refine0, refine1, ...)."""
    from tools import full3d_floors_campaign as camp

    monkeypatch.setattr(camp, "_outdir", lambda mcmc_type: str(tmp_path))
    calls = []

    def fake_search(n, seed, b0, b1, mcmc_type, outdir, resume_from=None,
                    n_steps=None, ladder=None):
        e = energies[len(calls)]
        calls.append((seed, b0, b1, resume_from, mcmc_type, n_steps, ladder))
        path = os.path.join(str(tmp_path), "competition_results",
                            f"best_heights_{n}_{len(calls):04d}.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("0,0,0\n")
        return e, path, 1.0

    monkeypatch.setattr(camp, "_search", fake_search)
    return camp, calls


def test_floors_campaign_refines_until_stable(tmp_path, monkeypatch):
    # fresh 27, confirm 26, refine improves to 24, next refine stalls -> stop
    camp, calls = _wire_floors(tmp_path, monkeypatch, [27, 26, 24, 24])
    camp.main(["--sizes", "14"])
    log = json.load(open(os.path.join(str(tmp_path), "campaign.json")))
    assert log["N14"]["floor"] == 24
    assert [c[:3] for c in calls] == [
        (31337, 0.8, 7.0), (4242, 0.8, 7.0),
        (777, 2.0, 10.0), (778, 2.0, 10.0),
    ]
    # refinements warm-start from the best board so far
    assert calls[2][3].endswith("0002.txt")  # confirm's 26 board
    assert calls[3][3].endswith("0003.txt")  # refine0's 24 board


def test_floors_campaign_resumes_from_banked_searches(tmp_path, monkeypatch):
    camp, calls = _wire_floors(tmp_path, monkeypatch, [30, 29, 29])
    camp.main(["--sizes", "12"])
    n_first = len(calls)
    assert n_first == 3  # fresh, confirm, one stalled refinement
    # a rerun must skip everything already banked
    camp2, calls2 = _wire_floors(tmp_path, monkeypatch, [])
    camp2.main(["--sizes", "12"])
    assert calls2 == []
    log = json.load(open(os.path.join(str(tmp_path), "campaign.json")))
    assert log["N12"]["floor"] == 29


def test_floors_campaign_board_refine_from(tmp_path, monkeypatch):
    # --refine-from anchors on the committed board's ORACLE energy (30 for
    # the N=14 board-floor board), skips fresh/confirm, and every search
    # runs the board-constrained chain.
    camp, calls = _wire_floors(tmp_path, monkeypatch, [29, 29])
    prior = os.path.join(str(tmp_path), "committed_14.txt")
    with open(prior, "w") as f:
        f.write("0,0,0\n")
    import tools.verify_board as vb
    monkeypatch.setattr(vb, "verify", lambda p: {
        "distinct_cells": True, "oracle_energy": 30})
    camp.main(["--sizes", "14", "--mcmc-type", "board",
               "--refine-from", prior])
    log = json.load(open(os.path.join(str(tmp_path), "campaign.json")))
    kinds = [s["kind"] for s in log["N14"]["searches"]]
    assert kinds == ["prior", "refine0", "refine1"]
    assert log["N14"]["floor"] == 29
    # first refinement warm-starts from the committed board itself,
    # the second from the improved refine0 export; all run board mode
    assert calls[0][3] == prior and calls[0][4] == "board"
    assert calls[1][3].endswith("0001.txt") and calls[1][4] == "board"


def test_floors_campaign_long_schedule_banks_separately(tmp_path, monkeypatch):
    # The 4x-budget longer-schedule test (--kind-prefix long --n-steps 32M)
    # must NOT be skipped by banked default-protocol refinements, must
    # forward its budget to the search, and must record it in the log.
    camp, calls = _wire_floors(tmp_path, monkeypatch, [29, 29])
    prior = os.path.join(str(tmp_path), "committed_18.txt")
    with open(prior, "w") as f:
        f.write("0,0,0\n")
    import tools.verify_board as vb
    monkeypatch.setattr(vb, "verify", lambda p: {
        "distinct_cells": True, "oracle_energy": 30})
    camp.main(["--sizes", "18", "--mcmc-type", "board",
               "--refine-from", prior])
    # default protocol: refine0 improves to 29, refine1 stalls
    assert [c[0] for c in calls] == [777, 778]
    camp2, calls2 = _wire_floors(tmp_path, monkeypatch, [28, 28])
    monkeypatch.setattr(vb, "verify", lambda p: {
        "distinct_cells": True, "oracle_energy": 30})
    camp2.main(["--sizes", "18", "--mcmc-type", "board",
                "--refine-from", prior, "--kind-prefix", "long",
                "--n-steps", "32000000", "--max-refines", "2"])
    # ran despite banked refine0; budget forwarded; improvement then stall
    assert [(c[0], c[5]) for c in calls2] == [(777, 32000000),
                                              (778, 32000000)]
    log = json.load(open(os.path.join(str(tmp_path), "campaign.json")))
    kinds = [s["kind"] for s in log["N18"]["searches"]]
    assert kinds == ["prior", "refine0", "refine1", "long0", "long1"]
    assert log["N18"]["searches"][3]["n_steps"] == 32000000
    assert log["N18"]["floor"] == 28


def test_floors_campaign_refine_from_held_floor(tmp_path, monkeypatch):
    # a refinement that cannot improve the prior stops after one pass and
    # the floor stays the prior's energy
    camp, calls = _wire_floors(tmp_path, monkeypatch, [62])
    prior = os.path.join(str(tmp_path), "committed_15.txt")
    with open(prior, "w") as f:
        f.write("0,0,0\n")
    import tools.verify_board as vb
    monkeypatch.setattr(vb, "verify", lambda p: {
        "distinct_cells": True, "oracle_energy": 62})
    camp.main(["--sizes", "15", "--mcmc-type", "board",
               "--refine-from", prior])
    log = json.load(open(os.path.join(str(tmp_path), "campaign.json")))
    assert len(calls) == 1  # one stalled refinement, then stop
    assert log["N15"]["floor"] == 62
    assert log["N15"]["floor_board"] == "committed_15.txt"
