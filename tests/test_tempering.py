"""Parallel tempering tests: exchange rule, invariants, per-level marginals.

The tempered sampler must (a) leave each group's beta multiset invariant,
(b) keep the samplers' incremental energies exact, and (c) leave each ladder
level's marginal distribution Boltzmann at that level's beta — the defining
property of replica exchange (states swap temperature without corrupting
either level's law).  Tempering runs on the ordinary XLA samplers through
their per-chain ``beta_scale`` row.
"""

import itertools

import numpy as np
import pytest

import jax.numpy as jnp

from mcqueens.chain.spec import ChainSpec
from mcqueens.core.schedules import build_schedule
from mcqueens.search import tempering
from tests import _oracle


def _spec(**kw):
    defaults = dict(
        N=5,
        n_steps=400,
        schedule=build_schedule("constant", 400, beta_const=1.0),
        init_mode="random",
        mcmc_type="board",
        kernel="tables",
        history_stride=50,
    )
    defaults.update(kw)
    return ChainSpec(**defaults)


def test_geometric_ladder():
    lad = tempering.geometric_ladder(0.5, 4.0, 4)
    assert lad[0] == pytest.approx(0.5) and lad[-1] == pytest.approx(4.0)
    ratios = lad[1:] / lad[:-1]
    np.testing.assert_allclose(ratios, ratios[0], rtol=1e-5)
    with pytest.raises(ValueError):
        tempering.geometric_ladder(2.0, 1.0, 4)
    with pytest.raises(ValueError):
        tempering.geometric_ladder(1.0, 2.0, 1)


def test_exchange_certain_and_impossible_swaps():
    """Deterministic limits of min(1, exp(dbeta * dE)).

    Pair (level0, level1) with beta 0.1 vs 10: if E_cold << E_hot the swap
    is certain (log A huge positive); if E_cold >> E_hot it is essentially
    impossible (log A = -990 < log u for any float u > 0).
    """
    betas = jnp.asarray([0.1, 10.0, 0.1, 10.0], jnp.float32)
    rkey = tempering.round_key(0, 0)
    # (beta0 - beta1)(E0 - E1) = (-9.9)(-100) >> 0 -> certain swap
    e_swap = jnp.asarray([0.0, 100.0, 0.0, 100.0], jnp.float32)
    out = tempering.exchange(betas, e_swap, rkey, 2, 0)
    np.testing.assert_allclose(np.asarray(out), [10.0, 0.1, 10.0, 0.1])
    # (beta0 - beta1)(E0 - E1) = (-9.9)(100) = -990 -> never swaps
    e_stay = jnp.asarray([100.0, 0.0, 100.0, 0.0], jnp.float32)
    out = tempering.exchange(betas, e_stay, rkey, 2, 0)
    np.testing.assert_allclose(np.asarray(out), np.asarray(betas))


def test_exchange_phase_pairs_and_tail():
    """Phase 1 pairs levels (1,2); level 0 and tail chains never move."""
    betas = jnp.asarray([1.0, 2.0, 3.0, 1.0, 2.0, 3.0, 7.0], jnp.float32)
    e = jnp.asarray([0.0, 100.0, 0.0, 0.0, 100.0, 0.0, 5.0], jnp.float32)
    rkey = tempering.round_key(1, 0)
    out = np.asarray(tempering.exchange(betas, e, rkey, 3, 1))
    # (b1-b2)(E1-E2) = (-1)(100) = -100 -> no swap
    np.testing.assert_allclose(out, np.asarray(betas))
    e = jnp.asarray([0.0, 0.0, 100.0, 0.0, 0.0, 100.0, 5.0], jnp.float32)
    out = np.asarray(tempering.exchange(betas, e, rkey, 3, 1))
    # (b1-b2)(E1-E2) = (-1)(-100) -> certain swap of levels 1 and 2
    np.testing.assert_allclose(out, [1.0, 3.0, 2.0, 1.0, 3.0, 2.0, 7.0])


@pytest.mark.parametrize("n_levels,groups", [(2, 3), (5, 7), (16, 4)])
def test_exchange_preserves_group_multisets(n_levels, groups):
    rng = np.random.default_rng(3)
    ladder = tempering.geometric_ladder(0.2, 5.0, n_levels)
    betas = jnp.asarray(np.tile(ladder, groups))
    for r in range(20):
        e = jnp.asarray(rng.integers(0, 60, betas.shape[0]), jnp.float32)
        betas = tempering.exchange(betas, e, tempering.round_key(9, r),
                                   n_levels, r % 2)
    b = np.asarray(betas).reshape(groups, n_levels)
    for g in range(groups):
        np.testing.assert_allclose(np.sort(b[g]), np.sort(ladder))


def test_tempered_run_energy_invariants():
    spec = _spec(n_steps=300, history_stride=50)
    ladder = tempering.geometric_ladder(0.3, 3.0, 4)
    out = tempering.run_tempered(
        np.arange(8, dtype=np.uint32), spec, ladder, record_betas=True)
    for r in range(8):
        assert out["final_energy"][r] == _oracle.board_energy(
            out["final_state"][r])
        assert out["best_energy"][r] == _oracle.board_energy(
            out["best_state"][r])
        assert out["best_energy"][r] <= out["energy_history"][r].min()
    # Ladder multiset preserved within each complete group of real chains.
    b = out["betas"].reshape(2, 4)
    for g in range(2):
        np.testing.assert_allclose(np.sort(b[g]), np.sort(ladder))
    assert out["betas_history"].shape == (spec.n_outer, 8)
    np.testing.assert_allclose(out["betas_history"][0], np.tile(ladder, 2))


def test_tempered_run_deterministic():
    spec = _spec(n_steps=200, history_stride=50)
    ladder = tempering.geometric_ladder(0.5, 2.0, 2)
    seeds = np.arange(4, dtype=np.uint32)
    a = tempering.run_tempered(seeds, spec, ladder, swap_seed=5)
    b = tempering.run_tempered(seeds, spec, ladder, swap_seed=5)
    np.testing.assert_array_equal(a["energy_history"], b["energy_history"])
    np.testing.assert_array_equal(a["betas"], b["betas"])
    np.testing.assert_array_equal(a["final_state"], b["final_state"])


def test_tempered_early_stop():
    """stop_at_energy truncates the round loop without perturbing it.

    A trivially satisfied target stops after round 1 with a bit-identical
    prefix of the unstopped history; an unreachable target (-1) leaves the
    run bitwise unchanged vs no flag at all.
    """
    spec = _spec(n_steps=300, history_stride=50)
    ladder = tempering.geometric_ladder(0.3, 3.0, 3)
    seeds = np.arange(6, dtype=np.uint32)
    full = tempering.run_tempered(seeds, spec, ladder, swap_seed=5)
    stopped = tempering.run_tempered(
        seeds, spec, ladder, swap_seed=5, stop_at_energy=10**9)
    never = tempering.run_tempered(
        seeds, spec, ladder, swap_seed=5, stop_at_energy=-1)
    # Stopped after round 1: initial energies + one history point.
    assert stopped["energy_history"].shape == (6, 2)
    np.testing.assert_array_equal(stopped["energy_history"],
                                  full["energy_history"][:, :2])
    # One round of work out of six.
    assert stopped["proposals"] * 6 == full["proposals"]
    assert stopped["best_energy"].min() <= 10**9
    for r in range(6):
        assert stopped["best_energy"][r] == _oracle.board_energy(
            stopped["best_state"][r])
    # Unreachable target: bitwise identical to the plain run.
    np.testing.assert_array_equal(never["energy_history"],
                                  full["energy_history"])
    np.testing.assert_array_equal(never["final_state"], full["final_state"])
    np.testing.assert_array_equal(never["betas"], full["betas"])


@pytest.mark.parametrize("mcmc_type", ["board", "full_3d"])
def test_tempered_naive_equals_tables(mcmc_type):
    """Both kernels draw the same streams, so tempered runs agree bitwise."""
    kw = dict(mcmc_type=mcmc_type, N=4, n_steps=200)
    if mcmc_type == "full_3d":
        kw["Q"] = 10
    ladder = tempering.geometric_ladder(0.5, 3.0, 4)
    seeds = np.arange(8, dtype=np.uint32)
    a = tempering.run_tempered(seeds, _spec(kernel="tables", **kw), ladder,
                               swap_seed=2)
    b = tempering.run_tempered(seeds, _spec(kernel="naive", **kw), ladder,
                               swap_seed=2)
    for key in ("energy_history", "final_state", "best_state", "betas"):
        np.testing.assert_array_equal(a[key], b[key])


def _exact_laws(mcmc_type, N, Q, betas):
    """Exact Boltzmann energy laws over every state of an enumerable space:
    the N^(N^2) boards, or the C(N^3, Q) distinct-cell full_3d placements."""
    if mcmc_type == "board":
        states = (np.array(hs).reshape(N, N)
                  for hs in itertools.product(range(N), repeat=N * N))
        energy = _oracle.board_energy
    else:
        cells = list(itertools.product(range(N), repeat=3))
        states = (np.array(c) for c in itertools.combinations(cells, Q))
        energy = _oracle.full3d_energy
    weights = {b: {} for b in betas}
    for st in states:
        e = energy(st)
        for b in betas:
            weights[b][e] = weights[b].get(e, 0.0) + np.exp(-b * e)
    return {b: {e: w / sum(ws.values()) for e, w in ws.items()}
            for b, ws in weights.items()}


@pytest.mark.parametrize("mcmc_type,kernel", [
    ("board", "tables"), ("board", "naive"),
    ("full_3d", "tables"), ("full_3d", "naive"),
])
def test_tempered_marginals_are_boltzmann_per_level(mcmc_type, kernel):
    """N=3 enumerable spaces: each ladder level's marginal obeys its own
    Boltzmann law even as configurations migrate between levels.

    This is the correctness statement of replica exchange.  A broken swap
    rule (e.g. swapping betas unconditionally) would drag each level's
    marginal toward the other's; the power guard asserts the two levels'
    laws are separated by more than the tolerance, so the test can detect
    such mixing.
    """
    N, n_steps, stride = 3, 12000, 50
    Q = 3 if mcmc_type == "full_3d" else None
    b_hot, b_cold = 0.4, 1.4
    spec = _spec(
        N=N,
        n_steps=n_steps,
        schedule=build_schedule("constant", n_steps, beta_const=1.0),
        history_stride=stride,
        mcmc_type=mcmc_type,
        kernel=kernel,
        Q=Q,
    )
    ladder = np.asarray([b_hot, b_cold], np.float32)
    out = tempering.run_tempered(
        np.arange(64, dtype=np.uint32), spec, ladder,
        record_betas=True, swap_seed=11)
    laws = _exact_laws(mcmc_type, N, Q, (b_hot, b_cold))

    burn = 3000 // stride
    # energy_history[:, r+1] is the sample at the end of round r, generated
    # under betas_history[r].
    ehist = out["energy_history"][:, 1:]  # (C, rounds)
    bhist = out["betas_history"].T        # (C, rounds)
    tol = 0.04
    for b in (b_hot, b_cold):
        samples = ehist[:, burn:][np.isclose(bhist[:, burn:], b)]
        assert samples.size >= 4000
        for e, p in laws[b].items():
            emp = (samples == e).mean()
            assert abs(emp - p) < tol, (b, e, emp, p)
    # Power guard: the two levels' laws must differ by more than 2*tol
    # somewhere, or mixing between levels would be undetectable.
    gap = max(
        abs(laws[b_hot].get(e, 0.0) - laws[b_cold].get(e, 0.0))
        for e in laws[b_cold]
    )
    assert gap > 2 * tol, f"test lacks power: hot-vs-cold gap {gap}"
    # And swaps must actually happen (a dead exchange would also pass the
    # marginal check): some chain must change level at least once.
    assert (bhist[:, burn:] != bhist[:, burn:burn + 1]).any()


def test_exchange_interval_decouples_swaps_from_history():
    """Swaps can be sparser than history points; history cadence unchanged."""
    seeds = np.arange(8, dtype=np.uint32)
    spec = _spec(n_steps=400, history_stride=50)  # n_outer = 8
    ladder = tempering.geometric_ladder(0.3, 3.0, 4)
    out1 = tempering.run_tempered(seeds, spec, ladder, swap_seed=7,
                                  record_betas=True)
    out4 = tempering.run_tempered(seeds, spec, ladder, swap_seed=7,
                                  record_betas=True, exchange_interval=4)
    # One history point per stride chunk either way.
    assert out1["energy_history"].shape == (8, spec.n_outer + 1)
    assert out4["energy_history"].shape == (8, spec.n_outer + 1)
    # interval=4 -> 2 rounds -> 2 beta assignments (one swap between them).
    assert out1["betas_history"].shape[0] == spec.n_outer
    assert out4["betas_history"].shape[0] == 2
    for out in (out1, out4):
        b = out["betas"].reshape(2, 4)
        for g in range(2):
            np.testing.assert_allclose(np.sort(b[g]), np.sort(ladder))
        for r in range(8):
            assert out["final_energy"][r] == _oracle.board_energy(
                out["final_state"][r])


@pytest.mark.parametrize("mcmc_type", ["board", "full_3d"])
def test_tempered_sharded_matches_unsharded(mcmc_type):
    """The multi-device path: sharded carry, device-local ladder groups.

    Counter-based chain/swap streams make the result a pure function of the
    seeds, so the 8-device run must reproduce the single-device run bitwise
    on the real chains (the sharded run pads to whole ladder groups per
    device; group g's swap draws are keyed by g, not by the chain count).
    """
    from mcqueens.dist import mesh as mesh_mod

    mesh = mesh_mod.make_mesh()
    seeds = np.arange(8, dtype=np.uint32)
    kw = {"Q": 10, "N": 4} if mcmc_type == "full_3d" else {}
    spec = _spec(n_steps=200, history_stride=50, mcmc_type=mcmc_type, **kw)
    ladder = tempering.geometric_ladder(0.5, 3.0, 4)
    a = tempering.run_tempered(seeds, spec, ladder, swap_seed=3)
    b = tempering.run_tempered(seeds, spec, ladder, swap_seed=3, mesh=mesh)
    np.testing.assert_array_equal(a["energy_history"], b["energy_history"])
    np.testing.assert_array_equal(a["best_energy"], b["best_energy"])
    np.testing.assert_array_equal(a["best_state"], b["best_state"])
    np.testing.assert_array_equal(a["betas"], b["betas"])
    np.testing.assert_array_equal(a["final_state"], b["final_state"])


def test_tempered_checkpoint_resume_bitwise(tmp_path, monkeypatch):
    """A killed tempering search resumes bit-identically.

    Crash simulation: the segment call raises after 2 rounds; the rerun
    restores the round-2 checkpoint (carry + betas; the swap stream needs no
    saved RNG state — it is a pure function of (swap_seed, round)).
    """
    from mcqueens.chain import board
    from mcqueens.utils.checkpoint import Checkpointer

    seeds = np.arange(8, dtype=np.uint32)
    spec = _spec(n_steps=400, history_stride=50)
    ladder = tempering.geometric_ladder(0.3, 3.0, 4)

    want = tempering.run_tempered(seeds, spec, ladder, swap_seed=7,
                                  record_betas=True)

    ckpt = Checkpointer(str(tmp_path), tag="pt")
    real = board.run_segment
    calls = {"n": 0}

    def dying(*args, **kw):
        if calls["n"] >= 2:
            raise RuntimeError("simulated preemption")
        calls["n"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(board, "run_segment", dying)
    with pytest.raises(RuntimeError, match="preemption"):
        tempering.run_tempered(seeds, spec, ladder, swap_seed=7,
                               record_betas=True, checkpointer=ckpt)
    monkeypatch.setattr(board, "run_segment", real)
    got = tempering.run_tempered(seeds, spec, ladder, swap_seed=7,
                                 record_betas=True, checkpointer=ckpt)
    # A full resume (all rounds already checkpointed) must return the
    # complete beta history too, not crash or truncate it.
    again = tempering.run_tempered(seeds, spec, ladder, swap_seed=7,
                                   record_betas=True, checkpointer=ckpt)
    np.testing.assert_array_equal(want["energy_history"],
                                  got["energy_history"])
    np.testing.assert_array_equal(want["best_energy"], got["best_energy"])
    np.testing.assert_array_equal(want["best_state"], got["best_state"])
    np.testing.assert_array_equal(want["betas"], got["betas"])
    np.testing.assert_array_equal(want["final_state"], got["final_state"])
    np.testing.assert_array_equal(want["betas_history"],
                                  got["betas_history"])
    np.testing.assert_array_equal(want["betas_history"],
                                  again["betas_history"])

    # A fingerprint mismatch (different ladder) must NOT resume.
    other = tempering.geometric_ladder(0.2, 4.0, 4)
    fresh = tempering.run_tempered(seeds, spec, other, swap_seed=7,
                                   checkpointer=ckpt)
    plain = tempering.run_tempered(seeds, spec, other, swap_seed=7)
    np.testing.assert_array_equal(fresh["energy_history"],
                                  plain["energy_history"])


def test_tempered_full3d_invariants():
    """Tempering composes with the full_3d sampler too."""
    spec = ChainSpec(
        N=5,
        n_steps=300,
        schedule=build_schedule("constant", 300, beta_const=1.0),
        init_mode="random",
        mcmc_type="full_3d",
        kernel="tables",
        history_stride=50,
    )
    ladder = tempering.geometric_ladder(0.3, 3.0, 4)
    out = tempering.run_tempered(
        np.arange(8, dtype=np.uint32), spec, ladder, swap_seed=5,
        record_betas=True)
    for r in range(8):
        assert out["final_energy"][r] == _oracle.full3d_energy(
            out["final_state"][r])
        assert out["best_energy"][r] == _oracle.full3d_energy(
            out["best_state"][r])
        assert out["best_energy"][r] <= out["energy_history"][r].min()
        assert len({tuple(q) for q in out["final_state"][r].tolist()}) == 25
    b = out["betas"].reshape(2, 4)
    for g in range(2):
        np.testing.assert_allclose(np.sort(b[g]), np.sort(ladder))
    # Swaps happen (betas move between levels at least once).
    assert (out["betas_history"] != out["betas_history"][0]).any()
