"""The served path: per-chain beta scales and oracle-exact energies.

Every user path (run_chains, run_tempered, the CLIs) runs on the XLA
``tables``/``naive`` samplers.  These tests pin down

  * the per-chain ``beta_scale`` row of ``run_segment``: a row of ones is
    bitwise the untempered run, and a scale multiplies the schedule exactly;
  * oracle equality of the incremental energies on the served path across
    mcmc_type x kernel x init x warm start x Q < N^2;
  * the batch padding and warm-start validation the runner applies.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from mcqueens.chain import board, full3d
from mcqueens.chain.spec import ChainSpec
from mcqueens.core import rng as rng_mod
from mcqueens.core.schedules import build_schedule
from mcqueens.dist import mesh as mesh_mod
from mcqueens.dist import runner
from mcqueens.search import tempering
from tests import _oracle

_MODS = {"board": board, "full_3d": full3d}


def _spec(mcmc_type="board", kernel="tables", n_steps=120, stride=30, **kw):
    defaults = dict(
        N=5 if mcmc_type == "board" else 4,
        n_steps=n_steps,
        schedule=build_schedule("linear_annealing", n_steps,
                                beta_start=0.5, beta_end=3.0),
        init_mode="random", mcmc_type=mcmc_type, kernel=kernel,
        history_stride=stride,
    )
    defaults.update(kw)
    return ChainSpec(**defaults)


def _segment(spec, C=6, beta_scale=None, seed=3):
    mod = _MODS[spec.mcmc_type]
    keys = rng_mod.chain_keys_from_seeds(seed + np.arange(C, dtype=np.uint32))
    carry = mod.init_carry_batch(keys, spec)
    return mod.run_segment(carry, np.int32(0), spec, spec.n_outer, beta_scale)


def _assert_trees_equal(a, b):
    (ca, ya), (cb, yb) = a, b
    np.testing.assert_array_equal(np.asarray(ya), np.asarray(yb))
    for name in ca._fields:
        x, y = getattr(ca, name), getattr(cb, name)
        if x is None:
            assert y is None
            continue
        if name == "step_base":
            continue  # typed keys; identical by construction
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# beta_scale
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride", [1, 30])
@pytest.mark.parametrize("kernel", ["tables", "naive"])
@pytest.mark.parametrize("mcmc_type", ["board", "full_3d"])
def test_beta_scale_of_ones_is_bitwise_untempered(mcmc_type, kernel, stride):
    spec = _spec(mcmc_type, kernel, n_steps=60, stride=stride)
    plain = _segment(spec)
    ones = _segment(spec, beta_scale=jnp.ones((6,), jnp.float32))
    _assert_trees_equal(plain, ones)


@pytest.mark.parametrize("mcmc_type", ["board", "full_3d"])
def test_beta_scale_multiplies_the_schedule(mcmc_type):
    """Constant beta 1 scaled by 2.5 is bitwise constant beta 2.5."""
    sched = dict(n_steps=90, stride=30)
    scaled = _spec(mcmc_type, schedule=build_schedule("constant", 90,
                                                      beta_const=1.0), **sched)
    direct = _spec(mcmc_type, schedule=build_schedule("constant", 90,
                                                      beta_const=2.5), **sched)
    a = _segment(scaled, beta_scale=jnp.full((6,), 2.5, jnp.float32))
    b = _segment(direct)
    _assert_trees_equal(a, b)


@pytest.mark.parametrize("mcmc_type", ["board", "full_3d"])
def test_beta_scale_is_per_chain(mcmc_type):
    """Each chain sees only its own scale: a mixed row equals, chain by
    chain, the runs with that chain's scale everywhere."""
    spec = _spec(mcmc_type, n_steps=90, stride=30)
    row = jnp.asarray([0.2, 5.0, 0.2, 5.0, 1.0, 1.0], jnp.float32)
    mixed_c, mixed_y = _segment(spec, beta_scale=row)
    for s in (0.2, 5.0, 1.0):
        c, y = _segment(spec, beta_scale=jnp.full((6,), s, jnp.float32))
        sel = np.asarray(row) == s
        np.testing.assert_array_equal(np.asarray(mixed_y)[:, sel],
                                      np.asarray(y)[:, sel])
        np.testing.assert_array_equal(np.asarray(mixed_c.energy)[sel],
                                      np.asarray(c.energy)[sel])
    # and the scales matter: cold and hot chains do not share trajectories
    hot, _ = _segment(spec, beta_scale=jnp.full((6,), 0.2, jnp.float32))
    cold, _ = _segment(spec, beta_scale=jnp.full((6,), 5.0, jnp.float32))
    assert not np.array_equal(np.asarray(hot.energy), np.asarray(cold.energy))


# ---------------------------------------------------------------------------
# Oracle equality on the served path
# ---------------------------------------------------------------------------

_CASES = []
for _kernel in ("tables", "naive"):
    for _init in ("random", "latin", "klarner"):
        _CASES.append(("board", _kernel, _init, False, None))
        _CASES.append(("full_3d", _kernel, _init, False, None))
    _CASES.append(("board", _kernel, "random", True, None))
    _CASES.append(("full_3d", _kernel, "random", True, None))
    _CASES.append(("full_3d", _kernel, "random", False, 9))
    _CASES.append(("full_3d", _kernel, "random", True, 9))


def _warm_states(mcmc_type, N, Q, n, seed=5):
    rng = np.random.default_rng(seed)
    if mcmc_type == "board":
        return rng.integers(0, N, size=(n, N, N))
    return np.stack([_oracle.random_full3d(rng, N, Q) for _ in range(n)])


@pytest.mark.parametrize("mcmc_type,kernel,init,warm,Q", _CASES)
def test_served_energies_equal_the_oracle(mcmc_type, kernel, init, warm, Q):
    spec = _spec(mcmc_type, kernel, init_mode=init, Q=Q)
    n = 3
    init_states = (_warm_states(mcmc_type, spec.N, spec.q_eff, n)
                   if warm else None)
    res = runner.run_chains(11 + np.arange(n, dtype=np.uint32), spec,
                            initial_states=init_states)
    fn = _oracle.board_energy if mcmc_type == "board" else _oracle.full3d_energy
    for r in range(n):
        assert res.final_energy[r] == fn(res.final_state[r])
        assert res.best_energy[r] == fn(res.best_state[r])
        assert res.energy_history[r, -1] == res.final_energy[r]
        assert res.best_energy[r] == res.energy_history[r].min()
        if warm:
            assert res.energy_history[r, 0] == fn(init_states[r])
    assert res.proposals == n * spec.n_steps
    assert res.setup_time >= 0 and res.n_devices == 1


@pytest.mark.parametrize("kernel", ["tables", "naive"])
@pytest.mark.parametrize("mcmc_type", ["board", "full_3d"])
def test_tempered_energies_equal_the_oracle(mcmc_type, kernel):
    spec = _spec(mcmc_type, kernel,
                 schedule=build_schedule("constant", 120, beta_const=1.0))
    ladder = tempering.geometric_ladder(0.3, 3.0, 3)
    out = tempering.run_tempered(np.arange(6, dtype=np.uint32), spec, ladder,
                                 swap_seed=4)
    fn = _oracle.board_energy if mcmc_type == "board" else _oracle.full3d_energy
    for r in range(6):
        assert out["final_energy"][r] == fn(out["final_state"][r])
        assert out["best_energy"][r] == fn(out["best_state"][r])
    assert out["n_devices"] == 1 and out["setup_time"] >= 0


def test_mesh_run_reports_its_device_span():
    mesh = mesh_mod.make_mesh()
    res = runner.run_chains(np.arange(8, dtype=np.uint32), _spec(), mesh=mesh)
    assert res.n_devices == mesh.devices.size == 8


# ---------------------------------------------------------------------------
# Padding and warm-start validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,group,want", [
    (8, 1, 8), (9, 1, 16), (8, 4, 32), (33, 4, 64),
])
def test_pad_chains_gives_whole_groups_per_device(n, group, want):
    mesh = mesh_mod.make_mesh()  # 8 CPU devices
    got = mesh_mod.pad_chains(n, mesh, group)
    assert got == want
    assert (got // 8) % group == 0
    assert mesh_mod.pad_chains(n, None, group) == n


def test_pad_runs_extends_seeds_and_warm_starts():
    seeds = np.asarray([5, 9, 2], np.uint32)
    states = np.arange(3 * 4).reshape(3, 2, 2)
    s, st = runner.pad_runs(seeds, states, 6)
    np.testing.assert_array_equal(s, [5, 9, 2, 3, 4, 5])
    assert st.shape == (6, 2, 2)
    np.testing.assert_array_equal(st[3:], np.repeat(states[-1:], 3, axis=0))
    s2, st2 = runner.pad_runs(seeds, None, 3)
    assert s2 is seeds and st2 is None


def test_validate_initial_states_rejects_shared_cells():
    spec = _spec("full_3d", Q=3)
    ok = np.asarray([[[0, 0, 0], [1, 2, 3], [3, 3, 3]]])
    runner.validate_initial_states(ok, spec, 1)
    dup = np.asarray([[[0, 0, 0], [1, 2, 3], [0, 0, 0]]])
    with pytest.raises(ValueError, match="same"):
        runner.validate_initial_states(np.concatenate([ok, dup]), spec, 2)


def test_validate_initial_states_checks_ranges_and_shapes():
    spec = _spec("board")
    with pytest.raises(ValueError, match="shape"):
        runner.validate_initial_states(np.zeros((2, 5, 4)), spec, 2)
    with pytest.raises(ValueError, match="heights"):
        runner.validate_initial_states(np.full((1, 5, 5), 5), spec, 1)
    fspec = dataclasses.replace(spec, mcmc_type="full_3d", N=4, Q=2)
    with pytest.raises(ValueError, match="coordinates"):
        runner.validate_initial_states(
            np.asarray([[[0, 0, 0], [4, 0, 0]]]), fspec, 1)
