"""Stats helpers, Q != N^2 full_3d support, and spec validation paths."""

import numpy as np
import pytest

from mcqueens.chain import stats
from mcqueens.chain.spec import ChainSpec
from mcqueens.core.schedules import build_schedule
from mcqueens.dist import runner
from tests import _oracle


def test_acceptance_rate_bins_pools_runs_and_nans_empty():
    acc = np.array([[1, 0, 3], [1, 0, 1]])
    tot = np.array([[2, 0, 4], [2, 0, 2]])
    rate = stats.acceptance_rate_bins(acc, tot)
    assert rate[0] == pytest.approx(0.5)
    assert np.isnan(rate[1])
    assert rate[2] == pytest.approx(4 / 6)


def test_bin_centers_match_linspace_midpoints():
    c = stats.bin_centers(1000, 4)
    np.testing.assert_allclose(c, [125.0, 375.0, 625.0, 875.0])


def test_energy_curve_stats_population_std():
    h = np.array([[1.0, 3.0], [3.0, 5.0]])
    mean, std = stats.energy_curve_stats(h)
    np.testing.assert_allclose(mean, [2.0, 4.0])
    np.testing.assert_allclose(std, [1.0, 1.0])  # ddof=0, like the reference


def test_energy_curve_stats_masked_truncation():
    """With lens, early-stopped runs contribute only their prefix
    (reference break-before-append, ``experiments.py:349-355``) and the
    curve ends at the longest surviving run."""
    h = np.array([
        [4.0, 2.0, 2.0, 2.0],   # stopped after 2 points: tail is frozen
        [6.0, 4.0, 2.0, 2.0],   # alive for 3 points
        [8.0, 6.0, 4.0, 4.0],   # never stopped -- but history has 4 points
    ])
    lens = np.array([2, 3, 4])
    mean, std = stats.energy_curve_stats(h, lens)
    assert mean.shape == (4,)
    np.testing.assert_allclose(mean, [6.0, 4.0, 3.0, 4.0])
    np.testing.assert_allclose(std[2], 1.0)  # two alive runs: 2, 4
    np.testing.assert_allclose(std[3], 0.0)  # single survivor
    # frozen-tail divergence: the unmasked mean at the last point (8/3) is
    # NOT what masked aggregation reports
    assert mean[3] != pytest.approx(h[:, 3].mean())
    # full-length lens == plain aggregation
    m2, s2 = stats.energy_curve_stats(h, np.array([4, 4, 4]))
    np.testing.assert_allclose(m2, h.mean(axis=0))
    np.testing.assert_allclose(s2, h.std(axis=0))


@pytest.mark.parametrize("kernel", ["tables", "naive"])
def test_full3d_with_custom_queen_count(kernel):
    """Q != N^2: the reference's mcmc.py Q parameter (``mcmc.py:6``)."""
    spec = ChainSpec(
        N=4, n_steps=600, Q=10,
        schedule=build_schedule("linear_annealing", 600, beta_start=0.5,
                                beta_end=4.0),
        init_mode="random", mcmc_type="full_3d", kernel=kernel,
    )
    res = runner.run_chains(np.arange(2, dtype=np.uint32), spec)
    for r in range(2):
        assert res.final_state[r].shape == (10, 3)
        assert res.final_energy[r] == _oracle.full3d_energy(res.final_state[r])
        cells = {tuple(q) for q in res.final_state[r].tolist()}
        assert len(cells) == 10
    # 10 queens in a 4-cube can reach zero attacking pairs sometimes; at
    # minimum annealing must improve on the random start.
    assert (res.best_energy <= res.energy_history[:, 0]).all()


def test_full3d_naive_with_custom_queen_count():
    spec = ChainSpec(
        N=4, n_steps=300, Q=10,
        schedule=build_schedule("linear_annealing", 300, beta_start=0.5,
                                beta_end=4.0),
        init_mode="random", mcmc_type="full_3d", kernel="naive",
        history_stride=50,
    )
    res = runner.run_chains(np.arange(2, dtype=np.uint32), spec)
    for r in range(2):
        assert res.final_energy[r] == _oracle.full3d_energy(res.final_state[r])
        cells = {tuple(q) for q in res.final_state[r].tolist()}
        assert len(cells) == 10


def test_spec_validation_errors():
    sched = build_schedule("constant", 10, beta_const=1.0)
    with pytest.raises(ValueError, match="Unknown kernel"):
        ChainSpec(N=4, n_steps=10, schedule=sched, kernel="cuda")
    with pytest.raises(ValueError, match="Unknown mcmc_type"):
        ChainSpec(N=4, n_steps=10, schedule=sched, mcmc_type="2d")
    with pytest.raises(ValueError, match="history_stride"):
        ChainSpec(N=4, n_steps=10, schedule=sched, history_stride=0)
    with pytest.raises(ValueError, match="int32"):
        ChainSpec(N=4, n_steps=2 ** 26, schedule=sched, n_bins=100)
    with pytest.raises(ValueError, match="N must be"):
        ChainSpec(N=1, n_steps=10, schedule=sched)
    # A free cell must exist for the full_3d move proposal (any kernel);
    # any Q < N^3 is accepted.
    with pytest.raises(ValueError, match="free cell"):
        ChainSpec(N=3, n_steps=10, schedule=sched, mcmc_type="full_3d",
                  Q=27)
    ChainSpec(N=3, n_steps=10, schedule=sched, mcmc_type="full_3d",
              kernel="naive", Q=26)  # occupancy ~0.96: accepted
    # Removed kernel names say why they are gone.
    for kernel in ("pallas", "pallas_shared"):
        with pytest.raises(ValueError, match="was removed"):
            ChainSpec(N=4, n_steps=10, schedule=sched, kernel=kernel)
