"""Boltzmann stationarity for the full_3d samplers, both kernels.

Here the state space is enumerable (N=3, Q=2: C(27,2)=351 states,
energy 0 or 1; P_boltz(E=1|beta=1) = 0.346 vs P_unif = 0.590, so the test has
power against a broken accept path or a biased proposal).
"""

import itertools
import math

import numpy as np
import pytest

from mcqueens.chain.spec import ChainSpec
from mcqueens.core.schedules import build_schedule
from mcqueens.dist import runner
from tests import _oracle


def _exact_p1(beta: float):
    cells = list(itertools.product(range(3), repeat=3))
    n_att = 0
    tot = 0
    for a, b in itertools.combinations(cells, 2):
        tot += 1
        n_att += _oracle.full3d_energy(np.array([a, b])) >= 1
    w1 = n_att * math.exp(-beta)
    w0 = tot - n_att
    return w1 / (w0 + w1), n_att / tot


@pytest.mark.parametrize("kernel", ["tables", "naive"])
def test_full3d_samples_boltzmann_distribution(kernel):
    N, Q, beta, n_steps, stride = 3, 2, 1.0, 12000, 50
    spec = ChainSpec(
        N=N,
        n_steps=n_steps,
        Q=Q,
        schedule=build_schedule("constant", n_steps, beta_const=beta),
        init_mode="random",
        mcmc_type="full_3d",
        kernel=kernel,
        history_stride=stride,
    )
    res = runner.run_chains(5 + np.arange(16, dtype=np.uint32), spec)

    p1, p1_unif = _exact_p1(beta)
    burn_points = 2000 // stride
    samples = res.energy_history[:, burn_points:].reshape(-1)
    assert set(np.unique(samples)) <= {0, 1}
    emp = (samples == 1).mean()
    tol = 0.03
    assert abs(emp - p1) < tol, (emp, p1)
    # Power guard: a uniform (always-accept) sampler must fail the above.
    assert abs(p1_unif - p1) > 2 * tol
