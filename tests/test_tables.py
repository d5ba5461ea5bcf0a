"""Count-table kernel tests: table energy == oracle, delta-E == recompute diff."""

import functools

import jax
import numpy as np
import pytest

from mcqueens.core import energy, tables
from tests import _oracle


@functools.partial(jax.jit, static_argnames=("N",))
def _board_move(table, i, j, old_k, new_k, N, accept):
    d, idx_old, idx_new = tables.board_delta_e(table, i, j, old_k, new_k, N)
    return d, tables.apply_move(table, idx_old, idx_new, accept)


def jnp_arr(p):
    return np.asarray(p, np.int32)


@functools.partial(jax.jit, static_argnames=("N",))
def _full3d_move(table, old, new, N):
    d, idx_old, idx_new = tables.full3d_delta_e(table, old, new, N)
    return d, tables.apply_move(table, idx_old, idx_new, True)


@pytest.mark.parametrize("N", [2, 3, 5, 6, 9])
def test_board_table_energy_equals_oracle(N):
    rng = np.random.default_rng(N)
    for _ in range(4):
        h = _oracle.random_board(rng, N)
        t = tables.build_board_table(h)
        assert int(tables.table_energy(t)) == _oracle.board_energy(h)


@pytest.mark.parametrize("N,Q", [(3, 9), (4, 16), (5, 25), (6, 20)])
def test_full3d_table_energy_equals_oracle(N, Q):
    rng = np.random.default_rng(N * 7 + Q)
    for _ in range(4):
        q = _oracle.random_full3d(rng, N, Q)
        t = tables.build_full3d_table(q, N)
        assert int(tables.table_energy(t)) == _oracle.full3d_energy(q)


@pytest.mark.parametrize("N", [3, 5, 8])
def test_board_delta_e_equals_full_recompute(N):
    """The key hot-path identity: table delta == oracle energy difference."""
    rng = np.random.default_rng(N + 42)
    h = _oracle.random_board(rng, N)
    t = tables.build_board_table(h)
    for _ in range(30):
        i, j = rng.integers(0, N, size=2)
        old_k = int(h[i, j])
        new_k = int((old_k + 1 + rng.integers(0, N - 1)) % N)
        d, t = _board_move(t, i, j, old_k, new_k, N, True)
        e_before = _oracle.board_energy(h)
        h2 = h.copy()
        h2[i, j] = new_k
        e_after = _oracle.board_energy(h2)
        assert int(d) == e_after - e_before, (N, i, j, old_k, new_k)
        h = h2
        assert int(tables.table_energy(t)) == e_after


def test_board_apply_move_reject_is_noop():
    rng = np.random.default_rng(0)
    h = _oracle.random_board(rng, 5)
    t = tables.build_board_table(h)
    _, idx_old, idx_new = tables.board_delta_e(t, 1, 2, int(h[1, 2]), (int(h[1, 2]) + 1) % 5, 5)
    t2 = tables.apply_move(t, idx_old, idx_new, False)
    np.testing.assert_array_equal(np.asarray(t), np.asarray(t2))


@pytest.mark.parametrize("N,Q", [(4, 16), (5, 25), (6, 18)])
def test_full3d_delta_e_equals_full_recompute(N, Q):
    rng = np.random.default_rng(N * 3 + Q)
    queens = _oracle.random_full3d(rng, N, Q)
    t = tables.build_full3d_table(queens, N)
    occ = set(map(tuple, queens.tolist()))
    for _ in range(30):
        q_idx = int(rng.integers(0, Q))
        while True:
            new = tuple(int(x) for x in rng.integers(0, N, size=3))
            if new not in occ:
                break
        old = tuple(int(x) for x in queens[q_idx])
        d, t = _full3d_move(t, jnp_arr(old), jnp_arr(new), N)
        e_before = _oracle.full3d_energy(queens)
        q2 = queens.copy()
        q2[q_idx] = new
        e_after = _oracle.full3d_energy(q2)
        assert int(d) == e_after - e_before, (old, new)
        occ.remove(old)
        occ.add(new)
        queens = q2
        assert int(tables.table_energy(t)) == e_after


def test_line_indices_within_bounds_and_family_ranges():
    for N in (2, 4, 7):
        offs = np.array(tables.family_offsets(N, full3d=True))
        sizes = np.array(tables.family_sizes(N, full3d=True))
        cells = np.indices((N, N, N)).reshape(3, -1)
        idx = np.asarray(
            tables.line_indices(cells[0], cells[1], cells[2], N, full3d=True)
        )
        assert idx.shape == (N ** 3, 13)
        assert np.all(idx >= offs[None, :])
        assert np.all(idx < (offs + sizes)[None, :])


def test_vmapped_table_energy_matches_oracle():
    """A batched (vmapped) table build scores every board like the oracle."""
    rng = np.random.default_rng(7)
    N = 6
    boards = rng.integers(0, N, size=(37, N, N)).astype(np.int32)

    def efn(h):
        return tables.table_energy(tables.build_board_table(h))

    direct = np.asarray(jax.vmap(efn)(boards))
    want = np.array([_oracle.board_energy(b) for b in boards])
    np.testing.assert_array_equal(direct, want)
