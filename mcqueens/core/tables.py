"""Line-family count tables: O(1) incremental energy for the Metropolis chain.

Key algebraic fact (verified by case analysis and by the exhaustive tests in
``tests/test_tables.py``): for *distinct cells*, the reference's 7 attack
predicates (:mod:`mcqueens.core.energy`) are **mutually exclusive** — a pair of
queens attacks through exactly one relation.  Every relation corresponds to a
family of parallel lines through the cube, so

    E = sum over families f, lines l of C(count_f[l], 2)

and the conflicts of a position are a sum of 12 (board) / 13 (full_3d) table
lookups.  A single-queen move updates 24/26 table entries.  This replaces the
reference's O(N^2) one-vs-all rescan per proposal (``mcmc_board.py:147-193``)
with ~24 gathers + scatters inside a compiled ``lax.scan``.

Families and their line keys (D = 2N-1):

    ik      same_ik        (i, k)                       N*N
    jk      same_jk        (j, k)                       N*N
    k_dm    plane_k_diag   (k, i-j)   direction (1, 1)  N*D
    k_dp    plane_k_diag   (k, i+j)   direction (1,-1)  N*D
    j_dm    plane_j_diag   (j, i-k)                     N*D
    j_dp    plane_j_diag   (j, i+k)                     N*D
    i_dm    plane_i_diag   (i, j-k)                     N*D
    i_dp    plane_i_diag   (i, j+k)                     N*D
    s_mm    space_diag     (j-i, k-i) direction (1, 1, 1)   D*D
    s_mp    space_diag     (j-i, k+i) direction (1, 1,-1)   D*D
    s_pm    space_diag     (j+i, k-i) direction (1,-1, 1)   D*D
    s_pp    space_diag     (j+i, k+i) direction (1,-1,-1)   D*D
    ij      same_ij        (i, j)     [full_3d only]        N*N

All 12 board families are a prefix of the 13 full_3d families, so board code
and full_3d code share one layout.  Per chain the flat table is
``2N^2 + 6N(2N-1) + 4(2N-1)^2`` int32s (~29 KB at N=16) — cheap to vmap over
thousands of chains.
"""

from __future__ import annotations

import jax.numpy as jnp

N_BOARD_FAMILIES = 12
N_FULL_FAMILIES = 13


def family_sizes(N: int, full3d: bool = False):
    """Flat size of each family's count table."""
    D = 2 * N - 1
    sizes = [N * N, N * N] + [N * D] * 6 + [D * D] * 4
    if full3d:
        sizes.append(N * N)
    return sizes


def family_offsets(N: int, full3d: bool = False):
    """Start offset of each family within the flat table."""
    sizes = family_sizes(N, full3d)
    offs = [0]
    for s in sizes[:-1]:
        offs.append(offs[-1] + s)
    return offs


def table_size(N: int, full3d: bool = False) -> int:
    sizes = family_sizes(N, full3d)
    return sum(sizes)


def line_indices(i, j, k, N: int, full3d: bool = False):
    """Flat table indices of the 12 (13) lines through cell (i, j, k).

    ``i, j, k`` may be scalars or equally-shaped arrays; the family axis is
    appended last.  Pure jnp — traced inside the chain step.
    """
    D = 2 * N - 1
    offs = family_offsets(N, full3d)
    i = jnp.asarray(i, jnp.int32)
    j = jnp.asarray(j, jnp.int32)
    k = jnp.asarray(k, jnp.int32)
    idx = [
        offs[0] + i * N + k,                       # ik
        offs[1] + j * N + k,                       # jk
        offs[2] + k * D + (i - j + N - 1),         # k_dm
        offs[3] + k * D + (i + j),                 # k_dp
        offs[4] + j * D + (i - k + N - 1),         # j_dm
        offs[5] + j * D + (i + k),                 # j_dp
        offs[6] + i * D + (j - k + N - 1),         # i_dm
        offs[7] + i * D + (j + k),                 # i_dp
        offs[8] + (j - i + N - 1) * D + (k - i + N - 1),   # s_mm
        offs[9] + (j - i + N - 1) * D + (k + i),           # s_mp
        offs[10] + (j + i) * D + (k - i + N - 1),          # s_pm
        offs[11] + (j + i) * D + (k + i),                  # s_pp
    ]
    if full3d:
        idx.append(offs[12] + i * N + j)           # ij
    return jnp.stack(idx, axis=-1)


# ---------------------------------------------------------------------------
# Table construction + whole-table energy (used at chain init and in tests).
# ---------------------------------------------------------------------------


def build_board_table(heights):
    """Count table of a board state (one queen per (i, j) at heights[i, j])."""
    N = heights.shape[-1]
    ii = jnp.arange(N, dtype=jnp.int32)
    i_g, j_g = jnp.meshgrid(ii, ii, indexing="ij")
    idx = line_indices(
        i_g.reshape(-1), j_g.reshape(-1), heights.reshape(-1).astype(jnp.int32), N
    )
    table = jnp.zeros((table_size(N),), jnp.int32)
    return table.at[idx.reshape(-1)].add(1)


def build_full3d_table(queens, N: int):
    """Count table of a full-3D state (queens: (Q, 3) distinct cells)."""
    q = queens.astype(jnp.int32)
    idx = line_indices(q[:, 0], q[:, 1], q[:, 2], N, full3d=True)
    table = jnp.zeros((table_size(N, full3d=True),), jnp.int32)
    return table.at[idx.reshape(-1)].add(1)


def table_energy(table):
    """E = sum over lines of C(count, 2).  Equals the pairwise oracle energy."""
    t = table.astype(jnp.int32)
    return jnp.sum(t * (t - 1) // 2, dtype=jnp.int32)


# ---------------------------------------------------------------------------
# Incremental conflict evaluation (the hot-path primitives).
# ---------------------------------------------------------------------------


def board_delta_e(table, i, j, old_k, new_k, N: int):
    """Energy delta for moving the (i, j) queen from old_k to new_k != old_k.

    old_conflicts = sum_f count[l_f(old)] - 12   (the queen sits on all 12 of
    its own lines); new_conflicts = sum_f count[l_f(new)] (a queen at the same
    (i, j) with a different height shares none of the 12 lines).  Matches the
    reference's ``conflicts_for_position`` difference (``experiments.py:315-323``).
    """
    idx_old = line_indices(i, j, old_k, N)
    idx_new = line_indices(i, j, new_k, N)
    old_sum = jnp.sum(table[idx_old], dtype=jnp.int32)
    new_sum = jnp.sum(table[idx_new], dtype=jnp.int32)
    return new_sum - (old_sum - N_BOARD_FAMILIES), idx_old, idx_new


def apply_move(table, idx_old, idx_new, accept):
    """Move the queen's 12/13 line memberships; no-op when accept is False.

    The scatter indices of old and new may overlap in full_3d mode (when the
    old cell attacks the new cell); ``.at[].add`` accumulates, so the net
    update is still correct.
    """
    d = jnp.where(accept, 1, 0).astype(jnp.int32)
    return table.at[idx_old].add(-d).at[idx_new].add(d)


def full3d_delta_e(table, old_pos, new_pos, N: int):
    """Energy delta for moving a queen from old_pos to a distinct new_pos.

    new_conflicts excludes the moving queen itself, which still sits at
    old_pos — it contributes to the new position's line counts exactly when
    old attacks new (one shared line, by mutual exclusivity).  Matches
    ``mcmc.py:185-226`` evaluated at pos=new with the mover masked.
    """
    from mcqueens.core.energy import attacks

    io, jo, ko = old_pos
    inw, jnw, knw = new_pos
    idx_old = line_indices(io, jo, ko, N, full3d=True)
    idx_new = line_indices(inw, jnw, knw, N, full3d=True)
    old_sum = jnp.sum(table[idx_old], dtype=jnp.int32)
    new_sum = jnp.sum(table[idx_new], dtype=jnp.int32)
    old_attacks_new = attacks(
        (jnp.int32(io), jnp.int32(jo), jnp.int32(ko)),
        (jnp.int32(inw), jnp.int32(jnw), jnp.int32(knw)),
        board_mode=False,
    ).astype(jnp.int32)
    old_conf = old_sum - N_FULL_FAMILIES
    new_conf = new_sum - old_attacks_new
    return new_conf - old_conf, idx_old, idx_new
