"""Full-3D Metropolis sampler: Q queens at arbitrary distinct cube cells.

Reference algorithm (``experiments.py:199-279``): per step, pick a queen
uniformly, rejection-sample a uniform *unoccupied* cell, evaluate the delta
with two O(Q) one-vs-all scans, Metropolis-accept.

The design mirrors :mod:`mcqueens.chain.board` (fused scan, counter-based
keys, count-table O(1) delta-E, device-resident stats) with two differences:

  * state adds an occupancy bitmap (N^3 bools) replacing the reference's
    Python ``occ_set`` (``mcmc.py:113-118``) so the "unoccupied?" probe is a
    single load;
  * the proposal's rejection loop is a ``lax.while_loop`` (vectorizes under
    vmap: iterates until every chain has found a free cell — for Q = N^2 the
    occupancy fraction is 1/N, so the expected trip count is ~N/(N-1)).

The reference full_3d sampler accepts ``early_stop_patience`` but never uses
it (``experiments.py:199`` — known quirk, SURVEY §2.1); here patience works
identically to board mode when enabled, and the experiment runner leaves it
disabled for full_3d to preserve reference behavior.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from mcqueens.chain.spec import ChainSpec
from mcqueens.core import energy as energy_mod
from mcqueens.core import init as init_mod
from mcqueens.core import tables as tables_mod


class Full3DCarry(NamedTuple):
    """Per-chain sampler state (batched on axis 0 when vmapped)."""

    step_base: jax.Array
    queens: jax.Array           # (Q, 3) int32
    occ: jax.Array              # (N^3,) bool occupancy bitmap
    table: Optional[jax.Array]  # (T13,) int32 ("tables" kernel only)
    energy: jax.Array
    best_queens: jax.Array      # (Q, 3) int32
    best_energy: jax.Array
    best_step: jax.Array
    no_improve: jax.Array
    done: jax.Array
    stop_step: jax.Array
    accept_bins: jax.Array
    total_bins: jax.Array


def init_carry(chain_key, spec: ChainSpec, queens0=None) -> Full3DCarry:
    """``queens0`` warm-starts from explicit (Q, 3) positions (the reference's
    ``State3DQueens(positions=...)`` path, ``mcmc.py:106-111``)."""
    N, Q = spec.N, spec.q_eff
    init_key, step_base = jax.random.split(chain_key)
    if queens0 is None:
        queens, occ = init_mod.full3d_init(init_key, N, spec.init_mode, Q=Q)
    else:
        queens = jnp.asarray(queens0, jnp.int32)
        cells = queens[:, 0] * N * N + queens[:, 1] * N + queens[:, 2]
        occ = jnp.zeros((N * N * N,), bool).at[cells].set(True)
    table = tables_mod.build_full3d_table(queens, N)
    e0 = tables_mod.table_energy(table)
    if spec.kernel != "tables":
        table = None
    return Full3DCarry(
        step_base=step_base,
        queens=queens,
        occ=occ,
        table=table,
        energy=e0,
        best_queens=queens,
        best_energy=e0,
        best_step=jnp.int32(0),
        no_improve=jnp.int32(0),
        done=jnp.bool_(False),
        stop_step=jnp.int32(spec.n_steps),
        accept_bins=jnp.zeros((spec.n_bins,), jnp.int32),
        total_bins=jnp.zeros((spec.n_bins,), jnp.int32),
    )


def _draw_unoccupied(key, occ, N3: int):
    """Uniform cell over the complement of ``occ`` (exact rejection sampling).

    Same distribution as the reference's ``while pos in occ_set`` loop
    (``experiments.py:226-231``); vmap batches the while_loop across chains.
    """

    def fresh(k):
        k, sub = jax.random.split(k)
        return k, jax.random.randint(sub, (), 0, N3, dtype=jnp.int32)

    key, cell = fresh(key)

    def cond(state):
        _, c = state
        return occ[c]

    def body(state):
        k, _ = state
        return fresh(k)

    _, cell = lax.while_loop(cond, body, (key, cell))
    return cell


def _step(carry: Full3DCarry, step, spec: ChainSpec, scale=None) -> Full3DCarry:
    """One proposal; ``scale`` multiplies the scheduled beta (see board)."""
    N, Q = spec.N, spec.q_eff
    N3 = N * N * N
    key = jax.random.fold_in(carry.step_base, step)
    k_q, k_cell, k_u = jax.random.split(key, 3)

    q_idx = jax.random.randint(k_q, (), 0, Q, dtype=jnp.int32)
    old = carry.queens[q_idx]
    old_cell = old[0] * N * N + old[1] * N + old[2]
    new_cell = _draw_unoccupied(k_cell, carry.occ, N3)
    new = jnp.stack([new_cell // (N * N), (new_cell // N) % N, new_cell % N])

    if spec.kernel == "tables":
        d_e, idx_old, idx_new = tables_mod.full3d_delta_e(
            carry.table, (old[0], old[1], old[2]), (new[0], new[1], new[2]), N
        )
    else:
        d_e = energy_mod.full3d_conflicts(
            carry.queens, q_idx, (new[0], new[1], new[2])
        ) - energy_mod.full3d_conflicts(carry.queens, q_idx, (old[0], old[1], old[2]))

    beta = spec.schedule(step)
    if scale is not None:
        beta = beta * scale
    accept = jax.random.uniform(k_u) < jnp.exp(-beta * d_e.astype(jnp.float32))

    active = jnp.logical_and(~carry.done, step < spec.n_steps)
    upd = jnp.logical_and(accept, active)

    queens = carry.queens.at[q_idx].set(jnp.where(upd, new, old))
    occ = carry.occ.at[old_cell].set(jnp.logical_and(carry.occ[old_cell], ~upd))
    occ = occ.at[new_cell].set(jnp.logical_or(occ[new_cell], upd))
    table = carry.table
    if spec.kernel == "tables":
        table = tables_mod.apply_move(table, idx_old, idx_new, upd)
    new_energy = carry.energy + jnp.where(upd, d_e, 0).astype(jnp.int32)

    improved = jnp.logical_and(upd, new_energy < carry.best_energy)
    best_queens = jnp.where(improved, queens, carry.best_queens)
    best_energy = jnp.where(improved, new_energy, carry.best_energy)
    best_step = jnp.where(improved, step + 1, carry.best_step)

    no_improve = jnp.where(
        active, jnp.where(improved, 0, carry.no_improve + 1), carry.no_improve
    )
    if spec.early_stop_patience is not None:
        newly_done = jnp.logical_and(active, no_improve >= spec.early_stop_patience)
        done = jnp.logical_or(carry.done, newly_done)
        stop_step = jnp.where(newly_done, step, carry.stop_step)
    else:
        done = carry.done
        stop_step = carry.stop_step

    b = jnp.minimum(step * spec.n_bins // spec.n_steps, spec.n_bins - 1)
    inc = active.astype(jnp.int32)
    accept_bins = carry.accept_bins.at[b].add(inc * accept.astype(jnp.int32))
    total_bins = carry.total_bins.at[b].add(inc)

    return Full3DCarry(
        step_base=carry.step_base,
        queens=queens,
        occ=occ,
        table=table,
        energy=new_energy,
        best_queens=best_queens,
        best_energy=best_energy,
        best_step=best_step,
        no_improve=no_improve,
        done=done,
        stop_step=stop_step,
        accept_bins=accept_bins,
        total_bins=total_bins,
    )


@functools.partial(jax.jit, static_argnames=("spec", "n_outer"))
def run_segment(carry: Full3DCarry, start_outer, spec: ChainSpec, n_outer: int,
                beta_scale=None):
    """Advance by ``n_outer`` history chunks of ``history_stride`` steps each.

    ``beta_scale``: optional (C,) per-chain beta multiplier, as in
    :func:`mcqueens.chain.board.run_segment`.
    """
    stride = spec.history_stride
    step_batched = jax.vmap(lambda c, s, b: _step(c, s, spec, b),
                            in_axes=(0, None, 0))

    def chunk(c, outer_idx):
        def inner(r, cc):
            return step_batched(cc, outer_idx * stride + r, beta_scale)

        c = lax.fori_loop(0, stride, inner, c)
        return c, c.energy

    return lax.scan(chunk, carry, start_outer + jnp.arange(n_outer))


@functools.partial(jax.jit, static_argnames=("spec",))
def init_carry_batch(keys, spec: ChainSpec, initial_states=None) -> Full3DCarry:
    """Batched carry: one chain per key; optional (C, Q, 3) warm starts."""
    if initial_states is None:
        return jax.vmap(lambda k: init_carry(k, spec))(keys)
    return jax.vmap(lambda k, q: init_carry(k, spec, q))(keys, initial_states)
