"""Board-constrained Metropolis sampler as one fused, compiled scan.

Reference algorithm (``experiments.py:282-376``): per step, pick a column
(i, j) uniformly, resample its height to new_k != old_k, evaluate the energy
delta with two O(N^2) one-vs-all conflict scans, accept with probability
min(1, exp(-beta * dE)), track best state and (optionally) early-stop after
``patience`` steps without a new best.

Design:
  * the whole chain is a ``lax.scan`` over steps — one compiled program, no
    Python in the loop;
  * delta-E is O(1): 24 gathers into the line-family count table
    (:mod:`mcqueens.core.tables`) instead of the O(N^2) rescan;
  * proposals use counter-based keys (``fold_in(chain_key, step)``) — no
    sequential RNG state, and the data-dependent "resample until != old_k"
    loop becomes the exact modular shift ``new_k = (old_k + 1 + U{0..N-2}) % N``;
  * early stopping becomes a ``done`` flag that freezes the carry (fixed
    shapes; the reference's truncated history is recovered from ``stop_step``);
  * statistics (energy history, 100-bin acceptance counters, best tracking)
    accumulate on device — per-step accept/reject index lists are never
    materialized (SURVEY §5.5);
  * thousands of chains vmap into one program; the chains axis shards over a
    device mesh (:mod:`mcqueens.dist.mesh`).
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


class BoardCarry(NamedTuple):
    """Per-chain sampler state (batched on axis 0 when vmapped)."""

    step_base: jax.Array        # PRNG key deriving all per-step draws
    heights: jax.Array          # (N*N,) int32 flat board
    table: Optional[jax.Array]  # (T,) int32 line counts ("tables" kernel only)
    energy: jax.Array           # () int32 current energy
    best_heights: jax.Array     # (N*N,) int32
    best_energy: jax.Array      # () int32
    best_step: jax.Array        # () int32: history index of first minimum
    no_improve: jax.Array       # () int32 steps since last new best
    done: jax.Array             # () bool: early-stopped (frozen)
    stop_step: jax.Array        # () int32: step at which the chain stopped
    accept_bins: jax.Array      # (n_bins,) int32
    total_bins: jax.Array       # (n_bins,) int32


def init_carry(chain_key, spec: ChainSpec, heights0=None) -> BoardCarry:
    """Single-chain carry from a chain key (vmap over keys for a batch).

    ``heights0`` warm-starts the chain from an explicit (N, N) board instead
    of ``spec.init_mode`` — the reference's explicit-state constructor path
    (``mcmc_board.py:60-66``); validation happens in the runner.
    """
    N = spec.N
    init_key, step_base = jax.random.split(chain_key)
    if heights0 is None:
        heights = init_mod.board_init(init_key, N, spec.init_mode).reshape(-1)
    else:
        heights = jnp.asarray(heights0, jnp.int32).reshape(-1)
    table = tables_mod.build_board_table(heights.reshape(N, N))
    e0 = tables_mod.table_energy(table)
    if spec.kernel != "tables":
        table = None
    return BoardCarry(
        step_base=step_base,
        heights=heights,
        table=table,
        energy=e0,
        best_heights=heights,
        best_energy=e0,
        best_step=jnp.int32(0),
        no_improve=jnp.int32(0),
        done=jnp.bool_(False),
        stop_step=jnp.int32(spec.n_steps),
        accept_bins=jnp.zeros((spec.n_bins,), jnp.int32),
        total_bins=jnp.zeros((spec.n_bins,), jnp.int32),
    )


def _step(carry: BoardCarry, step, spec: ChainSpec, scale=None) -> BoardCarry:
    """One Metropolis proposal for a single chain.

    ``step`` may exceed n_steps - 1 (tail padding of the last chunk); such
    steps are inert.  ``scale`` (a float32 scalar or None) multiplies the
    scheduled beta — the chain's ladder level under parallel tempering.
    """
    N = spec.N
    key = jax.random.fold_in(carry.step_base, step)
    k_i, k_j, k_k, k_u = jax.random.split(key, 4)

    i = jax.random.randint(k_i, (), 0, N, dtype=jnp.int32)
    j = jax.random.randint(k_j, (), 0, N, dtype=jnp.int32)
    flat_ij = i * N + j
    old_k = carry.heights[flat_ij]
    # Uniform over {0..N-1} \ {old_k}, exactly, without a resampling loop.
    new_k = (old_k + 1 + jax.random.randint(k_k, (), 0, N - 1, dtype=jnp.int32)) % N

    if spec.kernel == "tables":
        d_e, idx_old, idx_new = tables_mod.board_delta_e(
            carry.table, i, j, old_k, new_k, N
        )
    else:
        h2d = carry.heights.reshape(N, N)
        d_e = energy_mod.board_conflicts(h2d, i, j, new_k) - energy_mod.board_conflicts(
            h2d, i, j, old_k
        )

    beta = spec.schedule(step)
    if scale is not None:
        beta = beta * scale
    # accept prob = min(1, exp(-beta * dE)); u < exp(...) suffices since u < 1.
    accept = jax.random.uniform(k_u) < jnp.exp(-beta * d_e.astype(jnp.float32))

    active = jnp.logical_and(~carry.done, step < spec.n_steps)
    upd = jnp.logical_and(accept, active)

    heights = carry.heights.at[flat_ij].set(jnp.where(upd, new_k, old_k))
    table = carry.table
    if spec.kernel == "tables":
        table = tables_mod.apply_move(table, idx_old, idx_new, upd)
    new_energy = carry.energy + jnp.where(upd, d_e, 0).astype(jnp.int32)

    improved = jnp.logical_and(upd, new_energy < carry.best_energy)
    best_heights = jnp.where(improved, heights, carry.best_heights)
    best_energy = jnp.where(improved, new_energy, carry.best_energy)
    best_step = jnp.where(improved, step + 1, carry.best_step)

    # Patience counts every processed step without a new best (accepted or
    # rejected), resetting only on improvement (experiments.py:340-347).
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

    # The reference records the stopping step's accept/reject before breaking
    # (experiments.py:329-332 precede :349), so bins use the pre-check flag.
    b = jnp.minimum(step * spec.n_bins // spec.n_steps, spec.n_bins - 1)
    inc = active.astype(jnp.int32)
    accept_bins = carry.accept_bins.at[b].add(inc * accept.astype(jnp.int32))
    total_bins = carry.total_bins.at[b].add(inc)

    return BoardCarry(
        step_base=carry.step_base,
        heights=heights,
        table=table,
        energy=new_energy,
        best_heights=best_heights,
        best_energy=best_energy,
        best_step=best_step,
        no_improve=no_improve,
        done=done,
        stop_step=stop_step,
        accept_bins=accept_bins,
        total_bins=total_bins,
    )


@functools.partial(jax.jit, static_argnames=("spec", "n_outer"))
def run_segment(carry: BoardCarry, start_outer, spec: ChainSpec, n_outer: int,
                beta_scale=None):
    """Advance a batch of chains by ``n_outer`` history chunks.

    Each chunk is ``spec.history_stride`` fused steps; the energy after each
    chunk is emitted as one history point.  Returns (carry, (n_outer, C)
    energies).  ``start_outer`` is dynamic so every segment of a long run
    reuses one compiled program.  ``beta_scale`` is an optional (C,) float32
    row: chain c then anneals at ``spec.schedule(step) * beta_scale[c]``
    (a row of ones reproduces the unscaled run bitwise).
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
def init_carry_batch(keys, spec: ChainSpec, initial_states=None) -> BoardCarry:
    """Batched carry: one chain per key; optional (C, N, N) warm starts."""
    if initial_states is None:
        return jax.vmap(lambda k: init_carry(k, spec))(keys)
    return jax.vmap(lambda k, h: init_carry(k, spec, h))(keys, initial_states)
