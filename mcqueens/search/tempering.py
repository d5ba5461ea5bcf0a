"""Parallel tempering (replica exchange) over the XLA samplers.

A beyond-reference search capability: the reference anneals independent
chains (``/root/reference/experiments.py:282-376``); simulated annealing gets
trapped in deep local minima (its own report shows constant/logarithmic
schedules trapping, report section IV.B).  Parallel tempering runs a ladder
of inverse temperatures simultaneously and lets configurations migrate
between levels, so cold chains inherit basin-hopping moves discovered by hot
ones.  A ladder level is just a per-chain beta scale of the ordinary
samplers (``beta_scale`` of :func:`mcqueens.chain.board.run_segment` and
:func:`mcqueens.chain.full3d.run_segment`), and the exchange move is a small
select on the (C,) beta vector between segments — states never move, only
their temperatures do.

Layout: chain ``c`` sits at ladder level ``c % L`` in replica group
``c // L``.  Every ``exchange_interval`` segments (of ``history_stride``
steps each) adjacent levels in each group attempt a swap with the standard
acceptance ``min(1, exp((beta_a - beta_b) * (E_a - E_b)))``, alternating
odd/even pairs (deterministic-even-odd scheme).

Chains are mutually independent: every chain draws its proposals and accept
variates from its own seed (``fold_in(chain_key, step)``), with no shared
draws and no correlation inside any block of chains.  A segment is thus a
product of per-chain Metropolis kernels, each preserving its own level's
Boltzmann law, and the exchange phase preserves the same product measure by
detailed balance.  Marginal stationarity per level is asserted by
``tests/test_tempering.py``.
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from mcqueens.chain.spec import ChainSpec
from mcqueens.core import rng as rng_mod

_GROUP_K = np.int32(np.uint32(0xB5297A4D))  # group-id stride
_PAIR_K = np.int32(np.uint32(0x1B873593))   # pair-id stride
_ROUND_K = np.int32(np.uint32(0x9E3779B9))  # round stride


def geometric_ladder(beta_min: float, beta_max: float, n_levels: int):
    """Geometric beta ladder (constant acceptance ratio heuristic)."""
    if n_levels < 2:
        raise ValueError("need at least 2 ladder levels")
    if not 0 < beta_min < beta_max:
        raise ValueError("need 0 < beta_min < beta_max")
    return np.geomspace(beta_min, beta_max, n_levels).astype(np.float32)


def round_key(swap_seed: int, round_idx: int):
    """int32 counter for one exchange sweep's accept draws.

    A pure function of (swap_seed, round) so resumed runs replay the same
    swap stream without checkpointing RNG state.
    """
    mixed = (np.uint64(np.uint32(swap_seed)) * np.uint64(np.uint32(rng_mod.SEED_K))
             + np.uint64(np.uint32(round_idx)) * np.uint64(np.uint32(_ROUND_K)))
    return np.int32(np.uint32(mixed & np.uint64(0xFFFFFFFF)))


@functools.partial(jax.jit, static_argnames=("n_levels", "phase"))
def exchange(betas, energies, rkey, n_levels: int, phase: int):
    """One replica-exchange sweep: swap betas between adjacent ladder levels.

    Args:
        betas: (C,) float32 per-chain beta values; chain c is at level
            ``c % n_levels`` of group ``c // n_levels``.  Any tail chains
            beyond the last full group keep their beta untouched.
        energies: (C,) current energies (the exact incremental energies the
            samplers carry — no recompute needed).
        rkey: int32 sweep counter (see :func:`round_key`).  Accept draws are
            counter-hashed per (group, pair), so a group's swap decision is
            independent of the total chain count and of any mesh layout —
            the same invariance contract as the chain streams.
        phase: 0 or 1 — which alternation of adjacent pairs to attempt.

    Returns:
        (C,) updated betas.  Each group's multiset of betas is invariant.
    """
    C = betas.shape[0]
    G = C // n_levels
    paired = G * n_levels
    b = betas[:paired].reshape(G, n_levels)
    e = energies[:paired].reshape(G, n_levels).astype(jnp.float32)
    lo = np.arange(phase, n_levels - 1, 2)
    hi = lo + 1
    bl, bh = b[:, lo], b[:, hi]
    el, eh = e[:, lo], e[:, hi]
    # A = min(1, exp((beta_l - beta_h)(E_l - E_h))); log-space comparison.
    log_a = (bl - bh) * (el - eh)
    gids = jnp.arange(G, dtype=jnp.int32)[:, None]
    pids = jnp.asarray(lo, jnp.int32)[None, :]
    # The salt keeps the trivial input 0 away from lowbias32's zero fixed
    # point (hash(0) == 0 would make group 0's first draw exactly 0.0).
    w = rng_mod.lowbias32(
        rng_mod.lowbias32(jnp.int32(rkey) ^ (gids * _GROUP_K) ^ _PAIR_K)
        + pids * _PAIR_K
    )
    # Clamp away u == 0 (a 2^-24 event): log-space compare needs u > 0.
    # float32 1e-12 is normal; the distortion (swaps with acceptance below
    # 1e-12 become impossible) is far under the test tolerances.
    u = jnp.maximum(rng_mod.uniform01(w), jnp.float32(1e-12))
    swap = jnp.log(u) < log_a
    b = b.at[:, lo].set(jnp.where(swap, bh, bl))
    b = b.at[:, hi].set(jnp.where(swap, bl, bh))
    return jnp.concatenate([b.reshape(-1), betas[paired:]])


def run_tempered(
    seeds,
    spec: ChainSpec,
    ladder,
    *,
    swap_seed: int = 0,
    initial_states=None,
    verbose: bool = False,
    record_betas: bool = False,
    exchange_interval: int = 1,
    mesh=None,
    checkpointer=None,
    stop_at_energy=None,
):
    """Run parallel-tempered chains with periodic replica exchange.

    Args:
        seeds: (R,) per-chain integer seeds (R should be a multiple of
            ``len(ladder)`` so every group is complete).
        spec: chain spec of either ``mcmc_type`` and either kernel.
            ``spec.schedule`` multiplies the ladder: a constant-1 schedule
            gives plain parallel tempering at the ladder values; an
            annealing schedule anneals the whole ladder.
        ladder: (L,) ascending beta values (see :func:`geometric_ladder`).
        swap_seed: seed for the exchange accept draws.
        initial_states: optional warm starts — (R, N, N) heights for
            ``mcmc_type='board'``, (R, Q, 3) queen coordinates for
            ``'full_3d'``.
        record_betas: also return the per-round (C,) beta assignments
            (memory: rounds x chains floats — small shapes only).
        exchange_interval: segments (of ``history_stride`` steps each)
            between replica-exchange sweeps.  History cadence and swap
            cadence are independent knobs: swaps happen every
            ``exchange_interval * history_stride`` steps while the energy
            history keeps one point per ``history_stride`` steps.
        mesh: optional 1-D chains mesh.  The batch is padded with
            follow-on seeds (discarded at the end) so every device holds
            the same whole number of ladder groups: no group straddles two
            devices, so the exchange sweep stays device-local.  With R a
            multiple of ``len(ladder)`` the real chains' results equal the
            unsharded run's bitwise.
        stop_at_energy: optional early-stop target — end the search after
            the first round whose global best energy is <= this value
            (certificate searches pass 0: once a zero-attack placement is
            banked in ``best_state`` the remaining rounds cannot improve
            it).  Costs one 4-byte-per-chain device pull per round; rounds
            already run are bit-identical to a run without the flag.
        checkpointer: optional :class:`mcqueens.utils.checkpoint.Checkpointer`
            — saves (carry, betas) after each round (at the checkpointer's
            ``every`` cadence) and resumes a killed search bit-identically;
            no RNG state is stored because the swap stream is a pure
            counter function of (swap_seed, round).

    Returns:
        dict with best_energy/best_state (over real chains), final betas,
        per-round energy history (chains x rounds+1), wall time, and
        optionally the beta history.
    """
    from mcqueens.dist import mesh as mesh_mod
    from mcqueens.dist import runner as runner_mod

    if exchange_interval < 1:
        raise ValueError("exchange_interval must be >= 1")
    mod = runner_mod.sampler_module(spec)
    ladder = np.asarray(ladder, np.float32)
    n_levels = int(ladder.shape[0])
    seeds = np.asarray(seeds, dtype=np.uint32)
    n_runs = seeds.shape[0]
    if initial_states is not None:
        initial_states = runner_mod.validate_initial_states(
            initial_states, spec, n_runs)
    seeds, initial_states = runner_mod.pad_runs(
        seeds, initial_states, mesh_mod.pad_chains(n_runs, mesh, n_levels))

    def place(tree):
        if mesh is None:
            return jax.device_put(tree)
        return mesh_mod.shard_chains(tree, mesh)

    t_setup = time.time()
    carry = mod.init_carry_batch(
        place(rng_mod.chain_keys_from_seeds(seeds)), spec, initial_states)
    C = int(carry.energy.shape[0])
    reps = -(-C // n_levels)
    betas = place(jnp.asarray(np.tile(ladder, reps)[:C]))

    e0 = np.asarray(carry.energy).reshape(-1)
    history = [e0[None, :]]
    betas_hist = []
    n_rounds = -(-spec.n_outer // exchange_interval)
    start_round = 0
    if checkpointer is not None:
        from mcqueens.utils import checkpoint as ckpt_mod

        fp = ckpt_mod.spec_fingerprint(spec, seeds)
        # record_betas changes the checkpoint payload (the beta history
        # rides in the extras), so it is part of the run identity.
        fp = ckpt_mod.extend_fingerprint(
            fp, ladder, np.uint32(swap_seed), np.int64(exchange_interval),
            np.bool_(record_betas))
        n_extras = 2 if record_betas else 1
        resumed = checkpointer.restore(carry, seg_outer=exchange_interval,
                                       fingerprint=fp, n_extras=n_extras)
        if resumed is not None:
            carry, start_round, chunks, extras = resumed
            carry = place(carry)
            betas = place(jnp.asarray(extras[0]))
            if record_betas:
                betas_hist = [row for row in extras[1]]
            history = [np.asarray(c) for c in chunks]
    setup = time.time() - t_setup
    t0 = time.time()
    for r in range(start_round, n_rounds):
        seg0 = r * exchange_interval
        n_seg = min(exchange_interval, spec.n_outer - seg0)
        carry, ys = mod.run_segment(carry, np.int32(seg0), spec, n_seg, betas)
        history.append(np.asarray(ys))
        if record_betas:
            # The betas under which this round's samples were generated.
            betas_hist.append(np.asarray(betas))
        if r + 1 < n_rounds:
            # The swap stream is a pure function of (swap_seed, r): resumes
            # replay it bit-identically with no RNG state in the checkpoint.
            betas = exchange(betas, carry.energy.reshape(-1),
                             round_key(swap_seed, r), n_levels, r % 2)
        if checkpointer is not None:
            extras = (np.asarray(betas),)
            if record_betas:
                extras += (np.stack(betas_hist) if betas_hist
                           else np.zeros((0, C), np.float32),)
            checkpointer.save(
                carry, r + 1, history, seg_outer=exchange_interval,
                fingerprint=fp, extras=extras,
            )
        if verbose and (r + 1) % max(1, n_rounds // 10) == 0:
            e = np.asarray(carry.energy).reshape(-1)[:n_runs]
            be = np.asarray(carry.best_energy).reshape(-1)[:n_runs]
            print(f"[tempering] round {r + 1}/{n_rounds}: "
                  f"mean E={e.mean():.2f} best={be.min()}")
        if stop_at_energy is not None:
            be = np.asarray(carry.best_energy).reshape(-1)[:n_runs]
            if be.min() <= stop_at_energy:
                if verbose:
                    print(f"[tempering] early stop at round {r + 1}/"
                          f"{n_rounds}: best={be.min()}")
                break
    best_energy = np.asarray(carry.best_energy).reshape(-1)
    wall = time.time() - t0
    final_state, best_state = runner_mod.carry_states(carry, spec)

    s = slice(0, n_runs)
    out = {
        "best_energy": best_energy[s],
        "best_state": best_state[s],
        "final_energy": np.asarray(carry.energy).reshape(-1)[s],
        "final_state": final_state[s],
        "energy_history": np.concatenate(history, axis=0).T[s],
        "betas": np.asarray(betas)[s],
        "ladder": ladder,
        "wall_time": wall,
        "setup_time": setup,
        "n_devices": len(carry.energy.sharding.device_set),
        "proposals": int(np.asarray(carry.total_bins).sum()),
    }
    if record_betas:
        out["betas_history"] = np.stack(betas_hist, axis=0)[:, :n_runs]
    return out
