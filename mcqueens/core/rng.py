"""Counter-based PRNG key derivation for replicated, sharded chains.

The reference reseeds NumPy's global MT19937 per worker process
(``experiments.py:201-202,287-288``) with arithmetically derived integer seeds
(per-run ``base_seed + r``, per-beta-pair ``base_seed + 1000*idx``, ...).
Bitwise parity with MT19937 is neither possible nor desirable in JAX; parity
is defined at the distribution level.  What we preserve *exactly* is the seed
derivation arithmetic (:mod:`mcqueens.dist.runner`), so config-driven sweeps
remain reproducible and runs never share a stream.

Design rules (race-detection-by-construction, SURVEY §5.2):
  * every chain key is ``fold_in(root, global_chain_id)`` — independent of how
    chains are sharded across devices, so a 1x8 and an 8x1 mesh produce
    bit-identical chains;
  * all per-step draws derive from ``fold_in(chain_key, step)`` — no sequential
    key-carrying needed, any step's draws are recomputable in isolation.

The replica-exchange draws of :mod:`mcqueens.search.tempering` use a second,
stateless integer hash (:func:`lowbias32`, :func:`uniform01`): each swap
decision is a pure function of (swap seed, round, group, pair), so it does
not depend on the chain count or mesh layout and a resumed search replays
it without stored RNG state.  The hash is plain int32 arithmetic, so its
words are bitwise identical on every backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_M1 = np.int32(np.uint32(0x7FEB352D))
_M2 = np.int32(np.uint32(0x846CA68B))
SEED_K = np.int32(np.uint32(0x85EBCA6B))  # seed stride for counter keys


def chain_keys_from_seeds(seeds):
    """One independent key per chain from an array of integer seeds.

    Each chain's stream is keyed by its own seed, mirroring the reference's
    per-run ``np.random.seed(base_seed + r)``.
    """
    seeds = jnp.asarray(seeds, jnp.uint32)
    return jax.vmap(jax.random.key)(seeds)


def chain_keys(base_seed: int, n_chains: int):
    """Keys for chains r = 0..n_chains-1 with the reference's ``base+r`` rule."""
    return chain_keys_from_seeds(base_seed + jnp.arange(n_chains, dtype=jnp.uint32))


def step_key(chain_key, step):
    """The key governing all draws of one chain step (counter-based)."""
    return jax.random.fold_in(chain_key, step)


def _shr(z, k: int):
    """Logical right shift of int32 by a static amount (jnp's is arithmetic)."""
    return (z >> k) & jnp.int32((1 << (32 - k)) - 1)


def lowbias32(z):
    """Full-avalanche 32-bit integer hash of int32 values (the "lowbias32"
    finalizer; multiplications wrap exactly as in uint32)."""
    z = z ^ _shr(z, 16)
    z = z * _M1
    z = z ^ _shr(z, 15)
    z = z * _M2
    return z ^ _shr(z, 16)


def uniform01(w):
    """24-bit uniform float32 in [0, 1) from a 32-bit word."""
    return (_shr(w, 7) & jnp.int32(0xFFFFFF)).astype(jnp.float32) * (
        jnp.float32(1.0 / (1 << 24))
    )
