"""Device-mesh plumbing: chain parallelism over the devices of a host.

The reference's only parallelism is independent chains over OS processes with
pickle transport (``experiments.py:513-533``).  The equivalent here is a 1-D
``chains`` mesh axis: thousands of vmapped chains per device, sharded across
devices with ``NamedSharding`` so XLA partitions the (embarrassingly
parallel) scan with zero mid-run communication.  Cross-device data appears
only at the statistics boundary — ``psum``/``pmean`` reductions of curve
stats and an argmin-gather of the global best board (SURVEY §5.8).  The
cards of one host are joined all to all, so the mesh stays 1-D.

Multi-host runs: call :func:`init_distributed` first (wraps
``jax.distributed.initialize``); ``make_mesh`` then spans all global devices
and the same code scales out across hosts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHAINS_AXIS = "chains"


def init_distributed(**kwargs):
    """Initialize multi-host JAX (no-op only if already initialized).

    Real failures (bad coordinator address, port in use, mismatched process
    counts, ...) propagate: a misconfigured pod run must abort loudly rather
    than silently continue single-host.  Exercised by the two-process DCN
    check (``tools/check_multihost.py`` / ``tests/test_multihost.py``).
    """
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already initialized" in str(e).lower():
            return
        raise


def make_mesh(devices=None, axis_name: str = CHAINS_AXIS) -> Mesh:
    """A 1-D mesh over all (or the given) devices, chains axis only.

    A single chain's state is O(N^2) ints — there is never a reason to shard
    *within* a chain (SURVEY §5.7), so the mesh is one replica axis.
    """
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def chain_sharding(mesh: Mesh) -> NamedSharding:
    """Shard axis 0 (the chains axis) over the mesh."""
    return NamedSharding(mesh, P(CHAINS_AXIS))


def shard_chains(tree, mesh: Mesh):
    """Device_put every leaf with axis 0 sharded over the chains axis."""
    return jax.device_put(tree, chain_sharding(mesh))


def pad_chains(n_chains: int, mesh: Mesh | None, group: int = 1) -> int:
    """Round the chain count up so every device holds the same whole number
    of ``group``-chain groups (tempering passes its ladder length, so no
    replica group straddles two devices)."""
    if mesh is None:
        return n_chains
    unit = mesh.devices.size * group
    return -(-n_chains // unit) * unit


def global_best_stats(best_energy, energies):
    """Device-side reduction of the only cross-chain quantities.

    Returns (global min best energy, argmin chain id, mean energy).  Runs
    under jit on sharded inputs; XLA lowers the reductions to collectives.
    """
    best_energy = jnp.asarray(best_energy)
    gmin = jnp.min(best_energy)
    gargmin = jnp.argmin(best_energy)
    return gmin, gargmin, jnp.mean(jnp.asarray(energies).astype(jnp.float32))
