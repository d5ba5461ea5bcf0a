"""mcqueens — a JAX Monte-Carlo simulated-annealing framework.

A from-scratch JAX/XLA re-design of the capabilities of the reference
``galgantar/monte-carlo-collective`` codebase (3D N²-queens via Metropolis
annealing).  Instead of one Python loop per OS process, chains are fused
``lax.scan`` programs with O(1) incremental energy (line-family count tables),
``vmap``-ed into thousands of replicas per device and sharded over a
``jax.sharding.Mesh`` for multi-device runs.

Layers (bottom-up):
    core/        state semantics: energy oracle, count tables, schedules, init, rng
    chain/       fused Metropolis samplers (board + full_3d) + on-device stats
    search/      parallel tempering (replica exchange) over the samplers
    dist/        device-mesh runners, multi-run orchestration, seed derivation
    experiments/ config-driven drivers, plotting and CSV sinks
    cli/         experiments / competition / schedule-figure entry points
    utils/       checkpointing, profiling, compile cache
"""

__version__ = "0.1.0"
