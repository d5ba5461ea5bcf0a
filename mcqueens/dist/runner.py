"""Multi-run orchestration: the reference's process-pool layer, on device.

The reference fans n_runs chains over a ``ProcessPoolExecutor`` with pickled
schedule params and per-run seeds ``base_seed + r`` (``experiments.py:475-573``).
Here a "run" is one lane of a vmapped chain batch: all runs execute inside a
single compiled program, optionally sharded over a device mesh, and results
come back as batched arrays.  Long runs execute as equal-shape jitted
segments so one executable is reused while the host streams history chunks,
prints progress, and writes checkpoints between segments (SURVEY §5.1/5.4).

Per-run isolation (SURVEY §5.3): a chain cannot "throw" mid-scan — failure
modes are batch-wide (compile errors) — so one diverged run can never abort a
sweep the way a worker exception kills the reference's pool
(``experiments.py:530-533``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import numpy as np

from mcqueens.chain import board as board_chain
from mcqueens.chain import full3d as full3d_chain
from mcqueens.chain.spec import ChainSpec
from mcqueens.core import rng as rng_mod
from mcqueens.dist import mesh as mesh_mod

# Cap on history points held on device per segment (64M -> 256 MB of int32
# at 1k chains); segments get smaller as chains/history grow.
_MAX_SEGMENT_ELEMS = 64 * 1024 * 1024

# Cap on proposed moves per dispatched segment, so a long run streams as many
# short executions (progress, checkpoints and early-stop checks then happen
# at a bounded cadence) instead of one multi-hour device call.  It was sized
# for a crash of long single executions on an earlier accelerator target;
# whether the GPU needs it is not measured.
_MAX_SEGMENT_PROPOSALS = 2 ** 31


def plan_segments(n_outer: int, n_padded: int, history_stride: int,
                  min_segments: int = 1) -> tuple[int, int]:
    """Split ``n_outer`` history chunks into host-visible segments.

    Returns ``(n_segs, seg_outer)`` with ``n_segs * seg_outer >= n_outer``,
    bounding both the on-device history footprint per segment
    (:data:`_MAX_SEGMENT_ELEMS`) and the single-dispatch execution length
    (:data:`_MAX_SEGMENT_PROPOSALS`) — the latter keeps long runs streaming
    as many short executions instead of one watchdog-tripping one.
    """
    elems_cap = max(1, _MAX_SEGMENT_ELEMS // max(1, n_padded))
    work_cap = max(
        1, _MAX_SEGMENT_PROPOSALS // max(1, n_padded * history_stride))
    max_outer_per_seg = min(elems_cap, work_cap)
    n_segs = max(min_segments, -(-n_outer // max_outer_per_seg), 1)
    n_segs = min(n_segs, n_outer) or 1
    seg_outer = -(-n_outer // n_segs)
    return n_segs, seg_outer


@dataclasses.dataclass
class ChainResult:
    """Batched results for R chains (axis 0 = run/chain index).

    energy_history rows are full-length even for early-stopped chains (the
    frozen value repeats); ``history_len`` gives each chain's reference-
    equivalent truncated length (the reference stops appending after the
    patience break, ``experiments.py:349-355``).
    """

    spec: ChainSpec
    energy_history: np.ndarray   # (R, P) int32
    history_steps: np.ndarray    # (P,) int64 step index of each history point
    history_len: np.ndarray      # (R,) reference-equivalent history length
    final_energy: np.ndarray     # (R,)
    final_state: np.ndarray      # (R, N, N) heights or (R, Q, 3) queens
    best_energy: np.ndarray      # (R,)
    best_state: np.ndarray       # (R, N, N) or (R, Q, 3)
    steps_to_best: np.ndarray    # (R,) first history index of the minimum
    stop_step: np.ndarray        # (R,) early-stop step (n_steps if none)
    accept_bins: np.ndarray      # (R, n_bins)
    total_bins: np.ndarray       # (R, n_bins)
    wall_time: float             # sampling wall clock (seconds), set-up excluded
    run_times: np.ndarray        # (R,) per-run wall clock; the batch is one
                                 # fused program so this is wall_time for all
    setup_time: float = 0.0      # chain init (and its compile) before sampling
    n_devices: int = 1           # devices the chain carry was spread over

    @property
    def n_runs(self) -> int:
        return self.energy_history.shape[0]

    @property
    def proposals(self) -> int:
        """Total proposed moves across the batch (for throughput reporting)."""
        return int(self.total_bins.sum())

    @property
    def moves_per_sec(self) -> float:
        return self.proposals / max(self.wall_time, 1e-9)


def sampler_module(spec: ChainSpec):
    """The sampler module (``init_carry_batch``/``run_segment``) of a spec."""
    return board_chain if spec.mcmc_type == "board" else full3d_chain


def pad_runs(seeds, initial_states, n_total: int):
    """Pad a batch to ``n_total`` chains with distinct follow-on seeds.

    Padded lanes reuse the last warm start and are discarded at slice time.
    """
    n = seeds.shape[0]
    if n_total <= n:
        return seeds, initial_states
    pad = seeds[-1] + 1 + np.arange(n_total - n, dtype=np.uint32)
    seeds = np.concatenate([seeds, pad])
    if initial_states is not None:
        reps = np.repeat(initial_states[-1:], n_total - n, axis=0)
        initial_states = np.concatenate([initial_states, reps])
    return seeds, initial_states


def carry_states(carry, spec: ChainSpec):
    """(final_state, best_state) as host arrays: (C, N, N) heights for board
    chains, (C, Q, 3) queens for full_3d chains."""
    if spec.mcmc_type == "board":
        shape = (-1, spec.N, spec.N)
        return (np.asarray(carry.heights, dtype=np.int64).reshape(shape),
                np.asarray(carry.best_heights, dtype=np.int64).reshape(shape))
    return np.asarray(carry.queens), np.asarray(carry.best_queens)


def validate_initial_states(initial_states, spec: ChainSpec, n_runs: int):
    """Reference-style explicit-state validation (``mcmc_board.py:60-66``,
    ``mcmc.py:106-118``): shapes, value ranges, distinct cells."""
    arr = np.asarray(initial_states)
    if spec.mcmc_type == "board":
        want = (n_runs, spec.N, spec.N)
        if arr.shape != want:
            raise ValueError(f"initial_states must have shape {want}, got {arr.shape}")
        if ((arr < 0) | (arr >= spec.N)).any():
            raise ValueError(f"All heights must be in [0, {spec.N - 1}]")
    else:
        want = (n_runs, spec.q_eff, 3)
        if arr.shape != want:
            raise ValueError(f"initial_states must have shape {want}, got {arr.shape}")
        if ((arr < 0) | (arr >= spec.N)).any():
            raise ValueError(f"All coordinates must be in [0, {spec.N - 1}]")
        cells = np.sort((arr[..., 0] * spec.N + arr[..., 1]) * spec.N
                        + arr[..., 2], axis=1)
        if (cells[:, 1:] == cells[:, :-1]).any():
            raise ValueError("Two queens occupy the same (i,j,k) cell.")
    return arr.astype(np.int32)


def run_chains(
    seeds,
    spec: ChainSpec,
    *,
    mesh=None,
    verbose: bool = False,
    min_segments: int = 1,
    checkpointer=None,
    profile_dir: Optional[str] = None,
    initial_states=None,
) -> ChainResult:
    """Run one independent chain per seed, fused and (optionally) sharded.

    Args:
        seeds: integer array of per-chain seeds (the reference derivations —
            ``base_seed + r`` etc. — are applied by the caller; see
            :func:`run_experiment`).
        spec: static chain configuration.
        mesh: optional 1-D device mesh; the chain batch is padded to a
            multiple of the mesh size and sharded along it.
        verbose: print segment progress (mean/min energy across runs).
        min_segments: lower bound on host-visible segments (used for progress
            cadence and checkpoint granularity).
        checkpointer: optional :class:`mcqueens.utils.checkpoint.Checkpointer`;
            saves the carry after every segment and resumes from a saved
            segment when present.
        profile_dir: if set, wrap execution in a ``jax.profiler`` trace.
    """
    seeds = np.asarray(seeds, dtype=np.uint32)
    n_runs = seeds.shape[0]
    if initial_states is not None:
        initial_states = validate_initial_states(initial_states, spec, n_runs)
    n_padded = mesh_mod.pad_chains(n_runs, mesh)
    seeds, initial_states = pad_runs(seeds, initial_states, n_padded)

    mod = sampler_module(spec)
    keys = rng_mod.chain_keys_from_seeds(seeds)
    if mesh is not None:
        keys = mesh_mod.shard_chains(keys, mesh)

    n_outer = spec.n_outer
    if verbose:
        min_segments = max(min_segments, 10)
    if checkpointer is not None:
        min_segments = max(min_segments, checkpointer.min_segments)
    n_segs, seg_outer = plan_segments(
        n_outer, n_padded, spec.history_stride, min_segments)

    t0 = time.time()
    profiler_cm = (
        jax.profiler.trace(profile_dir) if profile_dir else _nullcontext()
    )
    with profiler_cm:
        carry = mod.init_carry_batch(keys, spec, initial_states)
        e0 = np.asarray(carry.energy).reshape(-1)
        history_chunks = []
        start_seg = 0
        if checkpointer is not None:
            from mcqueens.utils.checkpoint import spec_fingerprint

            ckpt_fp = spec_fingerprint(spec, seeds)
            resumed = checkpointer.restore(carry, seg_outer=seg_outer,
                                           fingerprint=ckpt_fp)
            if resumed is not None:
                carry, start_seg, history_chunks = resumed
                carry = (jax.device_put(carry) if mesh is None
                         else mesh_mod.shard_chains(carry, mesh))
        # Set-up (chain init, its compile, any resume) ends here; wall_time
        # covers the sampling segments alone.
        setup = time.time() - t0
        t0 = time.time()
        for seg in range(start_seg, n_segs):
            carry, ys = mod.run_segment(carry, np.int32(seg * seg_outer), spec,
                                        seg_outer)
            ys = np.asarray(ys)  # (seg_outer, C)
            history_chunks.append(ys)
            if verbose:
                done_steps = min((seg + 1) * seg_outer * spec.history_stride,
                                 spec.n_steps)
                e = np.asarray(carry.energy[:n_runs])
                print(
                    f"[mcqueens] step {done_steps}/{spec.n_steps}: "
                    f"mean E={e.mean():.2f} min E={e.min()}"
                )
            if checkpointer is not None:
                checkpointer.save(carry, seg + 1, history_chunks,
                                  seg_outer=seg_outer, fingerprint=ckpt_fp)
        jax.block_until_ready(carry.energy)
    wall = time.time() - t0
    if verbose:
        total_props = int(np.asarray(carry.total_bins).sum())
        print(
            f"[mcqueens] {total_props:.3e} proposals in {wall:.2f}s "
            f"= {total_props / max(wall, 1e-9):.3e} moves/s"
        )

    hist = np.concatenate(history_chunks, axis=0)[:n_outer]  # (n_outer, C)
    energy_history = np.concatenate([e0[None, :], hist], axis=0).T  # (C, P)
    history_steps = np.minimum(
        np.arange(n_outer + 1, dtype=np.int64) * spec.history_stride, spec.n_steps
    )

    stop_step = np.asarray(carry.stop_step).reshape(-1)
    # Reference-equivalent truncated history length: a run breaking at step s
    # appends energies for steps 0..s-1 only (the break precedes the append,
    # experiments.py:349-355), i.e. ceil(s / stride) points plus the initial.
    stopped = stop_step < spec.n_steps
    pts = -(-stop_step // spec.history_stride)
    history_len = (np.where(stopped, pts, n_outer) + 1).astype(np.int64)

    final_state, best_state = carry_states(carry, spec)

    s = slice(0, n_runs)
    return ChainResult(
        spec=spec,
        energy_history=energy_history[s],
        history_steps=history_steps,
        history_len=history_len[s],
        final_energy=np.asarray(carry.energy).reshape(-1)[s],
        final_state=final_state[s],
        best_energy=np.asarray(carry.best_energy).reshape(-1)[s],
        best_state=best_state[s],
        steps_to_best=np.asarray(carry.best_step).reshape(-1)[s],
        stop_step=stop_step[s],
        accept_bins=np.asarray(carry.accept_bins)[s],
        total_bins=np.asarray(carry.total_bins)[s],
        wall_time=wall,
        run_times=np.full((n_runs,), wall),
        setup_time=setup,
        n_devices=len(carry.energy.sharding.device_set),
    )


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def run_experiment(
    N: int,
    n_steps: int,
    init_mode: str,
    schedule,
    n_runs: int,
    base_seed: int = 0,
    *,
    mcmc_type: str = "board",
    early_stop_patience=100000,
    verbose: bool = False,
    mesh=None,
    history_stride: int = 1,
    kernel: str = "tables",
    n_bins: int = 100,
    checkpointer=None,
    Q: Optional[int] = None,
) -> ChainResult:
    """Reference-compatible experiment entry point.

    Mirrors ``run_experiment`` (``experiments.py:475-573``): n_runs chains
    with per-run seeds ``base_seed + r``.  Differences (documented fixes of
    reference quirks, SURVEY §2.1):

      * ``early_stop_patience`` applies to *board* chains for every n_runs
        (the reference's sequential n_runs==1 path silently drops it,
        ``experiments.py:548-558``);
      * full_3d chains ignore patience — matching the reference sampler,
        which accepts but never reads the argument (``experiments.py:199``).
        Pass a ChainSpec directly to :func:`run_chains` to enable it.
      * the string 'None'/'null' is accepted for patience (config quirk,
        ``experiments.py:284-285``).
    """
    if early_stop_patience in (None, "None", "null"):
        early_stop_patience = None
    if mcmc_type == "full_3d":
        effective_patience = None
    else:
        effective_patience = early_stop_patience
    spec = ChainSpec(
        N=N,
        n_steps=n_steps,
        schedule=schedule,
        init_mode=init_mode,
        mcmc_type=mcmc_type,
        early_stop_patience=effective_patience,
        history_stride=history_stride,
        kernel=kernel,
        n_bins=n_bins,
        Q=Q,
    )
    seeds = base_seed + np.arange(n_runs, dtype=np.int64)
    return run_chains(
        np.asarray(seeds, dtype=np.uint32),
        spec,
        mesh=mesh,
        verbose=verbose,
        checkpointer=checkpointer,
    )
