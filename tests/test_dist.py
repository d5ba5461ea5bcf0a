"""Distribution tests on the virtual 8-device CPU mesh (SURVEY §4.4)."""

import numpy as np
import pytest

import jax

from mcqueens.chain.spec import ChainSpec
from mcqueens.core.schedules import build_schedule
from mcqueens.dist import mesh as mesh_mod
from mcqueens.dist import runner
from mcqueens.utils.checkpoint import Checkpointer


def _spec(n_steps=800, **kw):
    defaults = dict(
        N=5,
        n_steps=n_steps,
        schedule=build_schedule("linear_annealing", n_steps, beta_start=0.5, beta_end=3.0),
        init_mode="random",
        mcmc_type="board",
    )
    defaults.update(kw)
    return ChainSpec(**defaults)


def test_eight_virtual_devices_present():
    assert jax.device_count() == 8


def test_plan_segments_caps_dispatch_work():
    # A long run (N=18 full_3d: 4096 chains, 2^21 steps, stride 2^15) must
    # split so no dispatch exceeds _MAX_SEGMENT_PROPOSALS proposed moves.
    n_padded, stride, n_outer = 4096, 1 << 15, 64
    n_segs, seg_outer = runner.plan_segments(n_outer, n_padded, stride)
    assert n_segs > 1
    assert n_segs * seg_outer >= n_outer
    assert n_padded * stride * seg_outer <= runner._MAX_SEGMENT_PROPOSALS

    # Small runs stay a single dispatch.
    assert runner.plan_segments(64, 1024, 100) == (1, 64)

    # min_segments is still honored.
    n_segs, seg_outer = runner.plan_segments(64, 1024, 100, min_segments=10)
    assert n_segs >= 10 and n_segs * seg_outer >= 64

    # The history-footprint cap still applies (many chains, stride 1).
    n_segs, seg_outer = runner.plan_segments(
        1 << 20, 1 << 12, 1, min_segments=1)
    assert seg_outer * (1 << 12) <= runner._MAX_SEGMENT_ELEMS

    # A single outer chunk larger than the work cap degrades to
    # one-chunk segments (history granularity bounds the split).
    n_segs, seg_outer = runner.plan_segments(4, 1 << 16, 1 << 20)
    assert seg_outer == 1 and n_segs == 4


def test_work_cap_split_is_bitwise_invariant(monkeypatch):
    # Forcing the dispatch-work cap to split a run must not change any
    # result (counter-based streams make segmentation a pure host concern).
    spec = _spec(n_steps=800, history_stride=100, kernel="tables")
    seeds = np.arange(6, dtype=np.uint32)
    plain = runner.run_chains(seeds, spec)
    monkeypatch.setattr(runner, "_MAX_SEGMENT_PROPOSALS", 6 * 100 * 2)
    split = runner.run_chains(seeds, spec)
    assert runner.plan_segments(spec.n_outer, 6, 100)[0] > 1
    np.testing.assert_array_equal(plain.energy_history, split.energy_history)
    np.testing.assert_array_equal(plain.final_state, split.final_state)
    np.testing.assert_array_equal(plain.best_state, split.best_state)
    np.testing.assert_array_equal(plain.accept_bins, split.accept_bins)


def test_sharded_run_bitwise_equals_unsharded():
    """Chain streams are keyed by global chain id, so results must be
    independent of the device layout (1 device vs 8-device mesh)."""
    spec = _spec()
    seeds = np.arange(16, dtype=np.uint32)
    plain = runner.run_chains(seeds, spec)
    mesh = mesh_mod.make_mesh()
    sharded = runner.run_chains(seeds, spec, mesh=mesh)
    np.testing.assert_array_equal(plain.energy_history, sharded.energy_history)
    np.testing.assert_array_equal(plain.final_state, sharded.final_state)
    np.testing.assert_array_equal(plain.best_energy, sharded.best_energy)
    np.testing.assert_array_equal(plain.accept_bins, sharded.accept_bins)


def test_sharded_run_pads_nondivisible_chain_count():
    spec = _spec(n_steps=300)
    mesh = mesh_mod.make_mesh()
    res = runner.run_chains(np.arange(10, dtype=np.uint32), spec, mesh=mesh)
    assert res.n_runs == 10
    plain = runner.run_chains(np.arange(10, dtype=np.uint32), spec)
    np.testing.assert_array_equal(plain.energy_history, res.energy_history)


def test_submesh_equivalence():
    """2-device and 8-device meshes give identical chains."""
    spec = _spec(n_steps=300)
    seeds = np.arange(8, dtype=np.uint32)
    m2 = mesh_mod.make_mesh(jax.devices()[:2])
    m8 = mesh_mod.make_mesh()
    a = runner.run_chains(seeds, spec, mesh=m2)
    b = runner.run_chains(seeds, spec, mesh=m8)
    np.testing.assert_array_equal(a.energy_history, b.energy_history)


def test_global_best_stats_reduction():
    spec = _spec(n_steps=300)
    mesh = mesh_mod.make_mesh()
    res = runner.run_chains(np.arange(8, dtype=np.uint32), spec, mesh=mesh)
    gmin, gargmin, mean_e = jax.jit(mesh_mod.global_best_stats)(
        res.best_energy, res.final_energy
    )
    assert int(gmin) == res.best_energy.min()
    assert res.best_energy[int(gargmin)] == res.best_energy.min()
    assert float(mean_e) == pytest.approx(res.final_energy.mean(), rel=1e-6)


def test_checkpoint_resume_is_bit_identical(tmp_path):
    spec = _spec(n_steps=1000)
    seeds = np.arange(4, dtype=np.uint32)

    uninterrupted = runner.run_chains(seeds, spec)

    ck = Checkpointer(str(tmp_path), every=1, min_segments=4)

    class StopAfterTwo(Exception):
        pass

    # Simulate a crash after 2 of 4 segments by a saving checkpointer whose
    # save raises once two segments are in.
    class CrashingCheckpointer(Checkpointer):
        def save(self, carry, segments_done, chunks, **kw):
            super().save(carry, segments_done, chunks, **kw)
            if segments_done == 2:
                raise StopAfterTwo()

    crasher = CrashingCheckpointer(str(tmp_path), every=1, min_segments=4)
    with pytest.raises(StopAfterTwo):
        runner.run_chains(seeds, spec, checkpointer=crasher)

    resumed = runner.run_chains(seeds, spec, checkpointer=ck)
    np.testing.assert_array_equal(
        resumed.energy_history, uninterrupted.energy_history
    )
    np.testing.assert_array_equal(resumed.final_state, uninterrupted.final_state)
    np.testing.assert_array_equal(resumed.best_energy, uninterrupted.best_energy)
    np.testing.assert_array_equal(resumed.accept_bins, uninterrupted.accept_bins)


def test_checkpoint_history_io_is_linear(tmp_path):
    """VERDICT r3 Weak #4: each history chunk is written to disk exactly
    once (O(total) I/O), not rewritten with every save (O(segments^2))."""

    import collections

    FakeCarry = collections.namedtuple("FakeCarry", ["x"])
    carry = FakeCarry(x=np.zeros((4, 4), np.int32))
    ck = Checkpointer(str(tmp_path), tag="lin", every=1)
    chunks = []
    n_segs, chunk = 12, np.arange(64, dtype=np.int32).reshape(8, 8)
    for seg in range(1, n_segs + 1):
        chunks.append(chunk.copy())
        ck.save(carry, seg, chunks, fingerprint="fp")
    # linear: n_segs chunk writes of chunk.nbytes each; quadratic would be
    # n_segs * (n_segs + 1) / 2 of them
    assert ck.history_bytes_written == n_segs * chunk.nbytes
    restored = ck.restore(carry, fingerprint="fp")
    assert restored is not None
    got_carry, segs_done, got_chunks = restored
    assert segs_done == n_segs and len(got_chunks) == n_segs
    for c in got_chunks:
        np.testing.assert_array_equal(c, chunk)

    # min_interval_s throttles intermediate saves but a resume from any
    # saved point is still well-formed
    ck2 = Checkpointer(str(tmp_path), tag="thr", every=1,
                       min_interval_s=3600.0)
    for seg in range(1, 5):
        ck2.save(carry, seg, [chunk] * seg, fingerprint="fp")
    r2 = ck2.restore(carry, fingerprint="fp")
    assert r2 is not None and r2[1] == 1  # only the first save landed


def test_checkpoint_full3d_roundtrip(tmp_path):
    spec = _spec(n_steps=400, mcmc_type="full_3d", N=4)
    seeds = np.arange(2, dtype=np.uint32)
    plain = runner.run_chains(seeds, spec)
    ck = Checkpointer(str(tmp_path), tag="f3d", every=1, min_segments=2)
    first = runner.run_chains(seeds, spec, checkpointer=ck)
    np.testing.assert_array_equal(plain.energy_history, first.energy_history)
    # resume from the completed checkpoint: should short-circuit to the end
    again = runner.run_chains(seeds, spec, checkpointer=ck)
    np.testing.assert_array_equal(plain.final_state, again.final_state)


def test_stale_checkpoint_is_ignored(tmp_path):
    """A checkpoint written under a different config must not be loaded."""
    ck = Checkpointer(str(tmp_path), tag="x", every=1, min_segments=2)
    spec_a = _spec(n_steps=400)
    seeds = np.arange(4, dtype=np.uint32)
    runner.run_chains(seeds, spec_a, checkpointer=ck)
    # Different chain count => different carry shapes under the same tag.
    fresh = runner.run_chains(np.arange(6, dtype=np.uint32), spec_a,
                              checkpointer=ck)
    plain = runner.run_chains(np.arange(6, dtype=np.uint32), spec_a)
    np.testing.assert_array_equal(fresh.energy_history, plain.energy_history)


def test_profiler_trace_and_throughput_report(tmp_path):
    """profile_dir writes a jax.profiler trace; throughput props are sane."""
    from mcqueens.utils import profiling

    spec = _spec(n_steps=200)
    res = runner.run_chains(
        np.arange(2, dtype=np.uint32), spec, profile_dir=str(tmp_path / "tr")
    )
    assert res.proposals == 2 * 200
    assert res.moves_per_sec > 0
    rep = profiling.throughput_of(res, n_devices=2)
    assert rep.moves_per_sec_per_chip == rep.moves_per_sec / 2
    assert "proposals" in str(rep)
    assert any((tmp_path / "tr").rglob("*"))  # trace files were written
