"""Run-time environment: compile-cache placement, lazy optional imports,
removed options, and the benchmark's refusal to measure on the CPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from mcqueens.core import rng as rng_mod
from mcqueens.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, env_update=None, drop=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in drop:
        env.pop(k, None)
    env.update(env_update or {})
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


# --- compile cache -------------------------------------------------------


def test_cache_dir_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


@pytest.mark.parametrize("value", [None, ""])
def test_cache_dir_defaults_inside_the_checkout(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(cache.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(cache.ENV_VAR, value)
    assert cache.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_suite_uses_the_program_cache_location():
    assert jax.config.jax_compilation_cache_dir == cache.cache_dir()


_COMPILE = """
import jax, jax.numpy as jnp
from mcqueens.utils import cache
print(cache.enable())
jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
"""


def test_env_cache_dir_receives_the_executables(tmp_path):
    target = tmp_path / "jc"
    proc = _python(_COMPILE, {cache.ENV_VAR: str(target)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == [str(target), str(target)]
    assert target.is_dir() and any(target.iterdir())


def test_unset_env_uses_the_fixed_repo_path():
    proc = _python(_COMPILE, drop=(cache.ENV_VAR,))
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = os.path.join(REPO, ".jax_cache")
    assert proc.stdout.split() == [want, want]


# --- optional imports stay off the main path ----------------------------

_MAIN_PATH = [
    "mcqueens.chain.board", "mcqueens.chain.full3d", "mcqueens.core.tables",
    "mcqueens.core.init", "mcqueens.dist.runner", "mcqueens.dist.mesh",
    "mcqueens.search.tempering", "mcqueens.cli.competition",
    "mcqueens.utils.checkpoint", "mcqueens.utils.profiling",
    "mcqueens.experiments.config", "mcqueens.experiments.drivers",
    "chip_smoke", "bench",
]


@pytest.mark.parametrize("module", _MAIN_PATH)
def test_main_path_import_loads_no_optional_package(module):
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            f"print(sorted(m for m in ('yaml', 'matplotlib', 'pandas') "
            f"if m in sys.modules))")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


# --- removed kernels -----------------------------------------------------


@pytest.mark.parametrize("kernel", ["pallas", "pallas_shared"])
def test_competition_rejects_removed_kernels(kernel, capsys, tmp_path):
    from mcqueens.cli import competition

    with pytest.raises(SystemExit) as exc:
        competition.main(["--kernel", kernel, "--outdir", str(tmp_path)])
    assert exc.value.code == 2
    assert "was removed" in capsys.readouterr().err


def test_competition_rejects_unknown_kernels(capsys, tmp_path):
    from mcqueens.cli import competition

    with pytest.raises(SystemExit):
        competition.main(["--kernel", "cuda", "--outdir", str(tmp_path)])
    assert "must be one of" in capsys.readouterr().err


def test_bench_refuses_to_measure_on_the_cpu(capsys):
    import bench

    assert bench.main(["--quick"]) == 2
    assert "needs an NVIDIA GPU" in capsys.readouterr().err


# --- the swap-stream hash ------------------------------------------------


def _np_lowbias32(z):
    z = np.asarray(z, np.uint32).astype(np.uint64)
    m = np.uint64(0xFFFFFFFF)
    z ^= z >> np.uint64(16)
    z = (z * np.uint64(0x7FEB352D)) & m
    z ^= z >> np.uint64(15)
    z = (z * np.uint64(0x846CA68B)) & m
    z ^= z >> np.uint64(16)
    return z.astype(np.uint32)


def test_lowbias32_matches_a_uint32_reference():
    x = np.random.default_rng(0).integers(0, 2 ** 32, 4096, dtype=np.uint64)
    x = np.concatenate([x, [0, 1, 2 ** 31, 2 ** 32 - 1]]).astype(np.uint32)
    got = np.asarray(rng_mod.lowbias32(x.view(np.int32))).view(np.uint32)
    np.testing.assert_array_equal(got, _np_lowbias32(x))


def test_uniform01_is_a_24_bit_grid_in_unit_interval():
    w = np.random.default_rng(1).integers(
        -2 ** 31, 2 ** 31, 8192, dtype=np.int64).astype(np.int32)
    u = np.asarray(rng_mod.uniform01(w), np.float64)
    assert u.min() >= 0.0 and u.max() < 1.0
    np.testing.assert_array_equal(u * 2 ** 24, np.floor(u * 2 ** 24))
    want = ((w.view(np.uint32) >> 7) & 0xFFFFFF) / 2.0 ** 24
    np.testing.assert_array_equal(u, want)
