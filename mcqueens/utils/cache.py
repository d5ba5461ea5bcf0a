"""Persistent XLA compile cache.

Compiling the samplers takes seconds to minutes per (spec, shape); caching
executables on disk makes every CLI/bench invocation after the first fast.
Call :func:`enable` early in any entry point (before first compile).

Placement: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads that
variable itself, and nothing here overrides it); otherwise the fixed path
``<repo>/.jax_cache``.  The path is part of the cache key, so it must not
move between runs.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache uses (see the module docstring)."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Turn on the persistent cache for every compile; returns its path."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
