"""Persistent XLA compile cache location, shared by the CLI, bench.py and
chip_smoke.py.

If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing else is
set here. Otherwise the cache lives at a fixed directory inside the checkout
(`.jax_cache/`, git-ignored): a fixed path, because the path is part of the
cache key, so a directory that moves between runs never hits.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """The directory the compile cache uses."""
    return os.environ.get(ENV) or REPO_CACHE


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at compile_cache_dir() and
    return that directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    return path
