"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads the variable itself
and nothing here overrides it.  Otherwise the cache goes to
``<repo>/.jax_cache``, a fixed path, because the directory is part of the
cache key and a cache that moves never hits.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    path = os.environ.get(ENV_VAR)
    if not path:
        path = os.path.join(REPO_ROOT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
