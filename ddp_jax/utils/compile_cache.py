"""Persistent XLA compile cache shared by every entry point.

The batched solver programs are large, and a cold compile is a large part of
a short run.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and this module sets no directory.  Otherwise the cache lives at the fixed,
git-ignored ``<repo>/.jax_cache``: the path is part of the cache key, so a
directory that moves never hits.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def setup_compile_cache(min_compile_time_s: float = 1.0) -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_time_s)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
