"""Persistent XLA compilation cache at one fixed place.

A cold compile of the 512^3 step takes tens of seconds; with the cache a
rerun loads it. The cache key includes the directory, so the directory must
not move between runs: `JAX_COMPILATION_CACHE_DIR` when the environment sets
it (JAX reads that variable itself), else `.jax_cache` at the root of the
checkout, which `.gitignore` lists.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    Call before the first compile. Sets no directory when
    `JAX_COMPILATION_CACHE_DIR` is set."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
