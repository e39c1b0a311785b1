"""Where the persistent XLA compilation cache lives.

One rule for every entry point (tests, benchmarks, chip_smoke.py): when
`JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing here
overrides it; otherwise the cache is `.jax_cache/` at the root of the
checkout — a fixed path, because the path is part of the cache key.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at the checkout's
    `.jax_cache/` unless `JAX_COMPILATION_CACHE_DIR` is set. Returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return CACHE_DIR
