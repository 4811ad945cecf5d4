"""Persistent XLA compilation cache setup.

Every process that runs the pipeline compiles the same program shapes;
the persistent cache makes each shape a one-time cost across processes.
The directory is part of what makes a cached program findable again, so
it never depends on the working directory: JAX_COMPILATION_CACHE_DIR
when it is set, else the fixed `.jax_cache` at the root of the checkout.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
