"""Persistent XLA compile cache location, shared by every entry point.

A cold run compiles (and, on a GPU, autotunes) every program shape it
meets; the persistent cache makes the second run of a shape cheap. The
cache key includes the directory, so the directory must not move
between runs: ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it
itself), otherwise the fixed ``<repo>/.jax_cache`` is used. Never a
temporary, per-process or time-based path.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``JAX_COMPILATION_CACHE_DIR``
    (left to JAX itself, which reads it) or else ``DEFAULT_CACHE_DIR``,
    and cache every compiled program regardless of size or compile
    time. Returns the directory in use."""
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env_dir:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return env_dir or DEFAULT_CACHE_DIR
