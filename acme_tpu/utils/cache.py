"""JAX's persistent compilation cache for this package's programs."""

from __future__ import annotations

import os

import jax

# the cache's directory when JAX_COMPILATION_CACHE_DIR is not set: a fixed
# directory of the checkout (listed in .gitignore)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache so a process restart
    reuses compiled programs instead of paying the compile again -- the
    analog of the reference's precompile directives (ACME.jl:779-816).

    The directory is ``JAX_COMPILATION_CACHE_DIR`` when that is set, and
    :data:`CACHE_DIR` otherwise.  Idempotent; returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    # cache every program regardless of size/compile time
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
