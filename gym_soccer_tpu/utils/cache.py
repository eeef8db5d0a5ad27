"""JAX's persistent compilation cache, in one place.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives at ``.jax_cache`` in the
checkout (listed in .gitignore) -- one fixed path, so that later runs
from the same checkout hit it.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory (call
    before the first compile); returns the directory in use."""
    import jax
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
