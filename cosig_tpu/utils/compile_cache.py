"""JAX's persistent compilation cache, placed from outside the program.

Compiling a full-size frame takes tens of seconds, and every CLI call,
benchmark and smoke run is a fresh process. Where the environment sets
``JAX_COMPILATION_CACHE_DIR``, JAX reads it itself and nothing here
overrides it; otherwise the cache lives in ``<checkout>/.jaxcache``, a
fixed path (the path is part of the cache key, so a moving directory
would never hit)."""

from __future__ import annotations

import os
import pathlib

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_DIR = CHECKOUT / ".jaxcache"


def enable_compile_cache() -> str:
    """Point JAX's compilation cache at its directory; return that path.

    Call before the first compile: JAX fixes the cache at that point."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
