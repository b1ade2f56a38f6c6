"""Persistent XLA compilation cache, set up one way by every entry point.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
here overrides it. Otherwise the cache lives in `.jax_cache/` at the
root of the checkout (listed in .gitignore), a fixed path so that
repeated runs hit it.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
