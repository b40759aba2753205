"""JAX's persistent compilation cache at one fixed place.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives in ``.jax_cache`` at the
root of the checkout (listed in .gitignore), so every entry point of one
checkout shares it, and the path never moves between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
