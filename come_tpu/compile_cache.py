"""Persistent XLA compilation cache at a fixed place.

Every entry point (``come_tpu.main``, ``bench.py``, ``chip_smoke.py``,
``__graft_entry__.py``) calls :func:`enable_compile_cache` before its first
compile.  If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing is changed here; otherwise the cache lives in ``.jax_cache/`` at the
root of the checkout (listed in ``.gitignore``).  The path is fixed because
it is part of what a later run must find again.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
