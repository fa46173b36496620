"""Persistent XLA compile cache location.

One rule for every entry point (``chip_smoke.py``, ``bench.py``, the viewer
CLI): the cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is set
(JAX reads the variable itself), and otherwise in ``.jax_cache/`` at the
repository root — a fixed path, since the path is part of the cache key.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(environ=os.environ) -> str:
    """The directory the compile cache uses under ``environ``."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`;
    returns the directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
