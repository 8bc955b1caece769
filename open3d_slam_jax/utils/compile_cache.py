"""Persistent XLA compile cache location.

One rule for every entry point (``cli.main``, ``bench.py``,
``chip_smoke.py``): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
uses it and nothing else is set; otherwise the cache lives at the fixed
path ``<repo>/.jax_cache``. The path is part of the cache key, so it never
depends on a temporary name, a pid or the time.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
