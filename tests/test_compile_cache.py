"""The persistent compile cache follows JAX_COMPILATION_CACHE_DIR when it
is set and ``<repo>/.jax_cache`` otherwise."""

import os

import jax
import pytest

from open3d_slam_jax.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "/some/cache/dir"])
def test_enable_compile_cache(monkeypatch, env_dir):
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        if env_dir is None:
            assert path == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
        else:
            assert path == env_dir
            # JAX reads the variable itself; nothing else is set.
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
