"""The persistent compilation cache helper (utils/compile_cache.py)."""

import os

import jax
import pytest

from exaadmm_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_is_honoured(monkeypatch, tmp_path, restore_cache_dir):
    """JAX_COMPILATION_CACHE_DIR wins, and no other directory is set."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_fixed_checkout_dir_otherwise(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # the same path on every call: never per process or per run
    assert compile_cache.enable_compile_cache() == path
