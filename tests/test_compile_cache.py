"""The persistent compile cache helper: JAX_COMPILATION_CACHE_DIR wins,
otherwise one fixed path under the repository."""

import os

import jax
import pytest

from asgart_tpu import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_is_left_to_jax(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "/sentinel")
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    # the helper set no directory of its own
    assert jax.config.jax_compilation_cache_dir == "/sentinel"


def test_fixed_repo_path_without_env(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.configure_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    # the same path every time: never temporary or per-process
    assert compile_cache.configure_compile_cache() == got
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0
