"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR wins; otherwise a
fixed path inside the checkout."""

import os
import subprocess

import jax

from cvxcompress_tpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_environment_variable_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_default_is_a_fixed_ignored_path_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == os.path.join(ROOT, ".jax_cache")
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", ".jax_cache/"], cwd=ROOT,
    ).returncode == 0
    tracked = os.path.exists(os.path.join(ROOT, ".git"))
    assert ignored or not tracked


def test_enable_sets_the_one_cache(monkeypatch, tmp_path):
    kept = jax.config.jax_compilation_cache_dir
    assert kept == cache.cache_dir()  # conftest enabled the helper's choice
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", kept)
