"""kaamer_jax.compile_cache: the variable wins; otherwise a fixed path."""

import os

import jax

from kaamer_jax import compile_cache


def _restoring_config(fn):
    before = jax.config.jax_compilation_cache_dir
    try:
        return fn()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_env_variable_is_used_and_nothing_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))

    def check():
        jax.config.update("jax_compilation_cache_dir", "/sentinel/unchanged")
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == "/sentinel/unchanged"
        assert not os.path.exists("/sentinel/unchanged")

    _restoring_config(check)


def test_unset_gives_fixed_in_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")

    def check():
        assert compile_cache.enable_compile_cache() == want
        assert compile_cache.enable_compile_cache() == want  # stable
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)

    _restoring_config(check)
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
