"""The persistent compile cache honours JAX_COMPILATION_CACHE_DIR and
otherwise lives at one fixed path inside the checkout."""

from pathlib import Path

import jax

from come_tpu import compile_cache


def test_env_var_wins_and_config_untouched(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    repo = Path(__file__).resolve().parents[1]
    assert Path(got) == repo / ".jax_cache"
    # the same path on every call: it is part of what a later run finds
    assert compile_cache.enable_compile_cache() == got
    jax.config.update("jax_compilation_cache_dir", before)
    ignored = (repo / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
