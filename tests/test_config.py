"""tpuwave.config: the persistent compile-cache placement."""

import jax

from tpuwave import config


def test_compile_cache_env_wins(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert config.enable_compile_cache() == "/some/where"
    # JAX reads the variable itself; the helper sets nothing else
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = config.enable_compile_cache()
        assert path == str(config.CHECKOUT_ROOT / ".jax_cache")
        assert (config.CHECKOUT_ROOT / "tpuwave" / "config.py").exists()
        assert jax.config.jax_compilation_cache_dir == path
        # the same fixed path on every call
        assert config.enable_compile_cache() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
