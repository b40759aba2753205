"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR wins untouched;
otherwise one fixed directory inside the checkout."""

from pathlib import Path

import jax
import pytest

from misonet_tpu.utils.cache import CACHE_DIR, enable_compile_cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_set_leaves_config_alone(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    jax.config.update("jax_compilation_cache_dir", None)
    assert enable_compile_cache() == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir is None


def test_env_var_unset_uses_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == str(ROOT / ".jax_cache") == str(CACHE_DIR)
    assert jax.config.jax_compilation_cache_dir == path
    # the same path on every call: nothing temporary, per-process or timed
    assert enable_compile_cache() == path
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()
