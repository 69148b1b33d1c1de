"""Where the persistent caches live: $JAX_COMPILATION_CACHE_DIR when it is
set, else the fixed `.jax_cache/` of the checkout, so a cache written by
one process is found by the next one on the same checkout."""

import os

import jax

import calipso_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_root_honours_env(monkeypatch, tmp_path):
    from calipso_tpu.utils import aot

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert calipso_tpu.cache_root() == str(tmp_path)
    assert aot.cache_path("t", "fp").startswith(str(tmp_path / "aot") + os.sep)


def test_cache_root_default_is_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert calipso_tpu.cache_root() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_xla_cache_stays_off_on_cpu(monkeypatch):
    """On the CPU the compilation cache stays off (XLA:CPU entries carry
    host machine code), and no directory is set behind the caller's back."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(calipso_tpu, "_cache_decided", False)
    before = jax.config.jax_compilation_cache_dir
    calipso_tpu._maybe_enable_cache()
    assert not calipso_tpu._on_accelerator()
    assert jax.config.jax_compilation_cache_dir == before
