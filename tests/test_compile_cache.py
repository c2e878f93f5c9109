"""Where compiled programs persist (swipe_tpu.cli._enable_compile_cache)."""

import os

import jax
import pytest

from swipe_tpu import cli


@pytest.fixture
def recorded(monkeypatch):
    """The cache settings _enable_compile_cache makes, recorded instead
    of applied."""
    made, updates = [], {}
    monkeypatch.setattr(os, "makedirs",
                        lambda p, exist_ok=False: made.append(p))
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    return made, updates


def test_cache_dir_is_fixed_inside_the_checkout():
    root = os.path.dirname(os.path.dirname(os.path.abspath(cli.__file__)))
    assert cli.CACHE_DIR == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_accelerator_caches_in_the_fixed_dir(monkeypatch, recorded):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    cli._enable_compile_cache()
    made, updates = recorded
    assert made == [cli.CACHE_DIR]
    assert updates["jax_compilation_cache_dir"] == cli.CACHE_DIR


def test_environment_dir_is_left_to_jax(monkeypatch, recorded):
    """With JAX_COMPILATION_CACHE_DIR set, JAX puts the cache there and
    the program sets nothing else."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    cli._enable_compile_cache()
    assert recorded == ([], {})


def test_cpu_keeps_no_cache(monkeypatch, recorded):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    cli._enable_compile_cache()
    assert recorded == ([], {})
