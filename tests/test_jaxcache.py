"""The persistent compile cache lives where JAX_COMPILATION_CACHE_DIR
says, else at one fixed path whatever the working directory."""

import os

import jax
import pytest

from bcalm_tpu.utils import jaxcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {key: getattr(jax.config, key) for key in keys}
    yield
    for key, val in saved.items():
        jax.config.update(key, val)


def test_follows_env_var(tmp_path, monkeypatch, restore_cache_config):
    want = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert jaxcache.enable_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)


def test_fixed_path_from_any_cwd(tmp_path, monkeypatch,
                                 restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    for cwd in (tmp_path, tmp_path.parent):
        monkeypatch.chdir(cwd)
        assert jaxcache.enable_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
