"""Where the persistent compile cache lives (p265_tpu/compile_cache.py)."""
import os

from p265_tpu import compile_cache


def test_cache_dir_honours_env_var(tmp_path):
    env = {compile_cache.ENV_VAR: str(tmp_path / "cc")}
    assert compile_cache.cache_dir(env) == str(tmp_path / "cc")


def test_cache_dir_default_is_fixed_in_checkout():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.cache_dir({}) == os.path.join(repo, ".jax_cache")
    assert compile_cache.cache_dir({compile_cache.ENV_VAR: ""}) == \
        compile_cache.DEFAULT_DIR
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_stays_off_on_cpu():
    assert not compile_cache.enable_persistent_cache()
