"""Where the entry points put JAX's persistent compilation cache."""

import os
import subprocess
import sys

import jax

from tensor_ops.utils import compile_cache as cc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins_and_sets_nothing(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    assert cc.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_the_checkout_dir(monkeypatch):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cc.use_compile_cache() == cc.CHECKOUT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == cc.CHECKOUT_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert cc.CHECKOUT_CACHE_DIR == os.path.join(ROOT, ".jax_cache")


def test_checkout_dir_is_git_ignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_library_import_leaves_the_cache_alone():
    """Importing the package sets no cache directory."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop(cc.ENV_VAR, None)
    code = ("import jax, tensor_ops, tensor_ops.models, "
            "tensor_ops.parallel; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None"
