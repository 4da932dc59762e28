"""Process set-up helpers (ssme_tpu/runtime.py): where the persistent
compilation cache lives, and the refusal to run GPU-only paths on
another device."""

import os
import subprocess
import sys

import jax
import pytest

from ssme_tpu import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_child(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    code = ("import jax; from ssme_tpu.runtime import enable_compile_cache;"
            "p = enable_compile_cache();"
            "print(p); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def test_compile_cache_honours_env(tmp_path):
    path = str(tmp_path / "cache")
    returned, configured = _cache_dir_in_child(path)
    assert returned == configured == path


def test_compile_cache_default_is_fixed_in_checkout():
    returned, configured = _cache_dir_in_child(None)
    assert returned == configured == os.path.join(REPO, ".jax_cache")
    assert runtime.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    # the directory is ignored by git: caches are never committed
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        runtime.require_gpu("this path")
