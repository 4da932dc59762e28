"""Process set-up shared by the benchmark, the example CLIs and the tests:
the persistent compilation cache and the check for a GPU."""

from __future__ import annotations

import os

import jax

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory: ``$JAX_COMPILATION_CACHE_DIR`` when set, else
    ``.jax_cache/`` at the root of the checkout.  The path is fixed
    because it is part of the cache key: a directory that moves between
    runs never hits."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


def require_gpu(what: str = "the filter kernel") -> None:
    """Raise unless JAX's default device is a GPU.  The Triton kernel
    compiles only for one, and no path falls back to another device."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"{what} needs a GPU; JAX's default device is "
            f"{dev.platform} ({dev.device_kind})")


__all__ = ["enable_compile_cache", "require_gpu", "DEFAULT_CACHE_DIR"]
