"""Persistent JAX compilation cache at one fixed place.

`enable_compile_cache()` is called once per process by every entry
point (the CLI, bench.py, chip_smoke.py, the test harness) before the
first compile. When `JAX_COMPILATION_CACHE_DIR` is set, JAX already
reads it and nothing is set here; otherwise the cache lives in
`<repo>/.jax_cache`. The path is part of every cache key, so it never
depends on the host, the process or the time.
"""
from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache():
    """Turn the persistent cache on; returns its directory."""
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    if os.environ.get(ENV):
        return os.environ[ENV]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
