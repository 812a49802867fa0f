"""Persistent XLA compilation cache helper.

First compiles of the chunked round and steer programs take tens of seconds;
the persistent cache turns a warm process start into loads.  Call before the
first jit executes.
"""
from __future__ import annotations

import os

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_persistent_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets no directory; otherwise the cache lives at the fixed
    ``<repo>/.jax_cache`` (a fixed path, because the path is part of the
    cache key).
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = REPO_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return path
