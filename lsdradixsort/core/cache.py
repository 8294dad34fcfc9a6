"""Persistent XLA compilation cache placement.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets no other directory. Otherwise the cache lives at one fixed
path inside the checkout (`.jax_cache/`, listed in .gitignore): the path
is part of the cache's key, so a directory that moves never hits.
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_persistent_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory."""
    d = os.environ.get(ENV_VAR)
    if not d:
        d = CHECKOUT_DIR
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return d
