"""Persistent compilation cache, set up the same way by every entry point.

The cache directory is part of what makes an entry hit, so it lives at a
fixed path: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it
(JAX reads that variable itself, and nothing is set here), otherwise
``<checkout>/.jax_cache`` (listed in .gitignore).
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compilation cache at its fixed directory and
    return that directory. Call before the first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return DEFAULT_DIR
