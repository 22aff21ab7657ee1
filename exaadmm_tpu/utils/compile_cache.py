"""JAX's persistent compilation cache, at one fixed place per checkout.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache directory (JAX reads
it itself) and no other directory is set here. Otherwise the cache lives at
``<checkout>/.jax_cache``: a fixed path, because the path is part of the
cache key, so a directory that moves from run to run never hits.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path
