"""JAX's persistent compilation cache, at one fixed place.

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
nothing here changes any setting.  Otherwise the cache lives in
``<checkout>/.jax_cache`` (listed in .gitignore).  The path is part of
every cache key, so it is never built from a temporary name, a process id
or the time.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
