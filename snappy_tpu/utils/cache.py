"""JAX's persistent compilation cache, in one place for every entry script.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here. Otherwise the cache goes to ``<repo>/.jax_cache``: a fixed path,
since the path is part of what a later process must find again.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO, ".jax_cache")


def cache_dir() -> str | None:
    """The directory to set in code: None when the environment names one."""
    return None if os.environ.get(ENV) else DEFAULT_DIR


def enable() -> str:
    """Turn the cache on; returns the directory in use."""
    path = cache_dir()
    if path is None:
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    return path
