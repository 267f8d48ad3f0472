"""JAX's persistent compilation cache: one place decides where it lives.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it and that directory is the
only cache.  Otherwise the cache lives at a fixed path inside the checkout
(`.jax_cache/`, listed in .gitignore), so a later process of the same
checkout finds what an earlier one compiled.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__
    )))),
    ".jax_cache",
)


def cache_dir():
    """The compile cache directory this process uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable_compile_cache():
    """Point JAX's persistent compilation cache at cache_dir(); returns it.

    Call before the first compilation.  Programs that compile in under a
    second are not cached."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
