"""Where JAX keeps its persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses it and nothing is set
here. Otherwise the cache goes to ``.jax_cache`` at the root of the
checkout (listed in ``.gitignore``): a fixed path, because the path is
part of what the cache matches on.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def setup_compile_cache() -> str:
    """Point JAX's compilation cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
