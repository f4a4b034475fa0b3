"""Where JAX keeps its persistent compilation cache."""

from __future__ import annotations

import os

#: the directory that holds the package: the checkout root
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enable_compile_cache(min_compile_secs: float | None = None) -> str:
    """Give JAX's persistent compilation cache one fixed directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the cache (JAX reads it
    itself) and no other path is set here. Otherwise the cache is
    ``<checkout>/.jax_cache``: a fixed path, so later runs of the same
    checkout find what earlier ones compiled. ``min_compile_secs`` lowers
    the compile-time threshold for caching an executable (tests cache
    everything). Returns the directory in use.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(_ROOT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    if min_compile_secs is not None:
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs", min_compile_secs
        )
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
