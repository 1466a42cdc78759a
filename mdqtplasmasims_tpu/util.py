"""Small runtime utilities."""

from __future__ import annotations

import os

import jax

#: Compile-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is
#: unset: a fixed path in the checkout (listed in .gitignore), so the
#: cache key never depends on a temporary name, a process id or the time.
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compilation_cache() -> str | None:
    """Wire JAX's persistent compilation cache; every entry point (cli,
    bench, chip_smoke, tools) calls this before tracing.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already caches there and
    no other path is set in code.  Otherwise the cache goes to
    ``<checkout>/.jax_cache``.  ``MDQT_NO_COMPILE_CACHE=1`` opts out.
    Returns the cache directory, or None when disabled."""
    if os.environ.get("MDQT_NO_COMPILE_CACHE"):
        return None
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CHECKOUT_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program that took noticeable compile time
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    return path
