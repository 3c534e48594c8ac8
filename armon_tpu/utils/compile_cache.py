"""Where the entry points keep JAX's persistent compilation cache.

A cache directory is part of the cache's key, so it must not move between
runs: with `JAX_COMPILATION_CACHE_DIR` set, JAX uses that directory and
nothing is set here; otherwise the cache goes to `.jax_cache` at the root
of the checkout (listed in `.gitignore`).
"""

import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory and
    return that directory. Called by the entry points (`python -m
    armon_tpu`, `bench.py`, `chip_smoke.py`), never at import."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE
