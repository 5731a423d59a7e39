"""Persistent XLA compilation cache enablement.

The deep elimination/refactorization programs (block_cholesky,
incremental_cholesky) compile in seconds; caching them across runs makes
repeat solves of a dataset start in milliseconds.  Fills the role the
reference gets for free from ahead-of-time C++ compilation.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory.  Otherwise the cache lives at the fixed path
``<repo>/.jax_cache`` (gitignored), fixed so that every run from one
checkout finds the entries of the runs before it.
"""

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")

_enabled = False


def enable_compilation_cache() -> str:
    """Idempotently turn on JAX's persistent compilation cache.  Returns
    the directory in use."""
    global _enabled
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR
    if not _enabled:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
        _enabled = True
    return cache_dir
