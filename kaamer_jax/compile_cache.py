"""Where JAX keeps its persistent compilation cache.

Every entry point that compiles (the server, bench.py, chip_smoke.py, the
tests) calls enable_compile_cache() before its first compile, so a warm
cache from an earlier run of any of them is found again.  The cache key
includes the directory, so the directory is fixed: never a temporary name,
a process id or a time.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory.  JAX_COMPILATION_CACHE_DIR, when set, wins and nothing
    is changed (JAX reads the variable itself); otherwise the cache lives in
    .jax_cache at the root of the checkout.  Errors propagate."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
