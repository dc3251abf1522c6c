"""Persistent XLA compilation cache.

The Stage-B programs of a 1080p stream take tens of seconds to compile.
With JAX's on-disk compilation cache a later process loads them from disk
instead.  The directory is `$JAX_COMPILATION_CACHE_DIR` when that is set
(JAX reads it itself, so no directory is set here); otherwise it is the
fixed path `<checkout>/.jax_cache`, which `.gitignore` lists.  A fixed path
matters: the cache key covers the program, and a directory that moved
would never hit.

Call enable_persistent_cache() before the first device dispatch (TpuDecoder
does this).  The cache stays off on the CPU backend: XLA:CPU executables
serialized on one host can carry machine features another lacks, and the
cache write has crashed the test suite's forced-CPU processes.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")

_ENABLED = False


def cache_dir(environ=os.environ) -> str:
    """The directory the compile cache uses: the environment's choice, else
    the fixed in-checkout default."""
    return environ.get(ENV_VAR) or DEFAULT_DIR


def enabled() -> bool:
    return _ENABLED


def enable_persistent_cache() -> bool:
    """Turn on JAX's on-disk compilation cache on any non-CPU backend.

    Returns True if the cache is (now) enabled.  Safe to call repeatedly."""
    global _ENABLED
    if _ENABLED:
        return True
    import jax
    if jax.default_backend() == "cpu":
        return False
    if not os.environ.get(ENV_VAR):
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    # cache everything that took >1 s to compile, regardless of size
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    _ENABLED = True
    return True
