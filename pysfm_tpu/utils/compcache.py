"""Persistent XLA compilation cache.

Compiled executables are serialized to a cache directory keyed by (HLO,
compile options, backend version), so a second process re-loads them
instead of recompiling — the incremental pipeline's shape buckets and the
bench entry points each compile several programs per cold process.

Where the directory is:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and this module
  sets no directory in code;
- otherwise a fixed directory inside the checkout, ``<repo>/.jax_cache``
  (listed in ``.gitignore``).  A fixed path matters: the path is part of
  what a later process must find again.

Call :func:`enable_compilation_cache` once, before the first jit dispatch
(the bench entry points and ``chip_smoke.py`` do).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Enable jax's persistent compilation cache; returns the directory.

    Safe to call repeatedly.  Thresholds are set so even sub-second
    executables are cached: the incremental pipeline's shape-bucket
    programs all compile quickly, and all of them should hit the cache in
    a warm process.
    """
    import jax

    d = os.environ.get(ENV_VAR)
    if not d:
        d = DEFAULT_DIR
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return d
