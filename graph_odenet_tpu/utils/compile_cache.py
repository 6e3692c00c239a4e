"""One rule for where JAX keeps its persistent compilation cache.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing is set
  here.
* Otherwise: ``<repo>/.jax_cache``, a fixed path inside the checkout
  (listed in ``.gitignore``).  The path is part of the cache key, so a
  fixed one is what lets a later process find earlier compilations.

Every entry point (``cli.main``, ``bench.py``, ``chip_smoke.py``, the
scripts, the test suite) calls :func:`configure_compile_cache` before its
first compilation.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["DEFAULT_CACHE_DIR", "configure_compile_cache"]

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Apply the rule above; returns the cache directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
