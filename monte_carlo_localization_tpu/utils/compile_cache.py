"""The one persistent compilation cache of every entry point.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache is
``.jax_cache/`` at the repository root (listed in ``.gitignore``). The
path is fixed because it is part of the cache's key: a directory that
moves never hits. Call :func:`enable_compile_cache` before the first
compile.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> Path:
    """Point JAX's persistent compilation cache at
    ``$JAX_COMPILATION_CACHE_DIR`` or :data:`DEFAULT_CACHE_DIR` and return
    that directory."""
    import jax

    path = Path(os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", str(path))
    return path
