"""Where compiled programs persist between processes.

A cold process compiles every jitted program it runs, the whole-epoch train
``lax.scan`` among them. JAX's persistent compilation cache keeps the
results on disk. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing is set here. Otherwise the cache lives at
``build/jax_cache`` in the checkout: a fixed path, because the path is part
of what a later process must find again.
"""

from __future__ import annotations

import os
from typing import Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir(repo_root: str = REPO_ROOT) -> str:
    return os.path.join(repo_root, "build", "jax_cache")


def enable_compile_cache(repo_root: str = REPO_ROOT) -> Optional[str]:
    """Point JAX's persistent compile cache at ``build/jax_cache`` unless
    ``JAX_COMPILATION_CACHE_DIR`` is set. Returns the directory this call
    set, or None when the environment decides."""
    if os.environ.get(ENV_VAR):
        return None
    import jax

    path = default_cache_dir(repo_root)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
