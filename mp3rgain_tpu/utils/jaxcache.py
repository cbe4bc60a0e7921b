"""Persistent XLA compilation cache.

A fresh process otherwise recompiles every analysis pipeline it runs
(the beets deployment starts one process per album). JAX's persistent
cache stores serialized executables keyed by computation hash, so the
next process reuses them.

Where the cache lives:
  - ``JAX_COMPILATION_CACHE_DIR``, when set (JAX reads it itself; this
    module then sets nothing);
  - otherwise ``<checkout>/.cache/xla`` — a fixed path, because the
    directory is part of what a later process must find again.

Called from the analysis entry modules (not the package __init__: pure
bitstream operations must not pay the jax import).
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".cache", "xla")

_DONE = False


def cache_dir() -> str:
    """The directory the compilation cache uses in this process."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def ensure_compilation_cache() -> None:
    """Point jax at the persistent executable cache (idempotent)."""
    global _DONE
    if _DONE:
        return
    _DONE = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
