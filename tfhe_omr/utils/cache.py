"""Where compiled programs are cached between processes.

The XLA compilation cache lives in a fixed, git-ignored directory of the
checkout (``.cache/jax``): the path is part of a cache entry's key, so a
directory that moves never hits. ``JAX_COMPILATION_CACHE_DIR``, when set,
takes its place and is used as it stands.
"""

from __future__ import annotations

import os
import pathlib

CACHE_ROOT = pathlib.Path(__file__).resolve().parents[2] / ".cache"


def compile_cache_dir(environ=os.environ) -> str | None:
    """The XLA compilation cache directory this package must set, or None
    when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(CACHE_ROOT / "jax")
