"""Persistent XLA compilation cache.

A cold CLI or bench run compiles every program in the pipeline (operator
matvec, CG loop, V-cycle, refinement sweep).  JAX's persistent compilation
cache keeps the serialized executables across processes, so the second
invocation of a driver skips straight to execution.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives at ``<checkout>/.jax_cache``:
a fixed path, since the path is part of what the cache is keyed on.
Opt-out: ``DDPS_NO_COMPILE_CACHE=1`` (e.g. when timing compilation itself).
"""

from __future__ import annotations

import os
import pathlib

__all__ = ["enable_persistent_cache"]

_DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_persistent_cache() -> str | None:
    """Turn on JAX's persistent compilation cache (idempotent).

    Returns the cache directory, or None when disabled via the environment.
    """
    if os.environ.get("DDPS_NO_COMPILE_CACHE", "").strip() == "1":
        return None
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    os.makedirs(_DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(_DEFAULT_DIR))
    return str(_DEFAULT_DIR)
