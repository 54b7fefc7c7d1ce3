"""Persistent XLA compilation cache.

``enable()`` points JAX's compilation cache at ONE directory so bench.py,
chip_smoke.py, the tools/ scripts and repeat invocations share compiled
programs across processes: ``JAX_COMPILATION_CACHE_DIR`` when it is set
(the code then sets no other), otherwise ``<repo>/.xla_cache/`` inside the
checkout (listed in .gitignore) — a fixed path, since the path is part of
the cache key.
"""

from __future__ import annotations

import os
from pathlib import Path

_DEFAULT = str(Path(__file__).resolve().parents[2] / ".xla_cache")


def cache_dir() -> str:
    """The directory enable() uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT


def enable() -> str | None:
    """Idempotently enable the persistent compilation cache. Returns the
    cache dir, or None when the directory cannot be created.

    Safe to call before OR after jax initializes: the env var is set first
    (it wins if jax has not started yet) and jax.config is updated to
    match (covers an already-initialized jax)."""
    target = cache_dir()
    try:
        os.makedirs(target, exist_ok=True)
    except OSError:
        return None
    os.environ["JAX_COMPILATION_CACHE_DIR"] = target
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2")
    import jax
    if jax.config.jax_compilation_cache_dir != target:
        jax.config.update("jax_compilation_cache_dir", target)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return target
