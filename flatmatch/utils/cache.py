"""Persistent XLA compilation cache.

Where JAX_COMPILATION_CACHE_DIR is set, JAX keeps its cache in that
directory and this module sets nothing. Otherwise the cache lives at a fixed
path inside the checkout, `.jax_cache` (the path is part of each entry's
key, so a directory that moves never hits). Enabled by the CLI, bench.py
and chip_smoke.py; FLATMATCH_NO_COMPILE_CACHE=1 opts out.
"""
from __future__ import annotations

import os
import pathlib
from typing import Optional

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> Optional[str]:
    """Turn the cache on; returns its directory, or None when disabled."""
    if os.environ.get("FLATMATCH_NO_COMPILE_CACHE") == "1":
        return None
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    DEFAULT_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return str(DEFAULT_DIR)
