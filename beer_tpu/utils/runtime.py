"""Process set-up shared by the CLI, the benchmark and the smoke check:
the persistent compile cache and the choice of device."""

from __future__ import annotations

import os
from pathlib import Path

import jax

# <checkout>/.jax_cache — a fixed path, so every run of this checkout
# finds what earlier runs compiled
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Place JAX's persistent compile cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is left to JAX, which reads
    it itself; otherwise the cache goes to ``<checkout>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def select_device(device: str) -> None:
    """``auto`` keeps JAX's default platform, ``cpu`` pins the CPU, and
    ``gpu`` fails unless JAX finds a GPU.  Nothing falls back."""
    if device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif device == "gpu":
        try:
            jax.devices("gpu")
        except RuntimeError as exc:
            raise SystemExit(
                f"--device gpu: JAX finds no GPU ({exc})") from exc
    elif device != "auto":
        raise ValueError(f"unknown device {device!r}")
