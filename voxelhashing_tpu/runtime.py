"""Process set-up for the entry-point scripts: compile cache, GPU guard.

Called by ``chip_smoke.py``, ``bench.py`` and the ``scripts/`` entry points at
start-up — never at library import and never by the tests.
"""

from __future__ import annotations

import os
import subprocess

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache lives at the fixed,
    git-ignored ``<repo>/.jax_cache`` (the path is part of the cache key,
    so it must not move between runs).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu():
    """The default JAX device, which must be a GPU.

    Raises RuntimeError otherwise: measurement paths never fall back to
    the CPU backend.
    """
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {dev.platform} "
            f"({dev.device_kind}); this path measures the card only")
    return dev


def card_info() -> str:
    """``name, power.limit`` of the cards as nvidia-smi reports them.

    A plain subprocess that stays off JAX (one JAX process per card).
    """
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    out = r.stdout.strip()
    return out if r.returncode == 0 and out else (
        f"nvidia-smi failed (rc={r.returncode}): {r.stderr.strip()}")
