"""Test configuration: the CPU backend with 8 virtual devices.

Tests run on the host CPU (with a virtual 8-device mesh for the sharding
tests); the platform is fixed before any backend is instantiated. An
explicit ``JAX_PLATFORMS`` wins, which is how the GPU-marked tests reach
the card: ``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu``.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def _bound_accumulated_jax_state():
    """Clear jit/compilation caches between test MODULES.

    A single-process run of the whole suite accumulates every module's
    compiled executables (hundreds, incl. the 8-virtual-device shard_map
    programs); observed to push XLA:CPU into a native abort inside a
    late compile (round 4). Per-module cache clearing bounds the live
    set; individual modules recompile their own programs as before.
    """
    yield
    # lru-cached step factories hold jitted callables across modules
    from voxelhashing_tpu import engine
    engine.make_step.cache_clear()
    try:
        from voxelhashing_tpu import denseengine
        denseengine.make_step.cache_clear()
    except ImportError:
        pass
    jax.clear_caches()
    gc.collect()
