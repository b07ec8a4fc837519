"""Entry-point set-up (voxelhashing_tpu.runtime) and the f32 precision pin."""

import os

import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from voxelhashing_tpu import engine, runtime
from voxelhashing_tpu.config import (CameraConfig, EngineConfig, FilterConfig,
                                     MapConfig, RaycastConfig, TrackerConfig)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """$JAX_COMPILATION_CACHE_DIR wins untouched; otherwise the fixed
    <repo>/.jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert runtime.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = runtime.enable_compile_cache()
            assert path == os.path.join(runtime.REPO_ROOT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_raises_on_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


CAM = CameraConfig(width=64, height=48, fx=52.0, fy=52.0, cx=31.5, cy=23.5)
TINY = EngineConfig(
    camera=CAM,
    map=MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                  num_blocks=1024, table_size=4096, max_active_blocks=1024),
    tracker=TrackerConfig(levels=2, max_outer_iter=(2, 2),
                          max_inner_iter=(1, 1)),
    filter=FilterConfig(depth_filter=False),
)


def _dot_generals(jaxpr):
    """Every dot_general equation in ``jaxpr`` and its sub-jaxprs (cond
    branches, scan/while bodies, pjit calls)."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jex.ClosedJaxpr):
                    yield from _dot_generals(sub.jaxpr)
                elif isinstance(sub, jex.Jaxpr):
                    yield from _dot_generals(sub)


@pytest.mark.parametrize("variant", ["splat", "march", "rgbd"])
def test_step_f32_products_at_highest(variant):
    """Every f32 dot_general in the traced engine step runs at HIGHEST
    precision (no TF32 on a GPU), in every cond branch."""
    cfg = TINY
    if variant == "march":
        cfg = EngineConfig(**{**TINY.__dict__,
                              "raycast": RaycastConfig(mode="march",
                                                       num_samples=16)})
    elif variant == "rgbd":
        cfg = EngineConfig(**{**TINY.__dict__, "tracker": TrackerConfig(
            levels=2, max_outer_iter=(2, 2), max_inner_iter=(1, 1),
            use_rgbd=True)})
    state = engine.create(cfg)
    depth = jnp.full((CAM.height, CAM.width), 2.0, jnp.float32)
    color = jnp.full((CAM.height, CAM.width, 3), 0.5, jnp.float32)
    closed = jax.make_jaxpr(
        lambda s, d, c: engine.step(s, d, c, cfg))(state, depth, color)
    dots = [e for e in _dot_generals(closed.jaxpr)
            if any(v.aval.dtype == np.float32 for v in e.invars)]
    assert dots, "no f32 products traced"
    loose = [e for e in dots
             if e.params["precision"] is None
             or any(p != lax.Precision.HIGHEST
                    for p in e.params["precision"])]
    assert not loose, [str(e.source_info.traceback)[-300:] for e in loose]
