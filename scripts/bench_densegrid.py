"""Dense voxel-grid baseline throughput on one chip.

The dense rep's integrate is pure elementwise math + one image gather
(densegrid.integrate) — the most XLA-friendly fusion path possible — so
this measures the hardware ceiling the sparse map trades against for
unbounded scenes. Times (a) integrate-only fusion along a GT trajectory
and (b) the full dense engine step (render+track+integrate), each timed
window ended by ``block_until_ready``. Needs a GPU.

Usage: python scripts/bench_densegrid.py [--dims 256]
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, default=256,
                    help="grid voxels per axis (256^3 = 16.7M voxels)")
    ap.add_argument("--frames", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from voxelhashing_tpu import denseengine, densegrid, runtime
    runtime.enable_compile_cache()
    dev = runtime.require_gpu()
    print(f"device: {dev.platform} {dev.device_kind}; "
          f"card: {runtime.card_info()}")
    from voxelhashing_tpu.config import CameraConfig, EngineConfig, MapConfig
    from voxelhashing_tpu.io.synthetic import (Scene, Sphere,
                                               make_trajectory, render_depth)

    cam = CameraConfig()
    n = args.dims
    vs = 2.56 / n      # fixed 2.56 m working cube regardless of dims
    grid_cfg = densegrid.DenseGridConfig(
        dims=(n, n, n), origin=(-1.28, -1.28, 0.5), voxel_size=vs,
        truncation=max(5.0 * vs, 0.05))
    cfg = EngineConfig(camera=cam, offline=False)

    scene = Scene(wall_z=2.2, spheres=(
        Sphere(center=(0.0, 0.2, 1.8), radius=0.3),
        Sphere(center=(-0.5, -0.2, 2.0), radius=0.25, color=(0.2, 0.5, 0.8)),
        Sphere(center=(0.6, 0.1, 1.5), radius=0.2, color=(0.3, 0.7, 0.3)),
    ))
    poses = make_trajectory(args.frames)
    frames = []
    for i, p in enumerate(poses):
        d, c = render_depth(p, cam, scene, noise_sigma=0.002, seed=i)
        frames.append((jnp.asarray(np.nan_to_num(d, nan=0.0)),
                       jnp.asarray(c), jnp.asarray(p.astype(np.float32))))

    # (a) integrate-only (GT fusion; the KinectFusion-style inner loop)
    integ = jax.jit(lambda g, d, c, p: densegrid.integrate(
        g, grid_cfg, d, c, p, cam))
    grid = densegrid.create(grid_cfg)
    grid = jax.block_until_ready(integ(grid, *frames[0]))
    t0 = time.perf_counter()
    for f in frames[1:]:
        grid = integ(grid, *f)
    jax.block_until_ready(grid)
    dt_i = (time.perf_counter() - t0) / (len(frames) - 1)
    vox_rate = n ** 3 / dt_i / 1e9

    # (b) full dense engine step (render + ICP + integrate)
    step = denseengine.make_step(cfg, grid_cfg)
    state = denseengine.create(grid_cfg)
    state, _ = step(state, frames[0][0], frames[0][1])
    state, _ = step(state, frames[1][0], frames[1][1])
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for f in frames[2:]:
        state, _ = step(state, f[0], f[1])
    jax.block_until_ready(state)
    dt_s = (time.perf_counter() - t0) / (len(frames) - 2)

    print(f"dense {n}^3 ({n**3/1e6:.1f}M voxels, voxel {vs*1e3:.0f} mm):")
    print(f"  integrate-only: {dt_i*1e3:7.2f} ms/frame "
          f"({1/dt_i:6.1f} fps, {vox_rate:.2f} G voxel-updates/s)")
    print(f"  full step     : {dt_s*1e3:7.2f} ms/frame ({1/dt_s:6.1f} fps)")


if __name__ == "__main__":
    main()
