"""Offline driver for the DENSE voxel-grid baseline (SURVEY §2.9).

The dense twin of scripts/run_slam.py: replays a frame source through
``denseengine.step`` (preprocess -> dense raycast -> ICP -> dense
integrate — the loop the original DX11 app ran before the sparse hash,
/root/reference/DepthSensing/Source/DX11SceneRep.h:27), reports ATE, and
optionally writes the extracted isosurface mesh.

Usage:
    python scripts/run_dense.py --frames 10 --cpu [--mesh /tmp/dense.ply]
        [--gt] [--input sens:FILE|tum:DIR] [--dims 96] [--voxel 0.02]
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "scripts")

from run_slam import build_config, frame_source  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "default"])
    ap.add_argument("--input", default=None)
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--gt", action="store_true",
                    help="fuse along the ground-truth trajectory")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--dims", type=int, default=96,
                    help="grid voxels per axis")
    ap.add_argument("--voxel", type=float, default=0.02)
    ap.add_argument("--origin", type=float, nargs=3,
                    default=None, help="grid origin (default: centred)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import dataclasses
    import jax.numpy as jnp
    from voxelhashing_tpu import (denseengine, densegrid, evaluation,
                                  meshing, runtime)
    runtime.enable_compile_cache()

    cfg = build_config(args.preset, streaming=False)
    cfg = dataclasses.replace(cfg, offline=False,
                              use_trajectory=args.gt)
    n = args.dims
    half = 0.5 * n * args.voxel
    origin = tuple(args.origin) if args.origin else (-half, -half, 0.5)
    grid_cfg = densegrid.DenseGridConfig(
        dims=(n, n, n), origin=origin, voxel_size=args.voxel,
        truncation=max(5.0 * args.voxel, 0.06))

    step = denseengine.make_step(cfg, grid_cfg, with_hint=args.gt,
                                 donate=False)
    state = denseengine.create(grid_cfg)
    est, gts = [], []
    t0 = time.time()
    for i, (d, c, gt_pose) in enumerate(frame_source(args, cfg)):
        a = (state, jnp.asarray(np.nan_to_num(d, nan=0.0)),
             jnp.asarray(c) if c is not None else
             jnp.zeros((cfg.camera.height, cfg.camera.width, 3),
                       jnp.float32))
        if args.gt:
            hint = gt_pose if gt_pose is not None else np.asarray(state.pose)
            a += (jnp.asarray(np.asarray(hint, np.float32)),)
        state, tr = step(*a)
        est.append(np.asarray(state.pose))
        if gt_pose is not None:
            gts.append(np.asarray(gt_pose))
        w = np.asarray(state.grid.weight)
        print(f"frame {i:4d}: occupied={int((w > 0).sum()):8d} "
              f"res={float(tr.residual):.2e} valid={bool(tr.valid)}")
    dt = time.time() - t0
    print(f"\n{len(est)} frames in {dt:.1f}s "
          f"({len(est) / dt:.2f} fps incl. host loop)")

    ok = True
    if gts and not args.gt:
        ate = evaluation.ate_rmse(est, gts)
        print(f"ATE RMSE: {ate * 1e3:.2f} mm")
        ok &= ate < 0.05
    if args.mesh:
        chunk = densegrid.extract_mesh(state.grid, grid_cfg)
        nt = int(chunk.n_triangles)
        v = np.asarray(chunk.vertices[:nt])
        col = np.asarray(chunk.colors[:nt])
        meshing.save_ply(args.mesh, v, col)
        print(f"mesh: {nt} triangles -> {args.mesh}")
        ok &= nt > 0
    print("RESULT:", "OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
