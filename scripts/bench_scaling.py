"""Sharded-step scaling curve over a virtual CPU mesh (1 -> 8 devices).

Measures frames/s of the REAL distributed step
(:func:`voxelhashing_tpu.parallel.sharded.make_sharded_step` — the same
program `dryrun_multichip` runs) at several mesh sizes and prints a
scaling table for BASELINE.md.

Virtual CPU devices share one host's cores, so absolute numbers say
nothing about GPUs; the curve's value is (a) proving the shard_map
program scales its *work partition* (per-device active blocks drop ~1/D)
and (b) catching partition-imbalance or replicated-work regressions.
Efficiency on real cards needs the same program on four GPUs (not
measured by this script).

Run: python scripts/bench_scaling.py [--frames N]
"""

import argparse
import json
import os
import subprocess
import sys

_WORKER = r"""
import sys, time
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, %(repo)r)
n_dev = %(n)d
frames = %(frames)d
from jax.sharding import Mesh
from voxelhashing_tpu.config import (CameraConfig, EngineConfig,
                                     FilterConfig, MapConfig, TrackerConfig)
from voxelhashing_tpu.io.synthetic import Scene, make_trajectory, render_depth
from voxelhashing_tpu.parallel import sharded
from voxelhashing_tpu.geometry import INVALID_KEY

cam = CameraConfig(width=128, height=96, fx=104.0, fy=104.0,
                   cx=63.5, cy=47.5)
cfg = EngineConfig(
    camera=cam,
    map=MapConfig(voxel_size=0.01, truncation=0.03, truncation_scale=0.01,
                  num_blocks=1 << 15, table_size=1 << 17,
                  max_active_blocks=1 << 15),
    tracker=TrackerConfig(levels=2, max_outer_iter=(6, 4),
                          max_inner_iter=(1, 1), dist_thres=(0.15, 0.15),
                          normal_thres=(0.9, 0.9),
                          angle_trans_thres=(1.0, 1.0),
                          dist_trans_thres=(1.0, 1.0),
                          residual_early_out=(1e-9, 1e-9)),
    filter=FilterConfig(depth_filter=False),
)
mesh = Mesh(np.array(jax.devices()[:n_dev]), (sharded.AXIS,))
poses = make_trajectory(max(frames, 2))
scene = Scene()
step = sharded.make_sharded_step(cfg, mesh)
state, lcfg = sharded.create_sharded(cfg, mesh, initial_pose=poses[0])
imgs = [render_depth(p, cam, scene) for p in poses]
d0 = jax.numpy.asarray(np.nan_to_num(imgs[0][0], nan=0.0))
c0 = jax.numpy.asarray(imgs[0][1])
state, pose = step(state, d0, c0)   # compile + warm the map
jax.block_until_ready(state)
t0 = time.perf_counter()
for d, c in imgs[1:frames + 1]:
    state, pose = step(state, jax.numpy.asarray(np.nan_to_num(d, nan=0.0)),
                       jax.numpy.asarray(c))
jax.block_until_ready(state)
t1 = time.perf_counter()
stacked = jax.device_get(state.map)
per_dev = [int((stacked.block_key[d] != INVALID_KEY).sum())
           for d in range(n_dev)]
print("SCALE_JSON " + __import__("json").dumps({
    "n_devices": n_dev, "fps": frames / (t1 - t0),
    "blocks_per_device": per_dev}))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rows = []
    for n in args.devices:
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "").split(
            "--xla_force_host_platform_device_count")[0]
            + f" --xla_force_host_platform_device_count={max(n, 1)}")
        code = _WORKER % {"repo": repo, "n": n, "frames": args.frames}
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=1800)
        line = [ln for ln in r.stdout.splitlines()
                if ln.startswith("SCALE_JSON ")]
        if not line:
            print(f"n={n} FAILED:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
            continue
        rec = json.loads(line[0][len("SCALE_JSON "):])
        rows.append(rec)
        bpd = rec["blocks_per_device"]
        print(f"n={rec['n_devices']}: {rec['fps']:.3f} fps, "
              f"blocks/dev min={min(bpd)} max={max(bpd)}")
    if rows and rows[0]["n_devices"] == 1:
        base = rows[0]["fps"]
        print("\n| devices | frames/s | efficiency |")
        print("|---|---|---|")
        for r_ in rows:
            eff = r_["fps"] / (base * r_["n_devices"])
            print(f"| {r_['n_devices']} | {r_['fps']:.3f} | {eff:.0%} |")


if __name__ == "__main__":
    main()
