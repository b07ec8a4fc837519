"""Benchmark: fused frames/sec of the full per-frame pipeline on one GPU.

Runs the reference's real-time operating point (320x240, 4 mm voxels,
64K-block pool, online allocation, free ICP tracking; ``config.
realtime_config``) over the 5-sphere synthetic scene, with the engine
state donated and every timed window ended by ``block_until_ready``.
``--streaming`` adds the asynchronous streaming manager with its host
half live, following the tracked camera.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}
with the device it ran on. ``vs_baseline`` = fps / 30, the sensor's
30 Hz frame rate. The run must also pass its own checks (clean map
invariants, ATE under 10 mm against ground truth, and the last frame's
integrate against the plain f32 NumPy reference); otherwise it exits 1.
Exits non-zero when JAX finds no GPU.
"""

import json
import sys
import time

import numpy as np

N_FRAMES = 20
ATE_LIMIT = 0.010


def integrate_check(state_map, depth, color, pose, cfg):
    """The last frame integrated once more into the final map, on the
    device and in NumPy (checks.integrate_reference), compared voxel by
    voxel over the active list."""
    import jax
    import jax.numpy as jnp
    from voxelhashing_tpu import blockmap, checks, geometry as geom
    from voxelhashing_tpu import integrate as integ
    from voxelhashing_tpu.ops.image import preprocess

    cam, mp = cfg.camera, cfg.map
    pose = jnp.asarray(pose, jnp.float32)

    @jax.jit
    def device_rows(m, d, c, p):
        fr = preprocess(d, c, cam, cfg.filter)
        ai, na, _ = blockmap.compactify(m, geom.invert_rigid(p), cam, mp)
        am = jnp.arange(ai.shape[0]) < na
        out = integ.integrate(m, fr.depth, fr.color, p, cam, mp,
                              active_idx=ai, active_mask=am)
        return (ai, na, fr.depth, fr.color, m.sdf[ai], m.weight[ai],
                out.sdf[ai], out.weight[ai])

    ai, na, d, c, old_s, old_w, new_s, new_w = jax.device_get(
        device_rows(state_map, depth, color, pose))
    rows = ai[:int(na)]
    keys = np.asarray(state_map.block_key)[rows]
    f32 = np.float32
    ref_s, ref_w, border = checks.integrate_reference(
        keys, old_s[:len(rows)].astype(f32), old_w[:len(rows)].astype(f32),
        d, c, np.asarray(pose), cam, mp)
    return checks.compare_voxels(
        new_s[:len(rows)].astype(f32), new_w[:len(rows)].astype(f32),
        checks.to_bf16_f32(ref_s), checks.to_bf16_f32(ref_w), border)


def main(streaming: bool = False):
    import jax
    import jax.numpy as jnp
    from voxelhashing_tpu import blockmap, engine, evaluation, runtime
    from voxelhashing_tpu.config import StreamingConfig, realtime_config
    from voxelhashing_tpu.io.synthetic import (make_trajectory, render_depth,
                                               sphere_cluster_scene)

    runtime.enable_compile_cache()
    dev = runtime.require_gpu()
    card = runtime.card_info()

    cfg = realtime_config()
    cam = cfg.camera
    scene = sphere_cluster_scene()
    poses = make_trajectory(N_FRAMES)
    frames = []
    for i, pose in enumerate(poses):
        d, c = render_depth(pose, cam, scene, noise_sigma=0.002, seed=i)
        frames.append((jnp.asarray(np.nan_to_num(d, nan=0.0)),
                       jnp.asarray(c)))
    jax.block_until_ready(frames)

    step = engine.make_step(cfg, with_stream_mask=streaming)
    state = engine.create(cfg)
    mgr = None
    if streaming:
        from voxelhashing_tpu.streaming import AsyncStreamingManager
        mgr = AsyncStreamingManager(
            cfg.map, StreamingConfig(enabled=True, radius=4.0), out_cap=512)

    est = []

    def run_frame(state, d, c):
        if mgr is None:
            state, diag = step(state, d, c)
        else:
            state, diag = step(state, d, c, mgr.bitmask)
        pose = np.asarray(state.pose)        # the frame's product: its pose
        if mgr is not None:
            state = state._replace(map=mgr.step(state.map, pose[:3, 3]))
        est.append(pose)
        return state, diag

    # warmup: compile + the two alloc-heavy first frames
    t_setup = time.perf_counter()
    for f in frames[:2]:
        state, diag = run_frame(state, *f)
    jax.block_until_ready(state)
    setup_s = time.perf_counter() - t_setup

    t0 = time.perf_counter()
    for f in frames[2:]:
        state, diag = run_frame(state, *f)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    fps = (N_FRAMES - 2) / dt
    if mgr is not None:
        mgr.flush()

    ate = float(evaluation.ate_rmse(est, poses, align=False))
    inv = blockmap.check_invariants(state.map, cfg.map)
    icheck = integrate_check(state.map, *frames[-1], est[-1], cfg)
    ok = (ate < ATE_LIMIT and all(v == 0 for v in inv.values())
          and icheck["ok"])
    print(json.dumps({
        "metric": ("fused_frames_per_sec_streaming" if streaming
                   else "fused_frames_per_sec"),
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / 30.0,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
        "warmup_seconds_incl_compile": setup_s,
        "ate_mm": ate * 1e3,
        "invariants_clean": all(v == 0 for v in inv.values()),
        "integrate_check": icheck,
        "checks": "PASS" if ok else "FAIL",
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(streaming="--streaming" in sys.argv))
