"""On-card smoke test of the per-frame SLAM step.

Drives the main path through its user entry points (``engine.make_step``,
``scripts/run_slam.py``) at the reference's real-time operating point and
checks what comes out. Every phase is fatal: a failed check exits
non-zero, and nothing falls back to the CPU.

    python chip_smoke.py              # phases 1-5 on one GPU
    python chip_smoke.py --multichip  # phase 6 only, on four GPUs

1. device: kind, count, JAX version, XLA_FLAGS, compile cache, the card's
   name and power limit, the native host library;
2. real-time point: 40 frames at 320x240 / 4 mm / 64K blocks, online
   allocation, GC, free ICP tracking, donated state;
3. reference capacity: 10 frames of the same point at 1M blocks;
4. XLA stages on the card against the CPU backend at real widths:
   integrate, tracking render, one ICP linear system;
5. the app: ``run_slam.main`` with live streaming, mesh and checkpoint;
6. (``--multichip``) the map sharded over a 1-D mesh of four GPUs
   against the same frames on one.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chip_smoke_out")
REALTIME_FRAMES = 40
CAPACITY_FRAMES = 10
MULTICHIP_FRAMES = 20
ATE_LIMIT = 0.010            # metres, unaligned, vs synthetic ground truth
# --multichip: per-frame pose agreement of the 4-way sharded step with the
# single-card step. Not bit-identical by design: the sharded step fills
# splat holes per shard before its pmin combine and compactifies at the
# new pose; both runs track the same frames within ATE_LIMIT, so their
# poses agree within that bound.
POSE_TOL_M = 0.010
POSE_TOL_RAD = 0.01
# --multichip block counts: every shard keeps the single-device per-frame
# insert budget (alloc_insert_cap), so the sharded map allocates up to D
# times more of a burst per frame (frame 0 of the real-time point: 18.7K
# blocks on 4 shards vs 8.2K, cap-bound, on one device) and stays ahead
# of the single run, which spreads the burst over later frames (20
# frames: +14%, the same on the CPU backend and on H100s). So the
# sharded map must hold at least BLOCK_CONTAIN_MIN of the single run's
# block keys, and its count must lie within [1 - BLOCK_DEFICIT_MAX,
# 1 + BLOCK_EXCESS_MAX] times the single count. Containment is not 1:
# blocks at the edge of the truncation band follow the pose and the
# predicted surface, which differ by ~1 mm between the runs (measured
# 99.6% at the real-time point, 98.6% at the tests' tiny size).
BLOCK_CONTAIN_MIN = 0.97
BLOCK_DEFICIT_MAX = 0.01
BLOCK_EXCESS_MAX = 0.25


class SmokeFailure(Exception):
    pass


def log(msg: str = "") -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def make_frames(cam, n: int, seed: int = 0):
    """[(depth f32[h,w] 0-invalid, color f32[h,w,3], gt pose)] of the
    benchmark scene along ``make_trajectory``, noise sigma 2 mm."""
    from voxelhashing_tpu.io.synthetic import (make_trajectory,
                                               render_depth,
                                               sphere_cluster_scene)
    scene = sphere_cluster_scene()
    out = []
    for i, pose in enumerate(make_trajectory(n)):
        d, c = render_depth(pose, cam, scene, noise_sigma=0.002,
                            seed=seed + i)
        out.append((np.nan_to_num(d, nan=0.0), c, pose))
    return out


def run_engine(cfg, frames):
    """The engine step with donation over ``frames``, each frame ended by
    ``block_until_ready``. Returns a dict with the final state, per-frame
    poses, diagnostics and seconds, compile seconds and the compiled step.
    """
    import jax
    import jax.numpy as jnp
    from voxelhashing_tpu import engine

    step = engine.make_step(cfg)
    state = engine.create(cfg, initial_pose=frames[0][2])
    d0, c0 = jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1])
    t0 = time.perf_counter()
    compiled = step.lower(state, d0, c0).compile()
    compile_s = time.perf_counter() - t0
    est, diags, times = [], [], []
    for d, c, _ in frames:
        d, c = jax.block_until_ready((jnp.asarray(d), jnp.asarray(c)))
        t0 = time.perf_counter()
        state, diag = compiled(state, d, c)
        jax.block_until_ready(state)
        times.append(time.perf_counter() - t0)
        diags.append(jax.device_get(diag))
        est.append(np.asarray(state.pose))
    return {"state": state, "est": est, "diags": diags, "times": times,
            "compile_s": compile_s, "compiled": compiled}


def check_sequence(cfg, run, frames, ate_limit=ATE_LIMIT):
    """check_run over an engine run: (ate, failures, invariants)."""
    from voxelhashing_tpu import blockmap, checks
    inv = blockmap.check_invariants(run["state"].map, cfg.map)
    ate, failures = checks.check_run(
        run["est"], [f[2] for f in frames],
        [bool(g.tracking_valid) for g in run["diags"]], inv,
        [int(g.n_allocated_blocks) for g in run["diags"]], ate_limit)
    return ate, failures, inv


def peak_bytes(dev) -> int:
    stats = dev.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


# --------------------------------------------------------------------------
# Phase 4: XLA stages, one device against another
# --------------------------------------------------------------------------


def stage_inputs(state, frame, pose, prev_pose, cfg):
    """Host (NumPy) inputs shared by both devices' stage runs: the
    preprocessed frame, the active list at ``pose``, and the fixed
    correspondences of one ICP linearisation."""
    import jax
    import jax.numpy as jnp
    from voxelhashing_tpu import blockmap, geometry as geom, raycast, tracking
    from voxelhashing_tpu.ops.image import preprocess

    cam, mp = cfg.camera, cfg.map
    fr = jax.jit(lambda d, c: preprocess(d, c, cam, cfg.filter))(
        jnp.asarray(frame[0]), jnp.asarray(frame[1]))
    pose = jnp.asarray(pose, jnp.float32)
    active_idx, n_active, _ = jax.jit(
        lambda m, v: blockmap.compactify(m, v, cam, mp))(
        state.map, geom.invert_rigid(pose))
    active_mask = jnp.arange(active_idx.shape[0]) < n_active
    model = jax.jit(lambda m, p, ai, am: raycast.render(
        m, p, cam, mp, cfg.raycast, active_idx=ai, active_mask=am,
        with_color=False))(state.map, pose, active_idx, active_mask)
    # one linearisation at the finest level: the current frame against
    # the model, about the ground-truth relative motion
    delta = jnp.asarray(np.linalg.inv(prev_pose) @ np.asarray(pose),
                        jnp.float32)
    in_soa = tracking._soa(fr.points) + tracking._soa(fr.normals)
    md8 = tracking._interleave_target(model.points, model.normals)
    tk = cfg.tracker
    q, nq, wgt, ok = tracking._associate(
        delta, in_soa, md8, cam, tk.dist_thres[0], tk.normal_thres[0],
        cam.depth_min, cam.depth_max)
    mean, inv_std = tracking._whitening(q, ok, lambda t: t)
    host = jax.device_get
    return {
        "map": host(state.map),
        "depth": host(fr.depth), "color": host(fr.color),
        "pose": host(pose),
        "active_idx": host(active_idx), "active_mask": host(active_mask),
        "lin": host((delta, in_soa, q, nq, wgt, ok, mean, inv_std)),
    }


def run_stages(inp, cfg, device, precision=None):
    """integrate / tracking render / ICP system on ``device``; NumPy out.

    ``precision``: the ICP system's matmul precision (None = the code's
    own, full f32)."""
    import jax
    from voxelhashing_tpu import integrate as integ, raycast, tracking

    cam, mp = cfg.camera, cfg.map
    x = jax.device_put(inp, device)
    ai, am = x["active_idx"], x["active_mask"]

    def integrate_rows(m, d, c, p):
        out = integ.integrate(m, d, c, p, cam, mp, active_idx=ai,
                              active_mask=am)
        return out.sdf[ai], out.weight[ai]

    sdf, w = jax.jit(integrate_rows)(x["map"], x["depth"], x["color"],
                                     x["pose"])
    depth = jax.jit(lambda m, p: raycast.render(
        m, p, cam, mp, cfg.raycast, active_idx=ai, active_mask=am,
        with_color=False).depth)(x["map"], x["pose"])
    kw = {} if precision is None else {"precision": precision}
    system = jax.jit(lambda *a: tracking._linearize(*a, **kw))(*x["lin"])
    return jax.device_get({"sdf": sdf.astype("float32"),
                           "weight": w.astype("float32"),
                           "depth": depth, "system": system})


def compare_stages(a, b, inp, cfg):
    """Stage comparisons of two run_stages results (checks.py tolerances);
    the integrate borderline set comes from the NumPy reference."""
    from voxelhashing_tpu import checks
    rows = inp["active_idx"][inp["active_mask"]]
    n = len(rows)
    m = inp["map"]
    ref_s, ref_w, border = checks.integrate_reference(
        m.block_key[rows], np.asarray(m.sdf[rows], np.float32),
        np.asarray(m.weight[rows], np.float32), inp["depth"], inp["color"],
        inp["pose"], cfg.camera, cfg.map)
    integ = checks.compare_voxels(a["sdf"][:n], a["weight"][:n],
                                  b["sdf"][:n], b["weight"][:n], border)
    # the NumPy reference's (sdf, weight) where the two devices disagree
    integ["reference_at_examples"] = [
        (float(ref_s[i, j]), float(ref_w[i, j]))
        for i, j, *_ in integ["unexplained_examples"]]
    return {
        "integrate": integ,
        "render": checks.compare_depth(a["depth"], b["depth"]),
        "icp_system": checks.compare_system(a["system"], b["system"]),
    }


# --------------------------------------------------------------------------
# Phase 6: sharded map over a mesh against one device
# --------------------------------------------------------------------------


def pose_error(a, b):
    """(translation m, rotation rad) between two 4x4 poses."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    rel = a[:3, :3].T @ b[:3, :3]
    ang = np.arccos(np.clip((np.trace(rel) - 1.0) / 2.0, -1.0, 1.0))
    return float(np.linalg.norm(a[:3, 3] - b[:3, 3])), float(ang)


def multichip_compare(cfg, frames, devices):
    """The sharded step over a 1-D mesh of ``devices`` against the engine
    step on ``devices[0]``, on the same frames. Returns a dict of the
    comparisons and ``failures``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from voxelhashing_tpu import blockmap
    from voxelhashing_tpu.geometry import INVALID_KEY
    from voxelhashing_tpu.parallel import sharded

    mesh = Mesh(np.array(devices), (sharded.AXIS,))
    step = sharded.make_sharded_step(cfg, mesh)
    state, lcfg = sharded.create_sharded(cfg, mesh,
                                         initial_pose=frames[0][2])
    est_sh = []
    t0 = time.perf_counter()
    for d, c, _ in frames:
        state, pose = step(state, jnp.asarray(d), jnp.asarray(c))
        est_sh.append(np.asarray(pose))
    sharded_s = time.perf_counter() - t0
    with jax.default_device(devices[0]):
        single = run_engine(cfg, frames)

    stacked = jax.device_get(state.map)
    per_shard = [int((stacked.block_key[i] != INVALID_KEY).sum())
                 for i in range(len(devices))]
    keys_sh = np.asarray(stacked.block_key).ravel()
    keys_1 = np.asarray(jax.device_get(single["state"].map.block_key))
    keys_1 = keys_1[keys_1 != INVALID_KEY]
    contained = float(np.isin(keys_1, keys_sh).mean()) if keys_1.size \
        else 0.0
    shard_inv = []
    for i in range(len(devices)):
        shard = jax.tree_util.tree_map(lambda x, i=i: x[i], stacked)
        shard_inv.append(blockmap.check_invariants(shard, lcfg))
    n_single = int(single["diags"][-1].n_allocated_blocks)
    errs = [pose_error(a, b) for a, b in zip(est_sh, single["est"])]
    res = {
        "frames": len(frames),
        "max_pose_diff_m": max(e[0] for e in errs),
        "max_pose_diff_rad": max(e[1] for e in errs),
        "blocks_sharded": sum(per_shard), "blocks_per_shard": per_shard,
        "blocks_single": n_single,
        "single_blocks_in_sharded": contained,
        "shard_invariants_clean": [all(v == 0 for v in inv.values())
                                   for inv in shard_inv],
        "sharded_seconds_incl_compile": sharded_s,
    }
    failures = []
    if res["max_pose_diff_m"] > POSE_TOL_M \
            or res["max_pose_diff_rad"] > POSE_TOL_RAD:
        failures.append(f"pose difference {res['max_pose_diff_m']:.4g} m / "
                        f"{res['max_pose_diff_rad']:.4g} rad exceeds "
                        f"{POSE_TOL_M} m / {POSE_TOL_RAD} rad")
    ratio = sum(per_shard) / max(n_single, 1)
    if not 1 - BLOCK_DEFICIT_MAX <= ratio <= 1 + BLOCK_EXCESS_MAX:
        failures.append(f"blocks {sum(per_shard)} sharded vs {n_single} "
                        f"single (ratio {ratio:.3f} outside "
                        f"[{1 - BLOCK_DEFICIT_MAX}, {1 + BLOCK_EXCESS_MAX}])")
    if contained < BLOCK_CONTAIN_MIN:
        failures.append(f"sharded map holds {contained:.2%} of the single "
                        f"run's blocks (< {BLOCK_CONTAIN_MIN:.0%})")
    for i, inv in enumerate(shard_inv):
        if any(inv.values()):
            failures.append(f"shard {i} invariants {inv}")
    res["failures"] = failures
    return res


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


def phase_device():
    import jax
    from voxelhashing_tpu import native, runtime

    cache = runtime.enable_compile_cache()
    dev = runtime.require_gpu()
    log("== phase 1: device")
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}")
    log(f"compile cache: {cache}")
    log(f"card: {runtime.card_info()}")
    log(f"native host library loaded: {native.load() is not None}")
    return dev


def phase_realtime(dev):
    from voxelhashing_tpu.config import realtime_config
    log("== phase 2: real-time point (320x240, 4 mm, 64K blocks)")
    cfg = realtime_config()
    frames = make_frames(cfg.camera, REALTIME_FRAMES)
    run = run_engine(cfg, frames)
    ate, failures, inv = check_sequence(cfg, run, frames)
    n_valid = sum(bool(g.tracking_valid) for g in run["diags"])
    blocks = [int(g.n_allocated_blocks) for g in run["diags"]]
    steady = np.asarray(run["times"][2:]) * 1e3
    log(f"frames valid: {n_valid}/{len(frames)}; ATE (unaligned) "
        f"{ate * 1e3:.3f} mm; invariants {inv}")
    log(f"blocks: frame 0 {blocks[0]} -> frame {len(blocks) - 1} "
        f"{blocks[-1]}")
    log(f"[{dev.device_kind}] compile {run['compile_s']:.1f} s; per-frame "
        f"median {np.median(steady):.3f} ms over frames 3-{len(frames)} "
        f"(min {steady.min():.3f}, max {steady.max():.3f}); "
        f"peak_bytes_in_use {peak_bytes(dev)}")
    log(f"step memory_analysis: {run['compiled'].memory_analysis()}")
    require(not failures, f"phase 2: {failures}")
    return cfg, frames, run


def phase_capacity(dev):
    from voxelhashing_tpu.config import realtime_config
    log("== phase 3: reference capacity (1M blocks, 2M table slots)")
    cfg = realtime_config(num_blocks=1 << 20, table_size=1 << 21)
    frames = make_frames(cfg.camera, CAPACITY_FRAMES)
    run = run_engine(cfg, frames)
    ate, failures, inv = check_sequence(cfg, run, frames)
    n_valid = sum(bool(g.tracking_valid) for g in run["diags"])
    log(f"frames valid: {n_valid}/{len(frames)}; ATE {ate * 1e3:.3f} mm; "
        f"invariants {inv}")
    log(f"[{dev.device_kind}] compile {run['compile_s']:.1f} s; per-frame "
        f"median {np.median(np.asarray(run['times'][2:])) * 1e3:.3f} ms; "
        f"peak_bytes_in_use {peak_bytes(dev)}")
    require(not failures, f"phase 3: {failures}")


def phase_stages(dev, cfg, frames, run):
    import jax
    from jax import lax
    log("== phase 4: XLA stages, card vs CPU backend")
    inp = stage_inputs(run["state"], frames[-1][:2], run["est"][-1],
                       run["est"][-2], cfg)
    log(f"active blocks: {int(inp['active_mask'].sum())} "
        f"(cap {cfg.map.max_active_blocks})")
    cpu = jax.devices("cpu")[0]
    on_gpu = run_stages(inp, cfg, dev)
    on_cpu = run_stages(inp, cfg, cpu)
    res = compare_stages(on_gpu, on_cpu, inp, cfg)
    for k, v in res.items():
        log(f"{k}: {v}")
    loose = compare_stages(
        run_stages(inp, cfg, dev, precision=lax.Precision.DEFAULT),
        on_cpu, inp, cfg)["icp_system"]
    log(f"icp_system at DEFAULT precision on the card: rel_err "
        f"{loose['rel_err']:.3e} (HIGHEST: "
        f"{res['icp_system']['rel_err']:.3e})")
    bad = [k for k, v in res.items() if not v["ok"]]
    require(not bad, f"phase 4: out of tolerance: {bad}")


def phase_app():
    log("== phase 5: scripts/run_slam.py (live streaming, mesh, map)")
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import run_slam
    os.makedirs(OUT_DIR, exist_ok=True)
    rc = run_slam.main([
        "--preset", "default", "--frames", "30", "--streaming",
        "--mesh", os.path.join(OUT_DIR, "mesh.ply"),
        "--save-map", os.path.join(OUT_DIR, "map.npz")])
    require(rc == 0, f"phase 5: run_slam exited {rc}")


def phase_multichip():
    import jax
    from voxelhashing_tpu import runtime
    from voxelhashing_tpu.config import realtime_config

    log(f"cache: {runtime.enable_compile_cache()}")
    runtime.require_gpu()
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    require(len(devs) >= 4, f"--multichip needs 4 GPUs, found {len(devs)}")
    log(f"== phase 6: map sharded over a 1-D mesh of 4 "
        f"{devs[0].device_kind}")
    log(f"card: {runtime.card_info()}")
    cfg = realtime_config()
    frames = make_frames(cfg.camera, MULTICHIP_FRAMES)
    res = multichip_compare(cfg, frames, devs[:4])
    log(f"multichip: {res}")
    require(not res["failures"], f"phase 6: {res['failures']}")
    return devs[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the 4-GPU sharded-map phase")
    args = ap.parse_args(argv)
    import jax

    if args.multichip:
        dev = phase_multichip()
    else:
        dev = phase_device()
        cfg, frames, run = phase_realtime(dev)
        phase_capacity(dev)
        phase_stages(dev, cfg, frames, run)
        del run
        phase_app()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
