"""Offline SLAM driver: the headless analog of the reference app.

Replays a sequence (synthetic, TUM directory, or .sens file) through the
full per-frame engine — the offline batch mode of the reference
(s_offlineProcessing, DepthSensing.cpp:885-892,1143-1148) including its
end-of-run mesh auto-extraction, plus the keyboard-bound extras as flags:
mesh ('9'), save/load map checkpoint ('N'/'B'), render-to-file, point
cloud export, hash histogram ('H'), timing report ('T').

Usage:
    python scripts/run_slam.py --frames 20 --preset tiny
    python scripts/run_slam.py --input tum:/data/rgbd_dataset_freiburg1_desk
    python scripts/run_slam.py --input sens:/data/scene.sens --mesh out.ply
    python scripts/run_slam.py --frames 30 --streaming --save-map map.npz
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def build_config(preset: str, streaming: bool):
    import dataclasses
    from voxelhashing_tpu.config import (CameraConfig, EngineConfig,
                                         FilterConfig, MapConfig,
                                         RaycastConfig, StreamingConfig,
                                         TrackerConfig)
    if preset == "tiny":
        cam = CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                           cx=79.5, cy=59.5)
        cfg = EngineConfig(
            camera=cam,
            map=MapConfig(voxel_size=0.02, truncation=0.06,
                          truncation_scale=0.01,
                          num_blocks=16384, table_size=65536,
                          max_active_blocks=16384),
            tracker=TrackerConfig(levels=2, max_outer_iter=(6, 4),
                                  max_inner_iter=(1, 1),
                                  dist_thres=(0.15, 0.15),
                                  normal_thres=(0.9, 0.9),
                                  angle_trans_thres=(1.0, 1.0),
                                  dist_trans_thres=(1.0, 1.0),
                                  residual_early_out=(1e-9, 1e-9)),
            filter=FilterConfig(depth_filter=False),
        )
    else:
        cfg = EngineConfig(
            camera=CameraConfig(),
            map=MapConfig(voxel_size=0.004, truncation=0.02,
                          truncation_scale=0.01,
                          num_blocks=1 << 16, table_size=1 << 18,
                          max_active_blocks=1 << 15),
        )
    if streaming:
        import dataclasses
        cfg = dataclasses.replace(
            cfg, streaming=StreamingConfig(
                enabled=True, chunk_size=0.64, grid_dim=129,
                radius=3.0, out_parts=8, in_chunks_per_frame=2))
    return cfg


def frame_source(args, cfg):
    """Yields (depth f32[h,w] NaN-invalid, color f32[h,w,3]|None,
    gt_pose 4x4|None). May rescale to the working resolution."""
    cam = cfg.camera
    if args.input is None or args.input.startswith("synthetic"):
        from voxelhashing_tpu.io.synthetic import (Scene, make_trajectory,
                                                   render_depth)
        scene = Scene()
        poses = make_trajectory(args.frames)
        for i, p in enumerate(poses):
            d, c = render_depth(p, cam, scene, noise_sigma=args.noise,
                                seed=i)
            yield d, c, p
        return

    kind, _, path = args.input.partition(":")
    if kind == "tum":
        from voxelhashing_tpu.io.tum import load_tum
        seq = load_tum(path, max_frames=args.frames or None)
        for i in range(len(seq)):
            d, c, p = seq.read_frame(i)
            d, c = _resample(d, c, seq.camera, cam)
            yield d, c, p
    elif kind == "dump":
        # mLib .sensor binary dump (BinaryDumpReader,
        # s_binaryDumpSensorFile replay path)
        from voxelhashing_tpu.io.binarydump import BinaryDumpReader
        r = BinaryDumpReader(path)
        n = min(len(r), args.frames) if args.frames else len(r)
        try:
            for i in range(n):
                d, c, p = r.read_frame(i)
                d, c = _resample(d, c, r.camera, cam)
                yield d, c, p
        finally:
            r.close()     # release the mmap/file on early exit too
    elif kind == "sens":
        # comma-separated files chain into one sequence (loadNextSensFile,
        # DepthSensing.cpp:959-979)
        from voxelhashing_tpu.io.sensfile import (PrefetchReader,
                                                  SensChainReader, SensReader)
        paths = path.split(",")
        r = SensChainReader(paths) if len(paths) > 1 else SensReader(paths[0])
        # read-ahead decode thread (RGBDFrameCacheRead analog): zlib/OCCI
        # decompression overlaps the device step
        r = PrefetchReader(r)
        hd = r.header
        src_cam, need_cal = _sens_source_cam(hd, cam)
        n = min(len(r), args.frames) if args.frames else len(r)
        try:
            for i, (d, c, p) in enumerate(r.frames()):
                if i >= n:
                    break
                if need_cal:
                    # calibration path: remap depth into color space and
                    # run the pipeline in the color camera
                    # (s_bUseCameraCalibration, CUDARGBDSensor.cpp:200-217)
                    from voxelhashing_tpu.ops.image import (
                        remap_depth_to_color)
                    d = remap_depth_to_color(
                        d, hd.calibration_depth.intrinsic,
                        hd.calibration_color.intrinsic,
                        hd.color_width, hd.color_height,
                        hd.calibration_depth.extrinsic,
                        hd.calibration_color.extrinsic)
                d, c = _resample(d, c, src_cam, cam)
                yield d, c, p
        finally:
            r.close()     # stop the decode thread (early-exit included)
    else:
        raise SystemExit(f"unknown input kind {kind!r} "
                         f"(use synthetic / tum:PATH / sens:PATH)")


def _sens_source_cam(hd, base_cam):
    """Source camera of a .sens file: the depth camera, or — when the
    color/depth calibrations actually differ (s_bUseCameraCalibration
    analog) — the color camera, into whose space the depth is remapped."""
    import dataclasses
    di = hd.calibration_depth.intrinsic
    ci = hd.calibration_color.intrinsic
    de = hd.calibration_depth.extrinsic
    ce = hd.calibration_color.extrinsic
    same_size = (hd.color_width, hd.color_height) == (hd.depth_width,
                                                      hd.depth_height)
    need_cal = not (same_size and np.allclose(di, ci, atol=1e-4)
                    and np.allclose(de, ce, atol=1e-6))
    if need_cal:
        intr, w, h = ci, hd.color_width, hd.color_height
    else:
        intr, w, h = di, hd.depth_width, hd.depth_height
    cam = dataclasses.replace(
        base_cam, width=int(w), height=int(h),
        fx=float(intr[0, 0]), fy=float(intr[1, 1]),
        cx=float(intr[0, 2]), cy=float(intr[1, 2]))
    return cam, need_cal


def _resample(depth, color, src_cam, dst_cam):
    """Nearest resample raw sensor frames to the working resolution
    (CUDARGBDAdapter's resample + intrinsics rescale)."""
    if (src_cam.width, src_cam.height) == (dst_cam.width, dst_cam.height):
        return depth, color
    ys = (np.arange(dst_cam.height) * src_cam.height
          // dst_cam.height)
    xs = (np.arange(dst_cam.width) * src_cam.width // dst_cam.width)
    d = depth[np.ix_(ys, xs)]
    c = color[np.ix_(ys, xs)] if color is not None else None
    return d, c


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "default"])
    ap.add_argument("--input", default=None,
                    help="synthetic | tum:DIR | sens:FILE")
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--gt-init", action="store_true",
                    help="seed ICP from the GT pose each frame")
    ap.add_argument("--gt", action="store_true",
                    help="use GT poses outright (no tracking)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--streaming", action="store_true")
    ap.add_argument("--sync-streaming", action="store_true",
                    help="use the synchronous (blocking) streaming manager "
                         "instead of the overlapped streaming thread")
    ap.add_argument("--mesh", default=None, help="extract mesh PLY at end")
    ap.add_argument("--cloud", default=None, help="export final point cloud")
    ap.add_argument("--save-map", default=None)
    ap.add_argument("--load-map", default=None)
    ap.add_argument("--render-dir", default=None,
                    help="dump per-frame renders (renderToFile analog)")
    ap.add_argument("--histogram", action="store_true")
    ap.add_argument("--timings", action="store_true",
                    help="per-frame per-level ICP confidence + stage timing")
    ap.add_argument("--convergence", default=None,
                    help="save per-level residual-vs-iteration curves "
                         "(ConvergenceAnalysis) to this file")
    ap.add_argument("--posegraph", action="store_true",
                    help="keyframe pose graph + loop closure + optimization")
    ap.add_argument("--record", default=None,
                    help="record the replayed sequence to a .sens file")
    ap.add_argument("--reintegrate", action="store_true",
                    help="with --posegraph: rebuild the map from the kept "
                    "frames under the loop-closed trajectory "
                    "(trajectory-consistent re-integration)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a jax.profiler trace of the frame loop "
                    "(xprof/TensorBoard; the TimingLog's device-level twin)")
    ap.add_argument("--rgbd", action="store_true",
                    help="joint photometric+geometric tracking (the "
                    "reference's useRGBDTracking variant)")
    ap.add_argument("--log", default=None,
                    help="redirect stdout to a log file (StdOutputLogger)")
    args = ap.parse_args(argv)

    if args.log:
        # batch-mode stdout redirection (DepthSensing.cpp:1322-1328)
        sys.stdout = open(args.log, "w")

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import dataclasses
    import jax.numpy as jnp
    from voxelhashing_tpu import (blockmap, diagnostics, engine, evaluation,
                                  runtime, streaming as streaming_mod)
    runtime.enable_compile_cache()

    cfg = build_config(args.preset, args.streaming)
    if args.rgbd:
        cfg = dataclasses.replace(
            cfg, tracker=dataclasses.replace(cfg.tracker, use_rgbd=True))
    if args.gt:
        cfg = dataclasses.replace(cfg, use_trajectory=True)
    elif args.gt_init:
        cfg = dataclasses.replace(cfg, use_trajectory_only_init=True)
    cam = cfg.camera
    use_hint = args.gt or args.gt_init

    # the state is donated: nothing reads the pre-step state after a call
    step = engine.make_step(cfg, with_hint=use_hint,
                            with_stream_mask=args.streaming)
    timing = diagnostics.TimingLog()
    icp_log = diagnostics.ICPErrorLog()
    conv = diagnostics.ConvergenceAnalysis() if args.convergence else None
    mgr = None
    if args.streaming:
        mgr_cls = (streaming_mod.StreamingManager if args.sync_streaming
                   else streaming_mod.AsyncStreamingManager)
        mgr = mgr_cls(cfg.map, cfg.streaming)

    state = None
    est, gts = [], []
    pg = None
    if args.posegraph:
        from voxelhashing_tpu.posegraph import PoseGraph
        pg = PoseGraph(cam)
    rec_frames = [] if (args.record or args.reintegrate) else None
    lost_streak = 0
    rtf = None
    if args.render_dir:
        from voxelhashing_tpu.render import RenderToFile
        rtf = RenderToFile(args.render_dir)

    if args.trace:
        # device-level tracing (SURVEY §5: jax.profiler/xprof is the
        # twin of the reference's CUDATimer event spans, CUDATimer.h:29-99);
        # view with TensorBoard or xprof on the written directory
        jax.profiler.start_trace(args.trace)
    t0 = time.time()
    for i, (d, c, gt_pose) in enumerate(frame_source(args, cfg)):
        if state is None:
            init = gt_pose if gt_pose is not None else np.eye(4)
            state = engine.create(cfg, initial_pose=init)
            if args.load_map:
                # with streaming: the checkpoint loads into the HOST chunk
                # store (reference load-then-stream-in semantics) so
                # checkpoints larger than the pool resume fine; the sphere
                # streams blocks in as the camera reaches them
                m, _ = streaming_mod.load_map(args.load_map, cfg.map,
                                              manager=mgr)
                state = state._replace(map=m)
        timing.frame_start()
        a = (state, jnp.asarray(np.nan_to_num(d, nan=0.0)),
             jnp.asarray(c) if c is not None else
             jnp.zeros((cam.height, cam.width, 3), jnp.float32))
        if use_hint:
            hint = gt_pose if gt_pose is not None else np.asarray(state.pose)
            a += (jnp.asarray(hint),)
        if mgr is not None:
            a += (mgr.bitmask,)
        timing.start("step")
        state, diag = step(*a)
        timing.stop("step", sync=state.pose)
        if mgr is not None:
            timing.start("streaming")
            cam_pos = np.asarray(state.pose)[:3, 3]
            new_map = mgr.step(state.map, cam_pos)
            state = state._replace(map=new_map)
            timing.stop("streaming")
        timing.frame_stop()
        # ONE device_get for the whole diagnostics pytree: separate
        # int(diag.x) reads each pay a device->host round trip
        diag = jax.device_get(diag)
        est.append(np.asarray(state.pose))
        if gt_pose is not None:
            gts.append(np.asarray(gt_pose))
        if rec_frames is not None:
            rec_frames.append((d, c))
        if pg is not None and not bool(diag.tracking_valid):
            lost_streak += 1
            if lost_streak >= 2:
                # relocalize against stored keyframes (beyond-reference
                # recovery; the reference waits for ICP to re-latch from
                # the stale pose, DepthSensing.cpp:874-879)
                from voxelhashing_tpu.ops.image import preprocess as _pp
                fr = _pp(jnp.asarray(np.nan_to_num(d, nan=0.0)), None, cam,
                         cfg.filter)
                rp, ok = pg.relocalize(fr.points, fr.normals,
                                       last_pose=np.asarray(state.pose))
                if ok:
                    state = state._replace(
                        pose=jnp.asarray(np.asarray(rp, np.float32)),
                        tracking_lost=jnp.asarray(False))
                    est[-1] = np.asarray(rp)
                    lost_streak = 0
                    print(f"  relocalized at frame {i}")
        else:
            lost_streak = 0
        if pg is not None and bool(diag.tracking_valid) \
                and pg.should_add_keyframe(i, est[-1]):
            from voxelhashing_tpu.ops.image import preprocess as _pp
            fr = _pp(jnp.asarray(np.nan_to_num(d, nan=0.0)), None, cam,
                     cfg.filter)
            n_loops = pg.add_keyframe(i, est[-1], fr.points, fr.normals)
            if n_loops:
                print(f"  loop closure: {n_loops} new edge(s), "
                      f"{len(pg.keyframes)} keyframes")
        if rtf is not None:
            from voxelhashing_tpu import engine as eng
            model = eng.render_view(state, cfg)
            rtf(model, cam=cam)
        icp_log.record_frame_levels(diag.icp_level_stats)
        if conv is not None:
            conv.record_frame(diag.icp_iter_residuals)
        print(f"frame {i:4d}: blocks={int(diag.n_allocated_blocks):6d} "
              f"active={int(diag.n_active_blocks):6d} "
              f"res={float(diag.icp_residual):.2e} "
              f"corr={int(diag.icp_corr_count):6d} "
              f"valid={bool(diag.tracking_valid)}"
              + (f" missed={int(diag.alloc_missed)}" if cfg.offline else "")
              + (f" hostblocks={mgr.host_block_count()}" if mgr else ""))
        if not bool(diag.tracking_valid) and i > 0:
            # why was the frame declared lost (ICPErrorLog-style)
            print(f"  tracking LOST: cond={float(diag.icp_condition):.2e} "
                  f"planarity_I2={float(diag.icp_planarity):.2e} "
                  f"corr={int(diag.icp_corr_count)}")
        n_free_pool = cfg.map.num_blocks - int(diag.n_allocated_blocks)
        if n_free_pool < min(5000, cfg.map.num_blocks // 8):
            # heap-exhaustion watermark warning (DepthSensing.cpp:731-735:
            # the reference warns below 5,000 free blocks)
            print(f"  WARNING: block pool low: {n_free_pool} free "
                  f"of {cfg.map.num_blocks}"
                  + (" (streaming will keep evicting)" if mgr else
                     " — consider --streaming or a larger pool"))
        if args.timings:
            print(icp_log.report_last())
    dt = time.time() - t0
    if args.trace:
        jax.profiler.stop_trace()
        print(f"profiler trace -> {args.trace}")
    n_frames = len(est)
    if mgr is not None and hasattr(mgr, "flush"):
        mgr.flush()

    if pg is not None and len(pg.keyframes) >= 2:
        pg.snapshot_originals()
        pg.optimize()
        est = pg.corrected_trajectory(est)
        n_loops = sum(1 for e in pg.edges if e.is_loop)
        print(f"pose graph: {len(pg.keyframes)} keyframes, "
              f"{len(pg.edges)} edges ({n_loops} loops), optimized")
        if args.reintegrate and rec_frames is not None:
            # trajectory-consistent re-integration (posegraph.reintegrate):
            # rebuild the map from the kept frames under the corrected
            # trajectory — the capability loop closure exists to enable
            from voxelhashing_tpu.posegraph import reintegrate
            ri_cfg = dataclasses.replace(cfg, use_trajectory=True)
            ri_step = engine.make_step(ri_cfg, with_hint=True)
            ri_state = engine.create(ri_cfg, initial_pose=est[0])

            def _ri_integrate(s, d, c, p):
                s2, _ = ri_step(s, jnp.asarray(d), jnp.asarray(c),
                                jnp.asarray(np.asarray(p, np.float32)))
                return s2

            ri_state = reintegrate(rec_frames, est, ri_cfg,
                                   lambda: ri_state, _ri_integrate)
            state = ri_state
            print(f"re-integrated {len(rec_frames)} frames under the "
                  f"corrected trajectory")
    if args.record:
        from voxelhashing_tpu.io.sensfile import write_sens
        intr = np.eye(4, dtype=np.float32)
        intr[0, 0], intr[1, 1] = cam.fx, cam.fy
        intr[0, 2], intr[1, 2] = cam.cx, cam.cy
        write_sens(args.record,
                   np.stack([f[0] for f in rec_frames]),
                   np.stack([f[1] for f in rec_frames])
                   if rec_frames[0][1] is not None else None,
                   est, intr)
        print(f"recorded {len(rec_frames)} frames -> {args.record}")
    if args.histogram:
        h = diagnostics.hash_histogram(state.map, cfg.map)
        print("hash histogram:", h)
    if args.timings:
        print(timing.report())
    if conv is not None:
        conv.save(args.convergence)
        print(f"convergence curves -> {args.convergence}")
    if args.save_map:
        # with streaming on, the checkpoint composes device rows with the
        # host chunk store (whole map, ChunkGrid.h:456-548 semantics)
        n = streaming_mod.save_map(args.save_map, state.map, cfg.map,
                                   poses=np.stack(est), manager=mgr)
        print(f"saved {n} blocks -> {args.save_map}"
              + (" (incl. host-tiered)" if mgr else ""))
    if args.mesh:
        from voxelhashing_tpu import meshing
        if mgr is not None:
            # whole-scene extraction over device + host-tiered chunks
            # (CUDAMarchingCubesHashSDF.cpp:147-190 chunk loop)
            tris, cols = meshing.extract_mesh_streamed(state.map, cfg.map,
                                                       cfg.mesh, mgr)
        else:
            tris, cols = meshing.extract_mesh(state.map, cfg.map, cfg.mesh)
        nf = meshing.save_ply(args.mesh, tris, cols)
        print(f"mesh: {len(tris)} tris -> {nf} welded faces -> {args.mesh}")
    if args.cloud:
        from voxelhashing_tpu import engine as eng, render as render_mod
        model = eng.render_view(state, cfg)
        n = render_mod.save_point_cloud(args.cloud, model.points,
                                        colors=model.color,
                                        normals=model.normals)
        print(f"point cloud: {n} points -> {args.cloud}")

    print(f"\n{n_frames} frames in {dt:.1f}s "
          f"({n_frames/max(dt,1e-9):.2f} fps incl. host loop)")
    ok = True
    if gts and not args.gt:
        ate = evaluation.ate_rmse(est, gts, align=False)
        print(f"ATE RMSE: {ate*1000:.2f} mm")
        ok &= ate < 0.05
    viol = blockmap.check_invariants(state.map, cfg.map)
    print(f"invariants: {viol}")
    ok &= all(v == 0 for v in viol.values())
    print("RESULT:", "OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
