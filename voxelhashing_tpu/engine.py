"""The per-frame reconstruction engine: the main-loop analog.

Orchestrates the hot path the way ``reconstruction()`` does in the reference
app (/root/reference/DepthSensingCUDA/Source/DepthSensing.cpp:720-928):

    preprocess -> raycast model at last pose -> ICP track -> (lost? skip)
    -> DDA alloc -> compactify -> TSDF integrate -> garbage collect

but as ONE jit-compiled device program per frame: the only host round trip
per frame is fetching the 6-DoF pose (and optional diagnostics), versus the
reference's per-Gauss-Newton-step readbacks (CUDABuildLinearSystem.cpp:45)
and compactified-count sync (CUDASceneRepHashSDF.cu:370).

State threading is functional: :class:`EngineState` is a pytree carried
through :func:`step`; nothing is mutated host-side.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .config import EngineConfig
from . import blockmap, geometry as geom, integrate as integ, raycast, tracking
from .blockmap import MapState
from .ops.image import preprocess, FrameInputs
from .raycast import RaycastResult
from .tracking import TrackingResult


class EngineState(NamedTuple):
    map: MapState
    pose: jax.Array          # f32[4,4] current camera-to-world
    frame: jax.Array         # i32[] frame counter
    tracking_lost: jax.Array  # bool[] last frame's tracking status
    n_integrated: jax.Array  # i32[] frames actually integrated


class FrameDiagnostics(NamedTuple):
    """Per-frame numbers the reference prints (TimingLog / heap watermark /
    ICPErrorLog summaries), kept on device until the host asks."""

    n_allocated_blocks: jax.Array   # i32[] pool occupancy after this frame
    n_active_blocks: jax.Array      # i32[] in-frustum blocks this frame
    active_overflow: jax.Array      # i32[] blocks dropped by the active cap
    splat_overflow: jax.Array       # i32[] surface blocks past the splat cap
    alloc_missed: jax.Array         # i32[] allocs still pending after rounds
    icp_residual: jax.Array         # f32[]
    icp_corr_count: jax.Array       # i32[]
    icp_condition: jax.Array        # f32[]
    # per-level LinearSystemConfidence records + convergence curves (the
    # reference logs these per frame, CUDACameraTrackingMultiRes.cpp:312-319)
    icp_level_stats: jax.Array      # f32[levels,4] (res, cond, corr, sum_w)
    icp_iter_residuals: jax.Array   # f32[levels,max_iters] NaN-padded
    tracking_valid: jax.Array       # bool[]
    # planarity probe I2 of the input normals' scatter (tracking._planarity
    # observability twin; low ~<=1e-3 = bare-wall degenerate view; 0.0 in
    # GT/RGBD/disabled modes)
    icp_planarity: jax.Array = 0.0


def create(cfg: EngineConfig, initial_pose=None) -> EngineState:
    pose = jnp.eye(4, dtype=jnp.float32) if initial_pose is None \
        else jnp.asarray(initial_pose, jnp.float32)
    return EngineState(
        map=blockmap.create(cfg.map),
        pose=pose,
        frame=jnp.int32(0),
        tracking_lost=jnp.array(False),
        n_integrated=jnp.int32(0),
    )


def _integrate_frame(state: MapState, frame: FrameInputs, pose,
                     cfg: EngineConfig, frame_idx, stream_bitmask=None,
                     map_cfg=None, key_filter=None, reuse_active=None,
                     model_depth=None):
    """alloc -> compactify -> integrate -> gc (CUDASceneRepHashSDF::integrate,
    CUDASceneRepHashSDF.h:64-83).

    ``map_cfg``: overrides ``cfg.map`` (the distributed step passes its
    per-device shard capacity). ``key_filter``: optional mask over the DDA
    candidate keys (the distributed step drops keys its device does not
    own) — this single function IS the integrate pipeline for both the
    single-device and the shard_map engines.

    ``reuse_active``: optional ``(active_idx, n_active, overflow)`` from
    the raycast-pose compactify earlier in the step. When given, the
    second per-frame compactify is skipped: the integrate list = that
    list + this frame's newly allocated pool slots (read straight off the
    free stack's popped window). Blocks that entered the frustum through
    THIS frame's camera motion while already resident integrate one frame
    late — the same drop-and-retry tolerance as the reference's online
    alloc (CUDASceneRepHashSDF.h:251-267). Offline replay and the
    distributed step keep the exact per-pose compactify.
    """
    cam = cfg.camera
    mp = map_cfg if map_cfg is not None else cfg.map
    # Online: decimated two-ray-per-tile candidates (see MapConfig
    # .alloc_tile); offline fixpoint replay keeps exact per-pixel coverage.
    keys = integ.alloc_candidates(
        frame.depth, pose, cam, mp,
        tile=1 if cfg.offline else mp.alloc_tile,
        phase=None if cfg.offline else frame_idx,
        model_depth=(model_depth
                     if (not cfg.offline and mp.alloc_novelty) else None))
    if key_filter is not None:
        keys = key_filter(keys)
    if stream_bitmask is not None:
        # never re-allocate streamed-out space (isSDFBlockStreamedOut,
        # CUDASceneRepHashSDF.cu:219)
        from . import streaming as streaming_mod
        lin = streaming_mod.key_to_chunk_linear(keys, mp, cfg.streaming)
        word = stream_bitmask[lin // 32]
        bit = (word >> (lin % 32).astype(jnp.uint32)) & 1
        keys = jnp.where(bit == 1, jnp.int32(0x7FFFFFFF), keys)
    # Online mode: one alloc round per frame (missed allocs retried next
    # frame — the reference's bucket-lock drop semantics); offline replay
    # runs a bounded fixpoint loop (CUDASceneRepHashSDF.h:251-267).
    rounds = mp.alloc_rounds_offline if cfg.offline else 1
    n_free_before = state.n_free
    state, _ = blockmap.allocate(state, keys, mp, rounds=rounds)
    if cfg.offline:
        # Exact fixpoint check (off the real-time path): candidate
        # instances still absent after the bounded rounds.
        _, found = blockmap.lookup(state, keys, mp)
        alloc_missed = jnp.sum(
            ((keys != geom.INVALID_KEY) & ~found).astype(jnp.int32))
    else:
        alloc_missed = jnp.int32(0)
    if reuse_active is not None:
        active_idx, n_active, overflow = reuse_active
        cap_a = active_idx.shape[0]
        # This frame's new pool slots are exactly the free stack's popped
        # window [n_free_after, n_free_before) (pops only decrement the
        # counter; the slot values stay in place) — append them to the
        # packed active list, no second compactify.
        n_new = n_free_before - state.n_free
        cap_ins = rounds * mp.alloc_insert_cap
        j = jnp.arange(cap_ins, dtype=jnp.int32)
        slots_new = state.free_stack[
            jnp.clip(state.n_free + j, 0, mp.num_blocks - 1)]
        pos = n_active + j
        put = (j < n_new) & (pos < cap_a)
        active_idx = active_idx.at[jnp.where(put, pos, cap_a)].set(
            slots_new, mode="drop")
        overflow = overflow + jnp.maximum(n_active + n_new - cap_a, 0)
        n_active = jnp.minimum(n_active + n_new, cap_a)
    else:
        view = geom.invert_rigid(pose)
        active_idx, n_active, overflow = blockmap.compactify(state, view,
                                                             cam, mp)
    active_mask = jnp.arange(active_idx.shape[0]) < n_active
    state = integ.integrate(state, frame.depth, frame.color, pose, cam,
                            mp, active_idx=active_idx,
                            active_mask=active_mask)
    if mp.gc_enabled:
        # Reference cadence (CUDASceneRepHashSDF.h:64-83,327-333): starve
        # every `gc_starve_interval` frames, identify+free EVERY frame.
        # Starvation is FRUSTUM-scoped (off-view geometry must not decay).
        is_starve = (frame_idx > 0) \
            & (jnp.mod(frame_idx, mp.gc_starve_interval) == 0)
        state = jax.lax.cond(
            is_starve, lambda s: integ.starve(s, active_idx, active_mask),
            lambda s: s, state)
        state = integ.garbage_collect(state, active_idx, active_mask, mp)
    state = blockmap.maybe_maintain(state, mp, frame_idx)
    return state, active_idx, active_mask, n_active, overflow, alloc_missed


def step(state: EngineState, depth_raw, color_raw, cfg: EngineConfig,
         pose_hint=None, stream_bitmask=None
         ) -> Tuple[EngineState, FrameDiagnostics]:
    """Process one RGB-D frame. jit-compile via ``make_step``.

    ``pose_hint``: optional external pose (ground-truth trajectory replay,
    s_binaryDumpSensorUseTrajectory semantics). With
    ``cfg.use_trajectory=True`` the hint *is* the pose; with
    ``use_trajectory_only_init=True`` it seeds ICP.
    """
    cam = cfg.camera
    frame = preprocess(depth_raw, color_raw, cam, cfg.filter)

    is_first = state.frame == 0

    # --- Surface prediction at the last pose (model for ICP). -------------
    # With a GT-init hint the raycast ALSO happens at the hint pose (the
    # reference sets lastRigidTransform from the trajectory before the
    # render, DepthSensing.cpp:738-804) — the model must live in the same
    # camera frame the tracker treats as "last".
    raycast_pose = state.pose
    if cfg.use_trajectory_only_init and pose_hint is not None:
        raycast_pose = jnp.asarray(pose_hint, jnp.float32)
    view = geom.invert_rigid(raycast_pose)
    active_idx, n_active, overflow0 = blockmap.compactify(state.map, view,
                                                          cam, cfg.map)
    active_mask = jnp.arange(active_idx.shape[0]) < n_active
    # RGB-D tracking needs the model's intensity -> render with color
    # (the reference's RGBD variant consumes the raycast color buffer,
    # CUDACameraTrackingMultiResRGBD / CameraTrackingInput.h:17-27)
    use_rgbd = cfg.tracker.use_rgbd and not cfg.use_trajectory
    model = raycast.render(state.map, raycast_pose, cam, cfg.map, cfg.raycast,
                           active_idx=active_idx, active_mask=active_mask,
                           with_color=use_rgbd)

    # --- Tracking. --------------------------------------------------------
    if cfg.use_trajectory and pose_hint is not None:
        pose = jnp.asarray(pose_hint, jnp.float32)
        zstats, zcurve = tracking.empty_stats(cfg.tracker)
        tr = TrackingResult(pose=pose, valid=jnp.array(True),
                            residual=jnp.float32(0.0),
                            corr_count=jnp.int32(0),
                            condition=jnp.float32(0.0),
                            level_stats=zstats, iter_residuals=zcurve)
    else:
        last_pose = state.pose
        if cfg.use_trajectory_only_init and pose_hint is not None:
            last_pose = jnp.asarray(pose_hint, jnp.float32)
        if use_rgbd and frame.intensity is not None:
            from .ops.image import color_to_intensity
            model_int = jnp.where(jnp.isfinite(model.depth),
                                  color_to_intensity(model.color), jnp.nan)
            tr = tracking.track(frame.points, frame.normals,
                                model.points, model.normals,
                                last_pose, cam, cfg.tracker,
                                input_intensity=frame.intensity,
                                model_intensity=model_int,
                                weight_depth=cfg.tracker.weight_depth,
                                weight_color=cfg.tracker.weight_color,
                                color_sigma=cfg.tracker.color_sigma)
        else:
            tr = tracking.track(frame.points, frame.normals,
                                model.points, model.normals,
                                last_pose, cam, cfg.tracker)
        # Frame 0 has no model: keep the initial pose, mark valid.
        zstats, zcurve = tracking.empty_stats(cfg.tracker)
        tr = tr._replace(
            pose=jnp.where(is_first, state.pose, tr.pose),
            valid=tr.valid | is_first,
            residual=jnp.where(is_first, 0.0, tr.residual),
            corr_count=jnp.where(is_first, 0, tr.corr_count),
            condition=jnp.where(is_first, 0.0, tr.condition),
            level_stats=jnp.where(is_first, zstats, tr.level_stats),
            iter_residuals=jnp.where(is_first, zcurve, tr.iter_residuals))

    # --- Integration (skipped when tracking lost, DepthSensing.cpp:874-879).
    # Online: reuse the raycast-pose compactify above + this frame's new
    # slots (one compactify per frame); offline keeps the exact
    # new-pose compactify (fixpoint semantics).
    reuse = None if cfg.offline else (active_idx, n_active, overflow0)

    def do_integrate(m):
        new_map, _, _, n_act, ovf, missed = _integrate_frame(
            m, frame, tr.pose, cfg, state.frame,
            stream_bitmask=stream_bitmask, reuse_active=reuse,
            model_depth=model.depth)
        return new_map, n_act, ovf, missed

    def skip_integrate(m):
        return m, jnp.int32(0), jnp.int32(0), jnp.int32(0)

    new_map, n_act, overflow, alloc_missed = jax.lax.cond(
        tr.valid, do_integrate, skip_integrate, state.map)

    diag = FrameDiagnostics(
        # pool occupancy from the tracked free-stack counter (no per-frame
        # block_key reduction; stats() remains for the histogram/debug
        # paths)
        n_allocated_blocks=jnp.int32(cfg.map.num_blocks) - new_map.n_free,
        n_active_blocks=n_act,
        active_overflow=overflow,
        splat_overflow=model.splat_overflow,
        alloc_missed=alloc_missed,
        icp_residual=tr.residual,
        icp_corr_count=tr.corr_count,
        icp_condition=tr.condition,
        icp_level_stats=tr.level_stats,
        icp_iter_residuals=tr.iter_residuals,
        tracking_valid=tr.valid,
        icp_planarity=jnp.asarray(tr.planarity, jnp.float32),
    )
    new_state = EngineState(
        map=new_map,
        pose=tr.pose,
        frame=state.frame + 1,
        tracking_lost=~tr.valid,
        n_integrated=state.n_integrated + tr.valid.astype(jnp.int32),
    )
    return new_state, diag


@functools.lru_cache(maxsize=8)
def make_step(cfg: EngineConfig, with_hint: bool = False,
              donate: bool = True, with_stream_mask: bool = False):
    """jit-compiled step function for a fixed config.

    ``donate``: donate the engine state buffers (the map arrays are updated
    in place on device — essential, the pool is hundreds of MB).
    ``with_stream_mask``: step takes the streaming eviction bitmask as a
    4th argument and masks allocation candidates against it.
    """
    if with_hint and with_stream_mask:
        def fn(state, depth, color, hint, bitmask):
            return step(state, depth, color, cfg, pose_hint=hint,
                        stream_bitmask=bitmask)
    elif with_hint:
        def fn(state, depth, color, hint):
            return step(state, depth, color, cfg, pose_hint=hint)
    elif with_stream_mask:
        def fn(state, depth, color, bitmask):
            return step(state, depth, color, cfg, stream_bitmask=bitmask)
    else:
        def fn(state, depth, color):
            return step(state, depth, color, cfg)
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def render_view(state: EngineState, cfg: EngineConfig, pose=None
                ) -> RaycastResult:
    """Standalone raycast of the current map (render modes, key '1')."""
    pose = state.pose if pose is None else jnp.asarray(pose, jnp.float32)
    cam = cfg.camera
    view = geom.invert_rigid(pose)
    active_idx, n_active, _ = blockmap.compactify(state.map, view, cam,
                                                  cfg.map)
    active_mask = jnp.arange(active_idx.shape[0]) < n_active
    return raycast.render(state.map, pose, cam, cfg.map, cfg.raycast,
                          active_idx=active_idx, active_mask=active_mask)
