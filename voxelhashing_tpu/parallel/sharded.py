"""Multi-device map sharding: the distributed reconstruction step.

The reference is strictly single-GPU (SURVEY.md §2.10); this module is the
multi-device design this engine adds, expressed as SPMD ``shard_map`` over a
1-D ``jax.sharding.Mesh``:

* **Map parallelism** (the SLAM analog of sequence parallelism): voxel
  blocks are partitioned by key hash — device ``d`` owns key ``k`` iff
  ``mix(k) % D == d``.  Every device holds a full local :class:`MapState`
  of 1/D capacity (its own open-addressing table + pool), so allocation,
  integration, compaction and GC are entirely local — zero communication.
* **Frame data is replicated** (an RGB-D frame is ~1 MB; a broadcast is
  cheap compared to partitioning voxel work).
* **Raycast**: every device splats its own blocks' surface voxels into a
  local z-buffer; a single ``lax.pmin`` over the mesh combines them into
  the global surface prediction (one collective per frame).
* **Tracking**: each device builds the 6x6 point-to-plane system over its
  row-shard of the image; ``lax.psum`` reduces (A, b, residual, count) and
  every device solves the tiny system redundantly — only collectives of
  6x6+6 floats cross the interconnect per Gauss-Newton iteration (the
  reference reads partial sums back to the CPU every iteration,
  CUDABuildLinearSystem.cpp:45; here nothing leaves the devices).

All collectives ride the mesh axis ("d"); on GPUs XLA hands them to NCCL.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import CameraConfig, EngineConfig, MapConfig
from .. import blockmap, geometry as geom, raycast, tracking
from ..blockmap import MapState
from ..geometry import INVALID_KEY
from ..ops.image import preprocess

AXIS = "d"


def local_map_config(cfg: MapConfig, n_devices: int) -> MapConfig:
    """Per-device map config: 1/D of the pool/table/active capacity."""
    return dataclasses.replace(
        cfg,
        num_blocks=max(cfg.num_blocks // n_devices, 64),
        table_size=max(cfg.table_size // n_devices, 256),
        max_active_blocks=max(cfg.max_active_blocks // n_devices, 64),
    )


def _owned(keys, n_devices):
    """Mask candidate keys to this device's hash partition."""
    me = lax.axis_index(AXIS)
    owner = (blockmap._mix(jnp.asarray(keys, jnp.uint32))
             % jnp.uint32(n_devices)).astype(jnp.int32)
    return jnp.where((owner == me) & (keys != INVALID_KEY), keys,
                     INVALID_KEY)


class ShardedState(NamedTuple):
    map: MapState          # leading axis = device shard
    pose: jax.Array        # replicated f32[4,4]
    frame: jax.Array       # replicated i32[]


def create_sharded(cfg: EngineConfig, mesh: Mesh,
                   initial_pose=None) -> Tuple[ShardedState, MapConfig]:
    """Build a device-sharded engine state on ``mesh``."""
    n_dev = mesh.devices.size
    lcfg = local_map_config(cfg.map, n_dev)
    local = blockmap.create(lcfg)
    # stack a leading device axis and shard it
    stacked = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (n_dev,) + x.shape), local)
    shard = NamedSharding(mesh, P(AXIS))
    stacked = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, shard), stacked)
    pose = jnp.eye(4, dtype=jnp.float32) if initial_pose is None \
        else jnp.asarray(initial_pose, jnp.float32)
    return ShardedState(map=stacked, pose=pose, frame=jnp.int32(0)), lcfg


def make_sharded_step(cfg: EngineConfig, mesh: Mesh,
                      with_stream_mask: bool = False):
    """jit-compiled distributed per-frame step over ``mesh``.

    Returns ``fn(sharded_state, depth, color) -> (sharded_state, pose)``;
    with ``with_stream_mask`` the step takes the (replicated) eviction
    bitmask as a 4th argument and masks allocation candidates against it
    (isSDFBlockStreamedOut — see parallel/streaming.py for the sharded
    tiering manager that maintains it).
    """
    n_dev = mesh.devices.size
    lcfg = local_map_config(cfg.map, n_dev)
    cam = cfg.camera

    use_rgbd = cfg.tracker.use_rgbd

    def local_step(mstate_b, pose, frame_idx, depth, color, bitmask=None):
        # shard_map passes the local block of the leading axis: [1, ...]
        mstate = jax.tree_util.tree_map(lambda x: x[0], mstate_b)
        frame = preprocess(depth, color, cam, cfg.filter)

        # ---- raycast own blocks + combine ------------------------------
        view = geom.invert_rigid(pose)
        active_idx, n_active, _ = blockmap.compactify(mstate, view, cam,
                                                      lcfg)
        active_mask = jnp.arange(active_idx.shape[0]) < n_active
        gmodel_int = None
        if cfg.raycast.mode == "march":
            # distributed trilinear march: every fetch is a masked psum
            # over the hash partition (raycast.render_march axis_name) —
            # all devices march the global surface; outputs replicated
            gmodel = raycast.render_march(mstate, pose, cam, lcfg,
                                          cfg.raycast,
                                          active_idx=active_idx,
                                          active_mask=active_mask,
                                          axis_name=AXIS)
            gpts, gnrm = gmodel.points, gmodel.normals
            if use_rgbd:
                from ..ops.image import color_to_intensity
                gmodel_int = jnp.where(
                    jnp.isfinite(gmodel.depth),
                    color_to_intensity(gmodel.color), jnp.nan)
        else:
            # splat local blocks, one pmin combines the z-buffers
            model = raycast.render_splat(mstate, pose, cam, lcfg,
                                         cfg.raycast,
                                         active_idx=active_idx,
                                         active_mask=active_mask,
                                         with_color=use_rgbd)
            zloc = jnp.where(jnp.isfinite(model.depth), model.depth,
                             jnp.inf)
            zglob = lax.pmin(zloc, AXIS)
            gdepth = jnp.where(jnp.isfinite(zglob), zglob, jnp.nan)
            u, v = geom.pixel_grid(cam.width, cam.height)
            gpts = geom.screen_to_camera(u, v, gdepth, cam)
            gpts = jnp.where(jnp.isfinite(gdepth)[..., None], gpts, jnp.nan)
            gnrm = geom.normals_from_points(gpts)
            if use_rgbd:
                # the device attaining the global z-min contributes its
                # color; psum of masked colors / psum of mask handles the
                # (measure-zero) tie case by averaging
                from ..ops.image import color_to_intensity
                win = ((zloc == zglob)
                       & jnp.isfinite(zglob)).astype(jnp.float32)
                csum = lax.psum(model.color * win[..., None], AXIS)
                wsum = lax.psum(win, AXIS)
                gcol = csum / jnp.maximum(wsum, 1.0)[..., None]
                gmodel_int = jnp.where(wsum > 0.0,
                                       color_to_intensity(gcol), jnp.nan)

        # ---- tracking: row-shard residuals + psum'd 6x6 system ---------
        me = lax.axis_index(AXIS)
        rows = cam.height // n_dev
        r0 = me * rows
        in_p = lax.dynamic_slice_in_dim(frame.points, r0, rows, axis=0)
        in_n = lax.dynamic_slice_in_dim(frame.normals, r0, rows, axis=0)
        in_int = None
        if use_rgbd and frame.intensity is not None:
            in_int = lax.dynamic_slice_in_dim(frame.intensity, r0, rows,
                                              axis=0)
        tr = _track_distributed(in_p, in_n, gpts, gnrm, pose, cam,
                                cfg.tracker, input_intensity=in_int,
                                model_intensity=gmodel_int)
        is_first = frame_idx == 0
        new_pose = jnp.where(is_first | ~tr.valid, pose, tr.pose)
        do_int = tr.valid | is_first

        # ---- allocate + integrate own partition ------------------------
        # THE engine pipeline (alloc fixpoint -> compactify -> integrate
        # -> GC every frame -> rehash) with the shard's capacity
        # and an ownership filter on the DDA candidates — not a fork.
        from .. import engine as engine_mod

        def integrate_branch(m):
            m2, _, _, _, _, _ = engine_mod._integrate_frame(
                m, frame, new_pose, cfg, frame_idx,
                map_cfg=lcfg, key_filter=lambda k: _owned(k, n_dev),
                stream_bitmask=bitmask)
            return m2

        mstate = lax.cond(do_int, integrate_branch, lambda m: m, mstate)
        mstate_b = jax.tree_util.tree_map(lambda x: x[None], mstate)
        return mstate_b, new_pose, frame_idx + 1

    if with_stream_mask:
        smapped = jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(P(AXIS), P(), P(), P(), P(), P()),
            out_specs=(P(AXIS), P(), P()),
            check_vma=False,
        )

        @jax.jit
        def step(state: ShardedState, depth, color, bitmask):
            m, pose, fidx = smapped(state.map, state.pose, state.frame,
                                    depth, color, bitmask)
            return ShardedState(map=m, pose=pose, frame=fidx), pose

        return step

    smapped = jax.shard_map(
        lambda mb, po, fi, d, c: local_step(mb, po, fi, d, c),
        mesh=mesh,
        in_specs=(P(AXIS), P(), P(), P(), P()),
        out_specs=(P(AXIS), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(state: ShardedState, depth, color):
        m, pose, fidx = smapped(state.map, state.pose, state.frame,
                                depth, color)
        return ShardedState(map=m, pose=pose, frame=fidx), pose

    return step


def _track_distributed(in_p, in_n, md_p, md_n, last_pose,
                       cam: CameraConfig, cfg,
                       input_intensity=None, model_intensity=None):
    """Coarse-to-fine ICP where every (A, b) is psum'd over the mesh.

    Input maps (points/normals/intensity) are this device's ROW SHARD; the
    model maps are global. Correspondence projection indexes the full model
    image, so only the reduction needs communication. This is THE engine
    tracker (:func:`voxelhashing_tpu.tracking.track`) with a psum reduction
    — not a forked copy of the loop. With intensities, the photometric
    rows are folded into the system before the psum (each device
    contributes its row shard's color residuals; see tracking.track).
    """
    psum_sys = lambda t: tuple(lax.psum(x, AXIS) for x in t)  # noqa: E731
    return tracking.track(in_p, in_n, md_p, md_n, last_pose, cam, cfg,
                          input_intensity=input_intensity,
                          model_intensity=model_intensity,
                          weight_depth=cfg.weight_depth,
                          weight_color=cfg.weight_color,
                          color_sigma=cfg.color_sigma,
                          reduce_fn=psum_sys)


def make_sharded_render(cfg: EngineConfig, mesh: Mesh, with_color=True):
    """jit-compiled distributed ``render_march`` over ``mesh``: the full
    trilinear renderer (color included) against the hash-partitioned map,
    with every corner fetch psum-combined — the render-mode / whole-scene
    visualization path under sharding. Returns
    ``fn(sharded_state, pose) -> RaycastResult`` (replicated outputs)."""
    n_dev = mesh.devices.size
    lcfg = local_map_config(cfg.map, n_dev)
    cam = cfg.camera

    def local_render(mstate_b, pose):
        mstate = jax.tree_util.tree_map(lambda x: x[0], mstate_b)
        view = geom.invert_rigid(pose)
        active_idx, n_active, _ = blockmap.compactify(mstate, view, cam,
                                                      lcfg)
        active_mask = jnp.arange(active_idx.shape[0]) < n_active
        res = raycast.render_march(mstate, pose, cam, lcfg, cfg.raycast,
                                   active_idx=active_idx,
                                   active_mask=active_mask, axis_name=AXIS)
        return res.depth, res.points, res.normals, res.color

    smapped = jax.shard_map(
        local_render, mesh=mesh,
        in_specs=(P(AXIS), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def render(state: ShardedState, pose):
        d, p, n, c = smapped(state.map, jnp.asarray(pose, jnp.float32))
        from ..raycast import RaycastResult
        return RaycastResult(depth=d, points=p, normals=n, color=c,
                             splat_overflow=jnp.int32(0))

    return render


def gather_map(state: ShardedState, lcfg: MapConfig, cfg: MapConfig
               ) -> MapState:
    """Merge all device shards into one single-device MapState (for
    meshing / checkpoint / verification)."""
    stacked = jax.device_get(state.map)
    merged = blockmap.create(cfg)
    from ..streaming import insert_blocks
    ins = jax.jit(lambda s, k, sd, w, c: insert_blocks(s, k, sd, w, c, cfg))
    n_dev = stacked.block_key.shape[0]
    for d in range(n_dev):
        keys = jnp.asarray(stacked.block_key[d])
        merged, _, _ = ins(merged, keys, jnp.asarray(stacked.sdf[d]),
                           jnp.asarray(stacked.weight[d]),
                           jnp.asarray(stacked.color[d]))
    return merged
