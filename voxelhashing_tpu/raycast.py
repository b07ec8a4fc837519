"""Surface prediction: per-pixel TSDF raycast over the block-sparse map.

JAX re-derivation of ``CUDARayCastSDF`` (reference
DepthSensingCUDA/Source/CUDARayCastSDF.cu:18-57 ``renderKernel``,
``RayCastSDFUtil.h:198-262`` ``traverseCoarseGridSimpleSampleAll``):

* The per-pixel while-loop march becomes a batched ``lax.while_loop`` over
  ALL pixels with an alive mask (whole-image early exit) and a static step
  cap — no data-dependent shapes.
* **Ray-interval tile bounds**: the reference's DX11 rasterized ray-interval
  splatting is disabled in CUDA (CUDARayCastSDF.cu:40-48); here we re-enable
  the idea the XLA way — project every active block's corners, scatter-min/
  max its depth range into a coarse screen-tile grid, and march each pixel
  only within its tile's [min,max] band.  This is what bounds the march cost.
* Trilinear SDF interpolation with 8 per-corner hash lookups
  (``trilinearInterpolationSimpleFastFast``, RayCastSDFUtil.h:97-116):
  invalid if any corner voxel has zero weight.
* Zero-crossing refinement by 3 secant/bisection iterations
  (``findIntersectionBisection``, RayCastSDFUtil.h:148-170), vectorised.
* Normals: screen-space central differences of the output position map
  (``computeNormals``; analytic SDF gradients are available behind
  ``cfg.use_gradients`` like the reference's s_SDFUseGradients).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import (CameraConfig, MapConfig, RaycastConfig, SDF_BLOCK_SIZE,
                     VOXELS_PER_BLOCK)
from . import geometry as geom
from . import blockmap
from .blockmap import MapState


class RaycastResult(NamedTuple):
    """The predicted model frame (RayCastData, RayCastSDFUtil.h:266-274)."""

    depth: jax.Array    # f32[h,w]    z-depth, NaN where no surface
    points: jax.Array   # f32[h,w,3]  camera-space positions, NaN invalid
    normals: jax.Array  # f32[h,w,3]  camera-space normals, NaN invalid
    color: jax.Array    # f32[h,w,3]  surface color in [0,1]
    # i32[] surface blocks beyond the splat cull cap this frame (splat mode
    # falls back to an uncalled full-list splat when > 0; march mode: 0).
    splat_overflow: jax.Array


# ---------------------------------------------------------------------------
# Trilinear TSDF sampling
# ---------------------------------------------------------------------------

_CORNER_LIST = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)]
_CORNERS = np.array(_CORNER_LIST, np.int32)  # host constant (not a device array)


def trilinear_sample(state: MapState, p_world, cfg: MapConfig,
                     with_color: bool = False, axis_name=None):
    """Trilinearly interpolated (sdf, valid[, color]) at world points [...,3].

    Voxel samples sit at integer virtual-voxel coords (voxel*voxel_size);
    invalid if any of the 8 corners is unallocated / zero-weight
    (RayCastSDFUtil.h:97-116).  Corner-major layout: corners are stacked on
    a LEADING axis ([8,K,...]) so every per-corner op runs on flat [K]
    arrays.
    """
    shape = p_world.shape[:-1]
    pw = p_world.reshape(-1, 3)
    out = trilinear_sample_soa(state, pw[:, 0], pw[:, 1], pw[:, 2], cfg,
                               with_color=with_color, axis_name=axis_name)
    if with_color:
        s, valid, col = out
        return (s.reshape(shape), valid.reshape(shape),
                col.reshape(shape + (3,)))
    s, valid = out
    return s.reshape(shape), valid.reshape(shape)


def trilinear_sample_soa(state: MapState, px, py, pz, cfg: MapConfig,
                         with_color: bool = False, axis_name=None):
    """SoA core of :func:`trilinear_sample`: flat [K] coordinate arrays.

    ``axis_name``: hash-partitioned map over a mesh axis — corner fetches
    become masked psums (see :func:`blockmap.gather_voxels_soa`), so
    trilinear cells spanning blocks owned by DIFFERENT devices still
    interpolate correctly (no halo exchange needed)."""
    vs = cfg.voxel_size
    qx, qy, qz = px / vs, py / vs, pz / vs
    bx = jnp.floor(qx).astype(jnp.int32)
    by = jnp.floor(qy).astype(jnp.int32)
    bz = jnp.floor(qz).astype(jnp.int32)
    fx, fy, fz = qx - bx, qy - by, qz - bz

    # One batched fetch over a leading corner axis: [8,K] everywhere.
    cx = jnp.stack([bx + o[0] for o in _CORNER_LIST], axis=0)
    cy = jnp.stack([by + o[1] for o in _CORNER_LIST], axis=0)
    cz = jnp.stack([bz + o[2] for o in _CORNER_LIST], axis=0)
    sdf, w, c = blockmap.gather_voxels_soa(state, cx, cy, cz, cfg,
                                           with_color=with_color,
                                           axis_name=axis_name)  # [8,K]
    valid = jnp.all(w > 0.0, axis=0)                  # [K]

    s = jnp.zeros(fx.shape, jnp.float32)
    col = jnp.zeros(fx.shape + (3,), jnp.float32) if with_color else None
    for i, (ox, oy, oz) in enumerate(_CORNER_LIST):
        tw = ((fx if ox else 1.0 - fx) * (fy if oy else 1.0 - fy)
              * (fz if oz else 1.0 - fz))             # [K]
        s = s + tw * sdf[i]
        if with_color:
            col = col + tw[:, None] * blockmap.unpack_rgb(c[i])
    if with_color:
        return s, valid, col / 255.0
    return s, valid


def sdf_gradient(state: MapState, p_world, cfg: MapConfig,
                 axis_name=None):
    """Central-difference SDF gradient (gradientForPoint,
    RayCastSDFUtil.h:173-195). Off by default like s_SDFUseGradients."""
    offs = cfg.voxel_size
    grads = []
    ok = None
    for ax in range(3):
        e = jnp.zeros((3,), jnp.float32).at[ax].set(offs)
        sp, vp = trilinear_sample(state, p_world + e, cfg,
                                  axis_name=axis_name)
        sm, vm = trilinear_sample(state, p_world - e, cfg,
                                  axis_name=axis_name)
        grads.append((sp - sm) * 0.5)
        v = vp & vm
        ok = v if ok is None else (ok & v)
    g = jnp.stack(grads, axis=-1)
    n = jnp.linalg.norm(g, axis=-1, keepdims=True)
    good = ok & (n[..., 0] > 0.0)
    g = jnp.where(good[..., None], g / jnp.where(n > 0, n, 1.0), jnp.nan)
    return g, good


# ---------------------------------------------------------------------------
# Ray-interval tile bounds (the XLA-native ray-interval splatting)
# ---------------------------------------------------------------------------


def ray_interval_splat(state: MapState, active_idx, active_mask, view_matrix,
                       cam: CameraConfig, cfg: MapConfig, rc: RaycastConfig):
    """Per-screen-tile [min,max] z-depth bounds of the active blocks.

    The XLA replacement for the reference's rasterized per-block min/max
    quads (rayIntervalSplatKernel, CUDARayCastSDF.cu:101-167): project each
    active block's 8 corners into the camera, take its screen bbox and depth
    range, and scatter-min/max into a (tiles_y, tiles_x) grid.  Blocks whose
    bbox spans more than a static cap of tiles (or crosses the near plane)
    contribute conservatively to *all* tiles.

    Returns (t_min[tiles_y,tiles_x], t_max[tiles_y,tiles_x]) in z-depth
    metres; tiles no block touches get t_min=+inf > t_max=-inf.
    """
    tile = rc.splat_tile
    ty = -(-cam.height // tile)
    tx = -(-cam.width // tile)
    span = 4  # static per-block tile span cap (blocks are ~8px at 1m)

    blocks = geom.unpack_block_key(state.block_key[active_idx],
                                   cfg.world_blocks)             # [M,3]
    corner0 = geom.block_to_world(blocks, cfg.voxel_size)
    bsz = cfg.block_size_world
    corners = corner0[:, None, :] + bsz * _CORNERS.astype(jnp.float32)
    p_cam = geom.transform_points(view_matrix, corners)          # [M,8,3]

    z = p_cam[..., 2]
    z_min = jnp.min(z, axis=-1)
    z_max = jnp.max(z, axis=-1)
    near_ok = z_min > 1e-3          # block fully in front of the camera

    uv = geom.camera_to_screen(p_cam, cam)                       # [M,8,2]
    u_min = jnp.floor(jnp.min(uv[..., 0], axis=-1)).astype(jnp.int32)
    u_max = jnp.floor(jnp.max(uv[..., 0], axis=-1)).astype(jnp.int32)
    v_min = jnp.floor(jnp.min(uv[..., 1], axis=-1)).astype(jnp.int32)
    v_max = jnp.floor(jnp.max(uv[..., 1], axis=-1)).astype(jnp.int32)
    t0x = jnp.clip(u_min // tile, 0, tx - 1)
    t1x = jnp.clip(u_max // tile, 0, tx - 1)
    t0y = jnp.clip(v_min // tile, 0, ty - 1)
    t1y = jnp.clip(v_max // tile, 0, ty - 1)
    on_screen = (u_max >= 0) & (u_min < cam.width) \
        & (v_max >= 0) & (v_min < cam.height)

    fits = (t1x - t0x < span) & (t1y - t0y < span)
    scatter_ok = active_mask & near_ok & on_screen & fits
    # Oversized / near-plane-crossing visible blocks: conservative global band.
    overflow = active_mask & on_screen & ~(near_ok & fits)
    any_overflow = jnp.any(overflow)
    g_min = jnp.min(jnp.where(overflow, jnp.maximum(z_min, cam.depth_min),
                              jnp.inf))
    g_max = jnp.max(jnp.where(overflow, z_max, -jnp.inf))

    t_min = jnp.full((ty, tx), jnp.inf, jnp.float32)
    t_max = jnp.full((ty, tx), -jnp.inf, jnp.float32)
    for dy in range(span):
        for dx in range(span):
            iy = t0y + dy
            ix = t0x + dx
            ok = scatter_ok & (iy <= t1y) & (ix <= t1x)
            iy_s = jnp.where(ok, iy, ty)   # drop out-of-range scatters
            ix_s = jnp.where(ok, ix, tx)
            t_min = t_min.at[iy_s, ix_s].min(z_min, mode="drop")
            t_max = t_max.at[iy_s, ix_s].max(z_max, mode="drop")

    t_min = jnp.where(any_overflow, jnp.minimum(t_min, g_min), t_min)
    t_max = jnp.where(any_overflow, jnp.maximum(t_max, g_max), t_max)
    return t_min, t_max


# ---------------------------------------------------------------------------
# The march
# ---------------------------------------------------------------------------


def render(state: MapState, pose, cam: CameraConfig, cfg: MapConfig,
           rc: RaycastConfig, active_idx=None, active_mask=None,
           with_color: bool = True) -> RaycastResult:
    """Surface prediction from ``pose`` (CUDARayCastSDF::render,
    CUDARayCastSDF.cpp:38-72). Dispatches on ``rc.mode``:

    * ``"splat"`` — projective voxel splatting (:func:`render_splat`).
    * ``"march"`` — reference-style batched trilinear marching
      (:func:`render_march`); bit-for-bit closer to the CUDA traversal.
    """
    if rc.mode == "splat":
        return render_splat(state, pose, cam, cfg, rc,
                            active_idx=active_idx, active_mask=active_mask,
                            with_color=with_color)
    return render_march(state, pose, cam, cfg, rc,
                        active_idx=active_idx, active_mask=active_mask)


def render_splat(state: MapState, pose, cam: CameraConfig, cfg: MapConfig,
                 rc: RaycastConfig, active_idx=None, active_mask=None,
                 with_color: bool = True) -> RaycastResult:
    """Surface prediction by projective voxel splatting.

    Derivation: with the reference's *projective* TSDF (sdf = observed depth
    minus voxel camera z, CUDASceneRepHashSDF.cu:449), every near-surface
    voxel knows the surface z-depth along its own pixel ray:
    ``z_surface ~= z_voxel + sdf``.  So instead of marching rays through the
    hash (gather-bound, RayCastSDFUtil.h:198-262), every surface-band voxel
    of every active block *scatters* its predicted surface depth into a
    z-buffer with a scatter-min, exactly the dual of the reference's
    disabled rasterized ray-interval splatting (CUDARayCastSDF.cu:101-167).
    Zero gathers from the voxel pool per pixel; everything is block-row
    reads (DMA-friendly), elementwise math, and scatters.

    View-dependence caveat: a voxel's sdf was measured along the ray that
    integrated it; reading it along the current view ray incurs O(view
    angle delta) error — negligible for frame-to-model tracking where the
    pose delta per frame is small, and removable with
    ``rc.refine_trilinear`` (one trilinear TSDF correction per pixel).
    """
    h, w = cam.height, cam.width
    p = h * w
    view = geom.invert_rigid(pose)
    if active_idx is None:
        active_idx, n_active, _ = blockmap.compactify(state, view, cam, cfg)
        active_mask = jnp.arange(active_idx.shape[0]) < n_active

    vs = cfg.voxel_size

    # --- Surface-block cull: only ~15-30% of active (truncation-band)
    # blocks contain voxels in the narrow surface band |sdf| < voxel; the
    # expensive projection+scatter phases run only on those (static cap =
    # half the active list). If the cull overflows (surface-dense view),
    # fall back to splatting the FULL active list — slower, never lossy.
    # The PERSISTENT surface flags (maintained by integrate/insert/delete,
    # possibly stale-True after starvation — over-inclusion only) replace
    # the per-frame full-row scan of every active block.
    has_surf = state.surf[active_idx] & active_mask
    m_full = active_idx.shape[0]
    m2 = m_full // 2
    rank = jnp.cumsum(has_surf.astype(jnp.int32)) - 1
    keep = has_surf & (rank < m2)
    sel = jnp.zeros((m2,), jnp.int32).at[
        jnp.where(keep, rank, m2)].set(
        jnp.arange(m_full, dtype=jnp.int32), mode="drop")
    n_surf_total = jnp.sum(has_surf.astype(jnp.int32))
    n_surf = jnp.minimum(n_surf_total, m2)
    sel_mask = jnp.arange(m2) < n_surf
    overflow = n_surf_total - n_surf

    def _zfun(sdf_r, wgt_r, sel_a, mask_r):
        return _splat_zbuf(state, sdf_r, wgt_r, sel_a, mask_r, view, cam,
                           cfg, with_color)

    def _culled(width):
        # packed rows: voxel rows gathered only for the culled selection
        def fn(_):
            sel_a = active_idx[sel[:width]]
            return _zfun(state.sdf[sel_a], state.weight[sel_a], sel_a,
                         sel_mask[:width])
        return fn

    def splat_full(_):
        # overflow fallback: rows NOT packed (has_surf scattered); the
        # full-row gather only happens inside this (rare) branch
        return _zfun(state.sdf[active_idx], state.weight[active_idx],
                     active_idx, has_surf)

    # Two-tier splat width (the alloc-insert two-tier pattern): a view
    # whose surface blocks fit m2/2 gathers and projects half as many
    # rows; surface-dense views take the full m2 width, true overflow
    # falls back to the whole active list.
    m4 = max(m2 // 2, 8)
    zbuf, colbuf = jax.lax.cond(
        overflow > 0, splat_full,
        lambda _: jax.lax.cond(n_surf <= m4, _culled(m4), _culled(m2),
                               operand=None),
        operand=None)
    depth = jnp.where(jnp.isfinite(zbuf), zbuf, jnp.nan).reshape(h, w)
    if with_color:
        color = (blockmap.unpack_rgb(colbuf) / 255.0).reshape(h, w, 3)
    else:
        color = jnp.zeros((h, w, 3), jnp.float32)
    inf = jnp.float32(jnp.inf)

    # --- Close-range hole fill: valid-min dilation on invalid pixels. ----
    for _ in range(rc.hole_fill_rounds):
        dpad = jnp.pad(depth, 1, constant_values=jnp.nan)
        neigh = jnp.stack([dpad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                           for dy in (-1, 0, 1) for dx in (-1, 0, 1)], 0)
        valid_n = jnp.isfinite(neigh)
        filled = jnp.min(jnp.where(valid_n, neigh, inf), axis=0)
        # fill only interior holes (most neighbours valid), never extend
        # silhouette borders — border extension feeds ICP false geometry
        n_valid = jnp.sum(valid_n.astype(jnp.int32), axis=0)
        need = ~jnp.isfinite(depth) & (filled < inf) & (n_valid >= 6)
        depth = jnp.where(need, filled, depth)
        if with_color:
            # color of the filled pixel: nearest valid neighbour's color
            cpad = jnp.pad(color, ((1, 1), (1, 1), (0, 0)))
            nc = jnp.stack([cpad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                            for dy in (-1, 0, 1) for dx in (-1, 0, 1)], 0)
            pick = jnp.argmin(
                jnp.where(jnp.isfinite(neigh), neigh, inf), axis=0)
            color = jnp.where(need[..., None],
                              jnp.take_along_axis(
                                  nc, pick[None, ..., None], axis=0)[0],
                              color)

    # --- Optional trilinear refinement (one gather pass per pixel). ------
    if rc.refine_trilinear:
        u, v = geom.pixel_grid(w, h)
        xn = ((u - cam.cx) / cam.fx).reshape(-1)
        yn = ((v - cam.cy) / cam.fy).reshape(-1)
        rot = pose[:3, :3]
        dflat = depth.reshape(-1)
        t0 = jnp.nan_to_num(dflat, nan=0.0)
        hx = pose[0, 3] + (rot[0, 0] * xn + rot[0, 1] * yn + rot[0, 2]) * t0
        hy = pose[1, 3] + (rot[1, 0] * xn + rot[1, 1] * yn + rot[1, 2]) * t0
        hz = pose[2, 3] + (rot[2, 0] * xn + rot[2, 1] * yn + rot[2, 2]) * t0
        s_res, s_ok = trilinear_sample_soa(state, hx, hy, hz, cfg)
        corr = jnp.where(s_ok & jnp.isfinite(dflat), s_res, 0.0)
        depth = (dflat + corr).reshape(h, w)

    # --- Derived maps. ---------------------------------------------------
    u, v = geom.pixel_grid(w, h)
    pts = geom.screen_to_camera(u, v, depth, cam)
    pts = jnp.where(jnp.isfinite(depth)[..., None], pts, jnp.nan)
    normals = geom.normals_from_points(pts)
    color = jnp.where(jnp.isfinite(depth)[..., None], color, 0.0)
    return RaycastResult(depth=depth, points=pts, normals=normals,
                         color=color, splat_overflow=overflow)


def _splat_zbuf(state: MapState, sdf, wgt, sel_active, row_mask, view,
                cam: CameraConfig, cfg: MapConfig, with_color: bool):
    """Project the given blocks' surface-band voxels and scatter-min their
    predicted surface depths into a flat z-buffer.

    ``sdf``/``wgt``: [M,512] row-gathered voxel data for pool indices
    ``sel_active`` [M]; ``row_mask`` [M] marks real rows. Returns
    (zbuf f32[h*w] (+inf = empty), colbuf u32[h*w]).
    """
    h, w = cam.height, cam.width
    p = h * w
    vs = cfg.voxel_size
    sdf = sdf.astype(jnp.float32)        # POOL_DTYPE rows -> f32 math
    wgt = wgt.astype(jnp.float32)

    # --- Per-voxel projection (all [M,512] SoA). -------------------------
    blocks = geom.unpack_block_key(state.block_key[sel_active],
                                   cfg.world_blocks)          # [M,3]
    base = geom.block_to_voxel(blocks)
    off_x, off_y, off_z = _local_offsets()
    wx = (base[:, 0:1] + off_x[None, :]).astype(jnp.float32) * vs
    wy = (base[:, 1:2] + off_y[None, :]).astype(jnp.float32) * vs
    wz = (base[:, 2:3] + off_z[None, :]).astype(jnp.float32) * vs
    r, t = view[:3, :3], view[:3, 3]
    px = r[0, 0] * wx + r[0, 1] * wy + r[0, 2] * wz + t[0]
    py = r[1, 0] * wx + r[1, 1] * wy + r[1, 2] * wz + t[1]
    pz = r[2, 0] * wx + r[2, 1] * wy + r[2, 2] * wz + t[2]

    surface = (wgt > 0.0) & (jnp.abs(sdf) < vs) & row_mask[:, None]

    z_surf = pz + sdf            # projective-TSDF surface depth prediction
    safe_z = jnp.where(pz == 0.0, 1e-12, pz)
    ui = jnp.floor(px * cam.fx / safe_z + cam.cx + 0.5).astype(jnp.int32)
    vi = jnp.floor(py * cam.fy / safe_z + cam.cy + 0.5).astype(jnp.int32)
    ok = (surface & (pz > 0.0)
          & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
          & (z_surf > cam.depth_min) & (z_surf < cam.depth_max))
    pix = jnp.where(ok, vi * w + ui, p)                       # p = dropped

    # --- Z-buffer scatter-min (+ color recovery when asked). -------------
    # The tracking path (with_color=False) does exactly ONE scatter; color
    # recovery (a zbuf-equality gather + masked color scatter) only runs
    # for visualization renders.
    inf = jnp.float32(jnp.inf)
    zbuf = jnp.full((p,), inf, jnp.float32).at[pix].min(z_surf, mode="drop")
    if with_color:
        zhit = ok & (zbuf[jnp.clip(pix, 0, p - 1)] == z_surf)
        col = state.color[sel_active]
        colbuf = jnp.zeros((p,), jnp.uint32).at[
            jnp.where(zhit, pix, p)].set(col, mode="drop")
    else:
        colbuf = jnp.zeros((p,), jnp.uint32)
    return zbuf, colbuf


def _local_offsets():
    """SoA local voxel offsets ([512] each, x-fastest)."""
    idx = np.arange(VOXELS_PER_BLOCK, dtype=np.int32)
    return (jnp.asarray(idx % SDF_BLOCK_SIZE),
            jnp.asarray((idx // SDF_BLOCK_SIZE) % SDF_BLOCK_SIZE),
            jnp.asarray(idx // (SDF_BLOCK_SIZE * SDF_BLOCK_SIZE)))


def render_march(state: MapState, pose, cam: CameraConfig, cfg: MapConfig,
                 rc: RaycastConfig, active_idx=None, active_mask=None,
                 axis_name=None) -> RaycastResult:
    """Reference-style raycast: batched trilinear marching (see module
    docstring); the CPU-parity renderer.

    ``axis_name``: run distributed over a hash-partitioned map on a mesh
    axis — every trilinear fetch is a masked psum and the tile bounds are
    pmin/pmax-combined, so all devices march the GLOBAL surface and
    return identical (replicated) results.
    """
    h, w = cam.height, cam.width
    d = rc.derived(cfg)
    ray_inc = d["ray_increment"]
    thres_sample_dist = d["thres_sample_dist"]
    thres_dist = d["thres_dist"]

    view = geom.invert_rigid(pose)
    p = w * h

    # Per-pixel march bounds from the tile splat (else global depth range).
    if rc.splat_enabled and active_idx is not None:
        tmin_t, tmax_t = ray_interval_splat(
            state, active_idx, active_mask, view, cam, cfg, rc)
        if axis_name is not None:
            tmin_t = jax.lax.pmin(tmin_t, axis_name)
            tmax_t = jax.lax.pmax(tmax_t, axis_name)
        tile = rc.splat_tile
        iy = (jnp.arange(h) // tile)
        ix = (jnp.arange(w) // tile)
        t_min = jnp.maximum(tmin_t[iy[:, None], ix[None, :]] - cfg.truncation,
                            cam.depth_min).reshape(-1)
        t_max = jnp.minimum(tmax_t[iy[:, None], ix[None, :]] + cfg.truncation,
                            cam.depth_max).reshape(-1)
    else:
        t_min = jnp.full((p,), cam.depth_min, jnp.float32)
        t_max = jnp.full((p,), cam.depth_max, jnp.float32)

    def sample_soa(px, py, pz, with_color=False):
        return trilinear_sample_soa(state, px, py, pz, cfg,
                                    with_color=with_color,
                                    axis_name=axis_name)

    gradient_fn = None
    if rc.use_gradients:
        def gradient_fn(p_world):
            return sdf_gradient(state, p_world, cfg, axis_name=axis_name)

    return march_core(sample_soa, pose, cam, t_min, t_max,
                      num_samples=rc.num_samples, ray_inc=ray_inc,
                      thres_sample_dist=thres_sample_dist,
                      thres_dist=thres_dist, gradient_fn=gradient_fn)


def march_core(sample_soa, pose, cam: CameraConfig, t_min, t_max,
               num_samples: int, ray_inc, thres_sample_dist, thres_dist,
               gradient_fn=None) -> RaycastResult:
    """Scene-rep-agnostic batched ray march.

    ``sample_soa(px, py, pz, with_color=False)`` evaluates the TSDF at flat
    world-coordinate arrays (the hash map's trilinear fetch here; the dense
    voxel grid's in densegrid.py). ``t_min``/``t_max`` [P] bound each ray's
    march band in z-depth metres. ``gradient_fn`` (optional) enables
    analytic SDF-gradient normals (s_SDFUseGradients).
    """
    h, w = cam.height, cam.width
    view = geom.invert_rigid(pose)
    origin = pose[:3, 3]
    u, v = geom.pixel_grid(w, h)
    xn = ((u - cam.cx) / cam.fx).reshape(-1)
    yn = ((v - cam.cy) / cam.fy).reshape(-1)
    rot = pose[:3, :3]
    dwx = rot[0, 0] * xn + rot[0, 1] * yn + rot[0, 2]
    dwy = rot[1, 0] * xn + rot[1, 1] * yn + rot[1, 2]
    dwz = rot[2, 0] * xn + rot[2, 1] * yn + rot[2, 2]
    ox_, oy_, oz_ = origin[0], origin[1], origin[2]

    # --- Batched march: evaluate ALL samples in one fused pass. ----------
    # Instead of a sequential per-step loop (the reference's while-march,
    # RayCastSDFUtil.h:212-231),
    # every ray evaluates S sample positions at once ([S, P] with P minor),
    # then the first + -> - crossing is extracted with a vectorised argmax.
    s_n = num_samples
    band = jnp.maximum(t_max - t_min, 0.0)
    dt = jnp.maximum(ray_inc, band / (s_n - 1))              # [P] adaptive
    si = jnp.arange(s_n, dtype=jnp.float32)[:, None]         # [S,1]
    ts = t_min[None, :] + si * dt[None, :]                   # [S,P]
    in_band = ts <= (t_max[None, :] + dt[None, :])           # one past end

    sdf_s, ok_s = sample_soa(
        ox_ + dwx[None, :] * ts,
        oy_ + dwy[None, :] * ts,
        oz_ + dwz[None, :] * ts)                             # [S,P]
    ok_s &= in_band

    # Crossing between consecutive samples (reference test :219-230).
    cross = (ok_s[:-1] & ok_s[1:]
             & (sdf_s[:-1] > 0.0) & (sdf_s[1:] < 0.0)
             & (sdf_s[:-1] - sdf_s[1:] < thres_sample_dist))  # [S-1,P]
    found = jnp.any(cross, axis=0)                           # [P]
    first = jnp.argmax(cross, axis=0)                        # [P] first True
    b_t0 = jnp.take_along_axis(ts, first[None, :], axis=0)[0]
    b_t1 = b_t0 + dt
    b_s0 = jnp.take_along_axis(sdf_s, first[None, :], axis=0)[0]
    b_s1 = jnp.take_along_axis(sdf_s, (first + 1)[None, :], axis=0)[0]

    # Secant/bisection refinement (findIntersectionBisection,
    # RayCastSDFUtil.h:148-170), statically unrolled 3 iterations.
    for _ in range(3):
        denom = b_s0 - b_s1
        alpha = jnp.where(jnp.abs(denom) > 1e-12, b_s0 / denom, 0.5)
        tm = b_t0 + alpha * (b_t1 - b_t0)
        sm, ok = sample_soa(ox_ + dwx * tm, oy_ + dwy * tm, oz_ + dwz * tm)
        neg = ok & (sm < 0.0)
        pos = ok & (sm >= 0.0)
        b_t1 = jnp.where(neg, tm, b_t1)
        b_s1 = jnp.where(neg, sm, b_s1)
        b_t0 = jnp.where(pos, tm, b_t0)
        b_s0 = jnp.where(pos, sm, b_s0)
    denom = b_s0 - b_s1
    alpha = jnp.where(jnp.abs(denom) > 1e-12, b_s0 / denom, 0.5)
    t_hit = b_t0 + alpha * (b_t1 - b_t0)

    # Final validity: interpolated |sdf| below threshold (reference :227-230).
    hx, hy, hz = ox_ + dwx * t_hit, oy_ + dwy * t_hit, oz_ + dwz * t_hit
    s_hit, ok_hit, col = sample_soa(hx, hy, hz, with_color=True)
    p_hit = jnp.stack([hx, hy, hz], axis=-1)
    found &= ok_hit & (jnp.abs(s_hit) < thres_dist)

    depth = jnp.where(found, t_hit, jnp.nan).reshape(h, w)
    p_cam = geom.transform_points(view, p_hit).reshape(h, w, 3)
    p_cam = jnp.where(jnp.isfinite(depth)[..., None], p_cam, jnp.nan)
    color = jnp.where(found[:, None], col, 0.0).reshape(h, w, 3)

    if gradient_fn is not None:
        g, gok = gradient_fn(p_hit)
        n_world = jnp.where((found & gok)[:, None], g, jnp.nan)
        normals = geom.rotate_vectors(view, n_world).reshape(h, w, 3)
    else:
        normals = geom.normals_from_points(p_cam)
    return RaycastResult(depth=depth, points=p_cam, normals=normals,
                         color=color, splat_overflow=jnp.int32(0))
