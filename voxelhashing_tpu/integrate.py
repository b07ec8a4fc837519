"""Depth-map integration: block allocation, TSDF fusion, garbage collection.

JAX re-derivation of the integrate pipeline of
``CUDASceneRepHashSDF`` (/root/reference/DepthSensingCUDA/Source/
CUDASceneRepHashSDF.h:64-83 ``integrate()`` = set pose -> alloc ->
compactify -> integrate -> garbageCollect):

* ``alloc_candidates``: per-pixel 3D-DDA walk through block space over the
  truncation band [d-t, d+t] (allocKernel, CUDASceneRepHashSDF.cu:158-243),
  vectorised over all pixels with a static step cap.
* ``integrate``: per-voxel projective TSDF fusion over the compacted active
  block list (integrateDepthMapKernel, :412-492) as a gather -> fuse ->
  scatter pass; the running weighted average is ``combineVoxel``
  (VoxelUtilHashSDF.h:228-250).
* ``garbage_collect``: weight starvation + min|sdf|/max-weight block culling
  (starveVoxelsKernel :512-536, garbageCollectIdentifyKernel :543-590,
  garbageCollectFreeKernel :608-628).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .config import MapConfig, CameraConfig, SDF_BLOCK_SIZE, VOXELS_PER_BLOCK
from . import geometry as geom
from . import blockmap
from .blockmap import MapState
from .geometry import INVALID_KEY


# ---------------------------------------------------------------------------
# Allocation candidates: DDA through block space along each pixel ray
# ---------------------------------------------------------------------------


def _dda_band_keys(d, valid, xn, yn, pose, cfg: MapConfig):
    """Core vectorised 3D-DDA: keys [alloc_steps, P] for the truncation
    band [d-t, d+t] along each normalised camera ray (xn, yn, 1).

    Exactly the traversal of allocKernel (CUDASceneRepHashSDF.cu:189-241),
    including the x, z, y axis tie order; invalid entries = INVALID_KEY.
    """
    valid = valid & jnp.isfinite(d) & (d > 0.0) \
        & (d < cfg.max_integration_distance)
    d = jnp.where(valid, d, 1.0)

    t = cfg.truncation_at(d)
    min_d = jnp.minimum(cfg.max_integration_distance, d - t)
    max_d = jnp.minimum(cfg.max_integration_distance, d + t)
    valid &= min_d < max_d

    r, tr = pose[:3, :3], pose[:3, 3]

    def to_world(depth_along):
        cx_, cy_, cz_ = xn * depth_along, yn * depth_along, depth_along
        return (r[0, 0] * cx_ + r[0, 1] * cy_ + r[0, 2] * cz_ + tr[0],
                r[1, 0] * cx_ + r[1, 1] * cy_ + r[1, 2] * cz_ + tr[1],
                r[2, 0] * cx_ + r[2, 1] * cy_ + r[2, 2] * cz_ + tr[2])

    ox, oy, oz = to_world(min_d)
    ex, ey, ez = to_world(max_d)
    dx, dy, dz = ex - ox, ey - oy, ez - oz
    rlen = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    rl = jnp.maximum(rlen, 1e-12)
    dx, dy, dz = dx / rl, dy / rl, dz / rl

    block_world = cfg.block_size_world
    vs = cfg.voxel_size
    inf = jnp.float32(jnp.inf)

    def block_of(px, py, pz):
        # world -> voxel (symmetric round) -> block (floor div by 8)
        def f(p):
            q = p / vs
            return jnp.floor_divide(
                (q + jnp.sign(q) * 0.5).astype(jnp.int32), SDF_BLOCK_SIZE)
        return f(px), f(py), f(pz)

    cxb, cyb, czb = block_of(ox, oy, oz)
    exb, eyb, ezb = block_of(ex, ey, ez)

    def axis_setup(c, e, o, dirc):
        step = jnp.sign(dirc).astype(jnp.int32)
        # Boundary = rounded block corner minus half a voxel
        # (SDFBlockToWorld - 0.5*voxel, CUDASceneRepHashSDF.cu:193).
        boundary = (c + jnp.clip(step, 0, 1)).astype(jnp.float32) \
            * block_world - 0.5 * vs
        safe = jnp.where(dirc == 0.0, 1e-12, dirc)
        t_max = (boundary - o) / safe
        t_delta = (step.astype(jnp.float32) * block_world) / safe
        degen = (dirc == 0.0) | (boundary - o == 0.0)
        return (step, jnp.where(degen, inf, t_max),
                jnp.where(degen, inf, t_delta), e + step)

    sx, tmx, tdx, bx = axis_setup(cxb, exb, ox, dx)
    sy, tmy, tdy, by = axis_setup(cyb, eyb, oy, dy)
    sz, tmz, tdz, bz = axis_setup(czb, ezb, oz, dz)

    half = cfg.world_blocks // 2
    wb = cfg.world_blocks

    def make_key(cx_, cy_, cz_, alive):
        gx, gy, gz = cx_ + half, cy_ + half, cz_ + half
        ok = alive & (gx >= 0) & (gx < wb) & (gy >= 0) & (gy < wb) \
            & (gz >= 0) & (gz < wb)
        key = (gz * wb + gy) * wb + gx
        return jnp.where(ok, key, INVALID_KEY)

    def dda_step(carry, _):
        cx_, cy_, cz_, tmx, tmy, tmz, alive = carry
        key = make_key(cx_, cy_, cz_, alive)
        # Step the axis with smallest t_max (reference tie order: x, z, y;
        # CUDASceneRepHashSDF.cu:228-243).
        takex = (tmx < tmy) & (tmx < tmz)
        takez = ~takex & (tmz < tmy)
        takey = ~takex & ~takez
        nx = cx_ + jnp.where(takex, sx, 0)
        ny = cy_ + jnp.where(takey, sy, 0)
        nz = cz_ + jnp.where(takez, sz, 0)
        hit_bound = (takex & (nx == bx)) | (takey & (ny == by)) \
            | (takez & (nz == bz))
        tmx = jnp.where(takex, tmx + tdx, tmx)
        tmy = jnp.where(takey, tmy + tdy, tmy)
        tmz = jnp.where(takez, tmz + tdz, tmz)
        alive = alive & ~hit_bound
        return (nx, ny, nz, tmx, tmy, tmz, alive), key

    _, keys = jax.lax.scan(
        dda_step, (cxb, cyb, czb, tmx, tmy, tmz, valid), None,
        length=cfg.alloc_steps)
    return keys


def _dedup_and_fold(k3, fold: int):
    """Shared tail of candidate generation: west/north neighbor-shift
    dedup over the [S, h, w] key grid, then per-column rank-fold into the
    first ``fold`` step slots. Returns flat int32[fold * h * w].

    Neighbor-shift dedup (pure elementwise): a block's screen footprint
    spans several pixels/tiles, so the same key appears in the west/north
    neighbor's DDA column at the same step ~4x over. Invalidating those
    instances cuts the candidate stream ~4.5x before the allocator's
    staging scatters — the key SET is unchanged (the first instance in
    scan order survives), so allocation semantics are identical.
    """
    s, h, w = k3.shape
    west = jnp.pad(k3[:, :, :-1], ((0, 0), (0, 0), (1, 0)),
                   constant_values=INVALID_KEY)
    north = jnp.pad(k3[:, :-1, :], ((0, 0), (1, 0), (0, 0)),
                    constant_values=INVALID_KEY)
    dup = ((k3 == west) | (k3 == north)) & (k3 != INVALID_KEY)
    k3 = jnp.where(dup, INVALID_KEY, k3)

    # Per-column fold: rank-compact each column's surviving keys into the
    # first `fold` step slots (pure elementwise — the allocator's
    # downstream compaction scatters scale with STREAM LENGTH). A column
    # with more survivors drops the excess for this frame — the same
    # drop-and-retry semantics as a staging collision (online retries next
    # frame, offline the fixpoint rounds).
    if fold < s:
        k2 = k3.reshape(s, h * w)
        vmask = k2 != INVALID_KEY
        rank = jnp.cumsum(vmask.astype(jnp.int32), axis=0) - 1   # [S,P]
        out = []
        for j in range(fold):
            pick = vmask & (rank == j)
            # INVALID_KEY (0x7FFFFFFF) is int32-max: min-select recovers
            # the key when present, INVALID otherwise.
            out.append(jnp.min(jnp.where(pick, k2, INVALID_KEY), axis=0))
        return jnp.stack(out, axis=0).reshape(-1)   # [fold * P]
    return k3.reshape(-1)


def alloc_candidates(depth, pose, cam: CameraConfig, cfg: MapConfig,
                     view_matrix=None, tile: int = 1, phase=None,
                     model_depth=None):
    """Block keys touched by the truncation bands of a depth frame.

    ``model_depth``: optional raycast surface prediction [h,w] (same
    camera). NOVELTY-DRIVEN allocation: a pixel whose observation agrees
    with the model within half its truncation (|d - md| < trunc(d)/2)
    already has its band fused into resident blocks — it contributes no
    new geometry and is dropped from the candidate stream, which shrinks
    ~10x in steady state (every downstream staging/probe pass scales
    with it). Disagreeing, model-invalid, streamed-out or newly revealed
    pixels stay candidates, and the online drop-and-retry semantics plus
    GC self-healing cover the residual band-edge misses (worst case the
    far band is short by tol — the surface shell itself is always
    covered). Online-only; offline fixpoint replay keeps exact coverage.

    ``tile=1``: one DDA ray per pixel over [d-t, d+t] (allocKernel,
    CUDASceneRepHashSDF.cu:158-243) — exact, used by offline replay.
    ``tile>1``: TWO rays per ``tile x tile`` pixel tile (min-depth band +
    max-depth band, tile-centre direction) — the online fast path; see
    ``MapConfig.alloc_tile`` for the coverage semantics. ``phase`` (traced
    i32 scalar, typically the frame counter) rotates the pooling-grid
    origin through the ``tile*tile`` offsets so a STATIC camera still
    converges: a tile holding 3+ distinct surfaces only ever emits its
    min/max bands, but under a rotated grid the same pixels regroup into
    different tiles frame to frame, so mid-depth bands get their turn.

    Returns flat int32 keys; invalid entries are INVALID_KEY.
    """
    h, w = depth.shape
    if tile > 1 and h % tile == 0 and w % tile == 0:
        ht, wt = h // tile, w // tile
        pv = jnp.isfinite(depth) & (depth > 0.0) \
            & (depth < cfg.max_integration_distance)
        if model_depth is not None:
            agree = (jnp.isfinite(model_depth)
                     & (jnp.abs(depth - model_depth)
                        < 0.5 * cfg.truncation_at(depth)))
            pv &= ~agree
        inf = jnp.float32(jnp.inf)
        lo = jnp.where(pv, depth, inf)
        hi = jnp.where(pv, depth, -inf)
        if phase is not None:
            # Shift the pooling grid by (py, px) pixels: roll the depth
            # maps the other way and invalidate the wrapped border rows/
            # cols (those pixels sit out this frame — drop-and-retry, same
            # as the reference's contended-alloc drops).
            ph = jnp.asarray(phase, jnp.int32)
            py = ph % tile
            px = (ph // tile) % tile
            lo = jnp.roll(lo, (-py, -px), axis=(0, 1))
            hi = jnp.roll(hi, (-py, -px), axis=(0, 1))
            rows = jnp.arange(h, dtype=jnp.int32)[:, None]
            cols = jnp.arange(w, dtype=jnp.int32)[None, :]
            wrap = (rows >= h - py) | (cols >= w - px)
            lo = jnp.where(wrap, inf, lo)
            hi = jnp.where(wrap, -inf, hi)
        else:
            py = px = jnp.int32(0)
        # Pool with strided slices instead of a [ht,t,wt,t]
        # reshape-reduce.
        for ax, sl in ((1, lambda a, o: a[:, o::tile]),
                       (0, lambda a, o: a[o::tile, :])):
            lo = jnp.min(jnp.stack([sl(lo, o) for o in range(tile)]), axis=0)
            hi = jnp.max(jnp.stack([sl(hi, o) for o in range(tile)]), axis=0)
        dmin = lo.reshape(-1)
        dmax = hi.reshape(-1)
        any_v = jnp.isfinite(dmin)
        dmin = jnp.where(any_v, dmin, 1.0)
        dmax = jnp.where(any_v, dmax, 1.0)
        # tile-centre ray direction (pixel-footprint error << block size);
        # the +phase offset keeps centres aligned with the shifted grid
        uc = (jnp.arange(wt, dtype=jnp.float32) + 0.5) * tile - 0.5 \
            + px.astype(jnp.float32)
        vc = (jnp.arange(ht, dtype=jnp.float32) + 0.5) * tile - 0.5 \
            + py.astype(jnp.float32)
        u = jnp.broadcast_to(uc[None, :], (ht, wt)).reshape(-1)
        v = jnp.broadcast_to(vc[:, None], (ht, wt)).reshape(-1)
        xn = (u - cam.cx) / cam.fx
        yn = (v - cam.cy) / cam.fy
        ka = _dda_band_keys(dmin, any_v, xn, yn, pose, cfg)   # [S, Pt]
        kb = _dda_band_keys(dmax, any_v, xn, yn, pose, cfg)
        s = cfg.alloc_steps
        ka3 = ka.reshape(s, ht, wt)
        kb3 = kb.reshape(s, ht, wt)
        # Cross-ray dedup: a depth-flat tile's two rays emit the same key
        # sequence step-aligned (or one step off when the bands straddle a
        # block boundary differently) — drop B's copies so the joint fold
        # below loses nothing on flat tiles.
        dup = (kb3 == ka3)
        dup |= kb3 == jnp.concatenate([ka3[1:], ka3[:1]], axis=0)
        dup |= kb3 == jnp.concatenate([ka3[-1:], ka3[:-1]], axis=0)
        kb3 = jnp.where(dup & (kb3 != INVALID_KEY), INVALID_KEY, kb3)
        k3 = jnp.concatenate([ka3, kb3], axis=0)              # [2S, ht, wt]
        return _dedup_and_fold(k3, min(cfg.alloc_fold_tile, 2 * s))

    d = depth.reshape(-1)
    valid = jnp.ones(d.shape, bool)
    # All per-pixel state is SoA ([P] per coordinate).
    u, v = geom.pixel_grid(w, h)
    u, v = u.reshape(-1), v.reshape(-1)
    xn = (u - cam.cx) / cam.fx            # normalised camera ray
    yn = (v - cam.cy) / cam.fy
    keys = _dda_band_keys(d, valid, xn, yn, pose, cfg)
    k3 = keys.reshape(cfg.alloc_steps, h, w)
    return _dedup_and_fold(k3, min(cfg.alloc_fold, cfg.alloc_steps))


def allocate_from_depth(state: MapState, depth, pose, cam: CameraConfig,
                        cfg: MapConfig, rounds: int = 2
                        ) -> Tuple[MapState, jax.Array]:
    """alloc() stage: DDA candidates filtered by frustum, then batch-insert.

    ``rounds=1`` is the reference's ONLINE semantics (a staging collision
    drops the alloc; the next frame retries — CUDASceneRepHashSDF alloc is
    allowed to be incomplete per frame); ``rounds=2`` approximates the
    offline fixpoint loop (CUDASceneRepHashSDF.h:251-267).

    The reference also skips streamed-out blocks via the chunk bitmask
    (isSDFBlockStreamedOut, :149-156); the streaming layer applies that mask
    before calling :func:`blockmap.allocate`.
    """
    keys = alloc_candidates(depth, pose, cam, cfg)
    return blockmap.allocate(state, keys, cfg, rounds=rounds)


# ---------------------------------------------------------------------------
# TSDF fusion
# ---------------------------------------------------------------------------


def _local_voxel_offsets():
    """[512,3] int32 local voxel offsets in x-fastest order
    (delinearizeVoxelIndex, VoxelUtilHashSDF.h:313-319)."""
    idx = jnp.arange(VOXELS_PER_BLOCK, dtype=jnp.int32)
    return geom.delinearize_voxel_index(idx)


def _pack_frame_color(color):
    """[h,w,3] f32 in [0,1] -> [h,w] u32 packed 0x00RRGGBB (x255).

    One pack per frame makes every downstream color fetch a single u32
    gather instead of a 3-wide minor-dim gather.
    """
    c = jnp.where(jnp.isfinite(color), color, -1.0) * 255.0
    valid = jnp.all(color >= 0.0, axis=-1) & jnp.all(
        jnp.isfinite(color), axis=-1)
    packed = blockmap.pack_rgb(c)
    return packed, valid


def integrate(state: MapState, depth, color, pose, cam: CameraConfig,
              cfg: MapConfig, active_idx=None, active_mask=None) -> MapState:
    """Fuse one depth (+color) frame into the active blocks.

    integrateDepthMapKernel (CUDASceneRepHashSDF.cu:412-492): for each voxel
    of each in-frustum block, project into the frame, nearest-sample depth
    and color, compute sdf = depth - p_cam.z, truncate, and fuse with the
    weighted running average ``combineVoxel`` (VoxelUtilHashSDF.h:228-250):

        sdf'    = (sdf*w + sdf_new*w_new) / (w + w_new)
        color'  = round(0.5*color + 0.5*color_new)      (50/50 blend)
        w'      = min(w + w_new, w_max)

    with the distance-scaled sample weight
    ``max(w_sample * 1.5 * (1 - depth01), 1)`` (:462).

    ``color`` may be None (depth-only integration -> green debug color, as
    the reference does at :478).
    """
    view = geom.invert_rigid(pose)
    if active_idx is None:
        active_idx, _, _ = blockmap.compactify(state, view, cam, cfg)
        active_mask = state.block_key[active_idx] != INVALID_KEY

    # All hot math below is structure-of-arrays [M,512] (512 = minor axis):
    # contiguous per-component rows instead of a strided [M,512,3] AoS.
    blocks = geom.unpack_block_key(state.block_key[active_idx],
                                   cfg.world_blocks)         # [M,3]
    base_voxel = geom.block_to_voxel(blocks)                 # [M,3]
    off = _local_voxel_offsets()                             # [512,3]
    vs = cfg.voxel_size
    wx = (base_voxel[:, 0:1] + off[None, :, 0]).astype(jnp.float32) * vs
    wy = (base_voxel[:, 1:2] + off[None, :, 1]).astype(jnp.float32) * vs
    wz = (base_voxel[:, 2:3] + off[None, :, 2]).astype(jnp.float32) * vs
    r, t = view[:3, :3], view[:3, 3]
    px = r[0, 0] * wx + r[0, 1] * wy + r[0, 2] * wz + t[0]   # [M,512]
    py = r[1, 0] * wx + r[1, 1] * wy + r[1, 2] * wz + t[1]
    pz = r[2, 0] * wx + r[2, 1] * wy + r[2, 2] * wz + t[2]

    safe_z = jnp.where(pz == 0.0, 1e-12, pz)
    uf = px * cam.fx / safe_z + cam.cx
    vf = py * cam.fy / safe_z + cam.cy
    ui = jnp.floor(uf + 0.5).astype(jnp.int32)
    vi = jnp.floor(vf + 0.5).astype(jnp.int32)
    on_screen = ((ui >= 0) & (ui < cam.width)
                 & (vi >= 0) & (vi < cam.height) & (pz > 0.0))
    ui = jnp.clip(ui, 0, cam.width - 1)
    vi = jnp.clip(vi, 0, cam.height - 1)
    pix = vi * cam.width + ui      # single linearised gather index

    d = depth.reshape(-1)[pix]                               # [M,512]
    d_valid = jnp.isfinite(d) & (d > 0.0)
    d = jnp.where(d_valid, d, 0.0)

    sdf = d - pz
    trunc = cfg.truncation_at(d)
    update = (on_screen & d_valid
              & (d < cfg.max_integration_distance)
              & (sdf > -trunc)
              & active_mask[:, None])
    sdf = jnp.clip(sdf, -trunc, trunc)

    depth01 = geom.depth_to_zero_one(d, cam)
    w_new = jnp.maximum(
        cfg.integration_weight_sample * 1.5 * (1.0 - depth01), 1.0)

    if color is not None and cfg.bilinear_color:
        # Validity-weighted bilinear color (bilinearFilterColor,
        # CUDASceneRepHashSDF.cu:379-410): 4 neighbour gathers around the
        # continuous projection, weights dropped where a corner is invalid.
        c_new, c_ok2 = _bilinear_color(color, uf, vf, cam)   # [M,512]
        update &= c_ok2
    elif color is not None:
        # frame colors are [0,1]; voxel colors 0..255 (reference scales by
        # 255 at CUDASceneRepHashSDF.cu:474); packed u32 per pixel.
        packed, c_ok = _pack_frame_color(color)
        # validity folded into the packed value (0xFF000000 flag) so color
        # costs ONE linearised gather instead of two
        packed = jnp.where(c_ok, packed | jnp.uint32(0x01000000), packed)
        pc = packed.reshape(-1)[pix]                         # [M,512] u32
        c_new = pc & jnp.uint32(0x00FFFFFF)
        update &= (pc >> 24) == 1
    else:
        c_new = jnp.full(sdf.shape, jnp.uint32(0x00FF00))    # debug green

    # rows gathered in POOL_DTYPE (bf16), fusion math in f32
    old_sdf = state.sdf[active_idx].astype(jnp.float32)
    old_w = state.weight[active_idx].astype(jnp.float32)
    old_c = state.color[active_idx]

    new_w_sum = old_w + w_new
    fused_sdf = (old_sdf * old_w + sdf * w_new) / new_w_sum
    fused_w = jnp.minimum(new_w_sum, cfg.integration_weight_max)
    # 50/50 exponential color blend with +0.5 rounding (combineVoxel),
    # carried out per channel on the packed u32s.
    fused_c = _blend_packed(old_c, c_new)

    # round to the pool's precision (unchanged rows round-trip exactly);
    # surface flags are computed from the ROUNDED values so they agree
    # bit-for-bit with what readers see in the pool. reduce_precision,
    # not a bf16->f32 convert pair: XLA:GPU may drop such a pair
    # (excess precision) and flag from the unrounded f32 value.
    out_sdf = blockmap.round_to_pool(jnp.where(update, fused_sdf, old_sdf))
    out_w = blockmap.round_to_pool(jnp.where(update, fused_w, old_w))
    out_c = jnp.where(update, fused_c, old_c)

    # persistent surface flags (read by the splat cull): recomputed for
    # every integrated block from its fused (stored-precision) rows
    out_surf = jnp.any((out_w > 0.0) & (jnp.abs(out_sdf) < cfg.voxel_size),
                       axis=1)
    out_sdf = out_sdf.astype(blockmap.POOL_DTYPE)
    out_w = out_w.astype(blockmap.POOL_DTYPE)

    safe_idx = jnp.where(active_mask, active_idx, cfg.num_blocks)
    return state._replace(
        sdf=state.sdf.at[safe_idx].set(out_sdf, mode="drop"),
        weight=state.weight.at[safe_idx].set(out_w, mode="drop"),
        color=state.color.at[safe_idx].set(out_c, mode="drop"),
        surf=state.surf.at[safe_idx].set(out_surf, mode="drop"),
    )


def _bilinear_color(color, uf, vf, cam: CameraConfig):
    """Validity-weighted bilinear color sample at continuous pixel coords.

    Mirrors bilinearFilterColor (CUDASceneRepHashSDF.cu:379-410): the four
    neighbours of the rounded centre weighted by the fractional offsets,
    invalid corners dropping out of the normalisation. Returns
    (packed u32 [...], valid bool [...]).
    """
    h, w = cam.height, cam.width
    packed, c_ok = _pack_frame_color(color)
    cflat = packed.reshape(-1)
    okflat = c_ok.reshape(-1)

    p00x = jnp.floor(uf + 0.5).astype(jnp.int32)
    p00y = jnp.floor(vf + 0.5).astype(jnp.int32)
    dirx = jnp.where(uf - p00x >= 0, 1, -1).astype(jnp.int32)
    diry = jnp.where(vf - p00y >= 0, 1, -1).astype(jnp.int32)
    alpha = (uf - p00x) * dirx
    beta = (vf - p00y) * diry

    def fetch(px, py):
        on = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        idx = jnp.clip(py, 0, h - 1) * w + jnp.clip(px, 0, w - 1)
        c = blockmap.unpack_rgb(cflat[idx])
        ok = on & okflat[idx]
        return c, ok

    c00, ok00 = fetch(p00x, p00y)
    c10, ok10 = fetch(p00x + dirx, p00y)
    c01, ok01 = fetch(p00x, p00y + diry)
    c11, ok11 = fetch(p00x + dirx, p00y + diry)

    w00 = jnp.where(ok00, (1 - alpha), 0.0)
    w10 = jnp.where(ok10, alpha, 0.0)
    s0 = c00 * w00[..., None] + c10 * w10[..., None]
    wr0 = w00 + w10
    w01 = jnp.where(ok01, (1 - alpha), 0.0)
    w11 = jnp.where(ok11, alpha, 0.0)
    s1 = c01 * w01[..., None] + c11 * w11[..., None]
    wr1 = w01 + w11

    p0 = s0 / jnp.maximum(wr0, 1e-12)[..., None]
    p1 = s1 / jnp.maximum(wr1, 1e-12)[..., None]
    wb0 = jnp.where(wr0 > 0, 1 - beta, 0.0)
    wb1 = jnp.where(wr1 > 0, beta, 0.0)
    ss = p0 * wb0[..., None] + p1 * wb1[..., None]
    ww = wb0 + wb1
    out = ss / jnp.maximum(ww, 1e-12)[..., None]
    valid = ww > 0
    return blockmap.pack_rgb(out), valid


def _blend_packed(old_c, new_c):
    """50/50 per-channel blend of packed 0x00RRGGBB u32 colors with +0.5
    rounding (combineVoxel, VoxelUtilHashSDF.h:228-250)."""
    o, n = old_c.astype(jnp.uint32), new_c.astype(jnp.uint32)
    # (o+n+1)/2 per channel == floor(0.5*o + 0.5*n + 0.5), carried out
    # without crossing channel boundaries.
    mask = jnp.uint32(0x00FF00FF)
    rb = (((o & mask) + (n & mask) + jnp.uint32(0x00010001)) >> 1) & mask
    g_mask = jnp.uint32(0x0000FF00)
    g = (((o & g_mask) + (n & g_mask) + jnp.uint32(0x00000100)) >> 1) & g_mask
    return rb | g


# ---------------------------------------------------------------------------
# Garbage collection
# ---------------------------------------------------------------------------


def starve(state: MapState, active_idx, active_mask) -> MapState:
    """Decrement every active voxel weight by 1 (starveVoxelsKernel,
    CUDASceneRepHashSDF.cu:512-536), clamped at 0."""
    # weights are integer-valued <= 255: exact in bf16, so the decrement
    # can run in POOL_DTYPE directly (no upcast round trip)
    w = state.weight[active_idx]
    w = jnp.maximum(w - jnp.asarray(1.0, w.dtype), jnp.asarray(0.0, w.dtype))
    safe_idx = jnp.where(active_mask, active_idx,
                         state.weight.shape[0])
    return state._replace(weight=state.weight.at[safe_idx].set(w, mode="drop"))


def garbage_collect(state: MapState, active_idx, active_mask,
                    cfg: MapConfig) -> MapState:
    """Cull active blocks that are all-far or all-starved.

    garbageCollectIdentifyKernel (:543-590): flag a block when
    ``min |sdf| >= truncation(depth_max)`` or ``max weight == 0``
    (min/max over the 512 voxels, ignoring zero-weight voxels for the sdf
    min, which the reference achieves by giving them PINF). Flagged blocks
    are freed and zeroed (garbageCollectFreeKernel :608-628).
    """
    sdf = state.sdf[active_idx].astype(jnp.float32)
    w = state.weight[active_idx].astype(jnp.float32)
    inf = jnp.float32(jnp.inf)
    abs_sdf = jnp.where(w > 0.0, jnp.abs(sdf), inf)
    min_sdf = jnp.min(abs_sdf, axis=-1)
    max_w = jnp.max(w, axis=-1)
    t = cfg.truncation_at(cfg.max_integration_distance)
    cull = active_mask & ((min_sdf >= t) | (max_w == 0.0))
    # Compact the (few) culled blocks to a bounded short list BEFORE the
    # free pass: delete_blocks pays a table re-probe loop + row-zeroing
    # scatters over its whole input list, and steady state culls tens of
    # blocks out of tens of thousands of active rows. Overflow past
    # gc_delete_cap re-flags from fresh stats next frame — the same
    # drop-and-retry bound as allocation staging.
    dcap = min(cfg.gc_delete_cap, active_idx.shape[0])
    rank = jnp.cumsum(cull.astype(jnp.int32)) - 1
    keep = cull & (rank < dcap)
    short_idx = jnp.zeros((dcap,), jnp.int32).at[
        jnp.where(keep, rank, dcap)].set(active_idx, mode="drop")
    n_cull = jnp.minimum(jnp.sum(cull.astype(jnp.int32)), dcap)
    short_mask = jnp.arange(dcap) < n_cull
    # The free pass (table tombstoning + row zeroing) is skipped entirely
    # on frames that cull nothing — identify runs every frame like the
    # reference, but most frames flag zero blocks.
    return jax.lax.cond(
        n_cull > 0,
        lambda s: blockmap.delete_blocks(s, short_idx, short_mask, cfg),
        lambda s: s, state)
