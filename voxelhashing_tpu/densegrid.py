"""Dense TSDF voxel grid: the pre-hashing scene representation.

JAX equivalent of the original DX11 app's dense voxel-grid baseline,
which the CUDA app dropped when the sparse hash landed (SURVEY.md §2.9):

* Grid state/extent: /root/reference/DepthSensing/Source/DX11VoxelGrid.h:6-99
  (position, per-axis voxel extents, dimensions; 2 ints per voxel — f32 sdf
  + packed weight/rgb, Shaders/RayCastingUtil.h.hlsl ``setVoxel``).
* Operations: DX11VoxelGridOperations.h (reset / setDistanceFunctionEllipsoid
  / integrateDepthFrame / extractIsoSurface); kernel math in
  Shaders/IntegrateDepthFrame.hlsl (fusion + the dense app's 10x
  observed-color blend), Shaders/SetDistanceFunctionEllipsoid.hlsl,
  Shaders/RayCasting.hlsl (trilinear march + ray-box entry).

Why keep a superseded baseline: a dense [Z,Y,X] volume is the most
XLA-friendly scene rep there is — the integrate path is pure elementwise
math plus ONE image gather (no hash probes, no scatters), so it doubles as
(a) the fastest rep for small working volumes and (b) a differential-
testing oracle for the sparse map's fusion math (tests/test_densegrid.py).

Array layout: [Z, Y, X] with X minor (contiguous lanes); world position of
voxel (ix,iy,iz) = origin + (ix,iy,iz) * voxel_size, sampled at grid
CORNERS exactly like the reference (``computeSamplePositions`` =
``voxelToPosWorld``, RayCastingUtil.h.hlsl).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import CameraConfig, MeshConfig
from . import geometry as geom
from . import blockmap
from .raycast import RaycastResult, march_core
from .meshing import MeshChunk, _CUBE_CORNERS, emit_tet_triangles


@dataclasses.dataclass(frozen=True)
class DenseGridConfig:
    """Grid geometry + fusion parameters (DX11VoxelGrid.h:93-97 statics)."""

    dims: Tuple[int, int, int] = (128, 128, 128)   # voxels per axis (x,y,z)
    origin: Tuple[float, float, float] = (-1.28, -1.28, 0.5)
    voxel_size: float = 0.02
    # Fixed truncation band (IntegrateDepthFrame.hlsl:52 — the dense app
    # uses a constant, not the sparse map's distance-scaled model).
    truncation: float = 0.1
    weight_max: float = 255.0
    # The dense app's color blend gives the CURRENT observation 10x weight
    # (combineVoxel, IntegrateDepthFrame.hlsl:29-36).
    color_obs_weight: float = 10.0


class DenseGrid(NamedTuple):
    """Volume state: f32 sdf + f32 weight + packed u32 rgb per voxel."""

    sdf: jax.Array     # f32[Z,Y,X]
    weight: jax.Array  # f32[Z,Y,X]
    color: jax.Array   # u32[Z,Y,X] packed 0x00RRGGBB (blockmap.pack_rgb)


def create(cfg: DenseGridConfig) -> DenseGrid:
    """Zeroed volume (Reset.hlsl semantics: sdf 0, weight 0)."""
    nx, ny, nz = cfg.dims
    shape = (nz, ny, nx)
    return DenseGrid(sdf=jnp.zeros(shape, jnp.float32),
                     weight=jnp.zeros(shape, jnp.float32),
                     color=jnp.zeros(shape, jnp.uint32))


def _grid_world_coords(cfg: DenseGridConfig):
    """World coordinates of every voxel corner sample: 3 x f32[Z,Y,X]."""
    nx, ny, nz = cfg.dims
    ox, oy, oz = cfg.origin
    vs = cfg.voxel_size
    gx = ox + vs * jnp.arange(nx, dtype=jnp.float32)[None, None, :]
    gy = oy + vs * jnp.arange(ny, dtype=jnp.float32)[None, :, None]
    gz = oz + vs * jnp.arange(nz, dtype=jnp.float32)[:, None, None]
    return gx, gy, gz


def set_ellipsoid(grid: DenseGrid, cfg: DenseGridConfig, center, radii,
                  color=(128, 128, 128)) -> DenseGrid:
    """Analytic truncated-SDF init (SetDistanceFunctionEllipsoid.hlsl:27-60).

    The reference evaluates the normalized radial distance ``|p'| - 1``
    with p' = (p - center) / (a,b,c), truncates, and stamps weight 1.
    """
    gx, gy, gz = _grid_world_coords(cfg)
    cx, cy, cz = [jnp.float32(c) for c in center]
    a, b, c = [jnp.float32(r) for r in radii]
    px = (gx - cx) / a
    py = (gy - cy) / b
    pz = (gz - cz) / c
    sdf = jnp.sqrt(px * px + py * py + pz * pz) - 1.0
    sdf = jnp.clip(sdf, -cfg.truncation, cfg.truncation)
    sdf = jnp.broadcast_to(sdf, grid.sdf.shape)
    packed = np.uint32(
        (int(color[0]) << 16) | (int(color[1]) << 8) | int(color[2]))
    return DenseGrid(sdf=sdf, weight=jnp.ones_like(grid.weight),
                     color=jnp.full(grid.color.shape, packed, jnp.uint32))


def integrate(grid: DenseGrid, cfg: DenseGridConfig, depth, color, pose,
              cam: CameraConfig) -> DenseGrid:
    """Fuse one RGB-D frame into the full volume
    (integrateDepthFrameCS, IntegrateDepthFrame.hlsl:38-75).

    Every voxel transforms into the camera, projects to its nearest pixel,
    and fuses ``sdf_obs = depth - z_cam`` when ``sdf_obs > -truncation``
    (the whole free-space band in front of the surface integrates, unlike
    the sparse map which only touches allocated truncation-band blocks).
    Pure elementwise math + one depth/color image gather — no hash.
    """
    h, w = cam.height, cam.width
    gx, gy, gz = _grid_world_coords(cfg)
    view = geom.invert_rigid(pose)
    r, t = view[:3, :3], view[:3, 3]
    pcx = r[0, 0] * gx + r[0, 1] * gy + r[0, 2] * gz + t[0]
    pcy = r[1, 0] * gx + r[1, 1] * gy + r[1, 2] * gz + t[1]
    pcz = r[2, 0] * gx + r[2, 1] * gy + r[2, 2] * gz + t[2]

    safe_z = jnp.where(pcz == 0.0, 1e-12, pcz)
    ui = jnp.floor(pcx * cam.fx / safe_z + cam.cx + 0.5).astype(jnp.int32)
    vi = jnp.floor(pcy * cam.fy / safe_z + cam.cy + 0.5).astype(jnp.int32)
    on = ((pcz > 0.0) & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h))
    pix = jnp.where(on, vi * w + ui, 0)

    dflat = depth.reshape(-1)
    d_obs = dflat[pix]
    valid = on & jnp.isfinite(d_obs) & (d_obs > 0.0)

    sdf_obs = d_obs - pcz
    fuse = valid & (sdf_obs > -cfg.truncation)
    sdf_obs = jnp.clip(sdf_obs, -cfg.truncation, cfg.truncation)

    w_old = grid.weight
    w_new = jnp.where(fuse, jnp.minimum(w_old + 1.0, cfg.weight_max), w_old)
    denom = jnp.maximum(w_old + 1.0, 1.0)
    sdf_f = (grid.sdf * w_old + sdf_obs) / denom
    sdf = jnp.where(fuse, sdf_f, grid.sdf)

    # Color: 10x observed weight (combineVoxel, IntegrateDepthFrame.hlsl:32)
    if color is not None:
        cflat = color.reshape(-1, 3)
        c_obs = jnp.clip(cflat[pix] * 255.0, 0.0, 255.0)
        old_rgb = blockmap.unpack_rgb(grid.color)           # [Z,Y,X,3]
        k = cfg.color_obs_weight
        c_new = ((k * c_obs + w_old[..., None] * old_rgb)
                 / (k + jnp.maximum(w_old, 0.0))[..., None])
        rgb = jnp.where(fuse[..., None], c_new, old_rgb)
        packed = blockmap.pack_rgb(rgb)
    else:
        packed = grid.color
    return DenseGrid(sdf=sdf, weight=w_new, color=packed)


def _pack_quads(flat, nx: int):
    """Neighbor-packed table: row i = (v[i], v[i+1], v[i+nx], v[i+nx+1]).

    Packing a trilinear cell's same-z corners into one 4-wide row turns
    the 8 corner gathers into 2 row gathers. Rows near the flat end
    wrap — harmless, the sampler's in-bounds test already excludes cells
    whose +1 neighbours leave the grid."""
    s1 = jnp.concatenate([flat[1:], flat[:1]])
    sn = jnp.concatenate([flat[nx:], flat[:nx]])
    sn1 = jnp.concatenate([flat[nx + 1:], flat[:nx + 1]])
    return jnp.stack([flat, s1, sn, sn1], axis=1)          # [N,4]


def _packed_tables(grid: DenseGrid, cfg: DenseGridConfig,
                   with_color: bool = False):
    """Quad tables for :func:`_trilinear_packed` (build once per render)."""
    nx = cfg.dims[0]
    t = (_pack_quads(grid.sdf.reshape(-1), nx),
         _pack_quads(grid.weight.reshape(-1), nx))
    if with_color:
        t += (_pack_quads(grid.color.reshape(-1), nx),)
    return t


def _trilinear_packed(tables, cfg: DenseGridConfig, px, py, pz,
                      with_color: bool = False):
    """(sdf, valid[, color]) at flat world coordinates from quad tables."""
    nx, ny, nz = cfg.dims
    ox, oy, oz = cfg.origin
    inv = 1.0 / cfg.voxel_size
    qx = (px - ox) * inv
    qy = (py - oy) * inv
    qz = (pz - oz) * inv
    bx = jnp.floor(qx).astype(jnp.int32)
    by = jnp.floor(qy).astype(jnp.int32)
    bz = jnp.floor(qz).astype(jnp.int32)
    fx, fy, fz = qx - bx, qy - by, qz - bz
    inb = ((bx >= 0) & (bx < nx - 1) & (by >= 0) & (by < ny - 1)
           & (bz >= 0) & (bz < nz - 1))
    bx = jnp.clip(bx, 0, nx - 2)
    by = jnp.clip(by, 0, ny - 2)
    bz = jnp.clip(bz, 0, nz - 2)
    lin0 = (bz * ny + by) * nx + bx
    lin1 = lin0 + nx * ny

    sdf_q, w_q = tables[0], tables[1]
    s0 = sdf_q[lin0]                                       # [...,4] z=0
    s1 = sdf_q[lin1]                                       # [...,4] z=1
    w0 = w_q[lin0]
    w1 = w_q[lin1]
    valid = inb & jnp.all(w0 > 0.0, axis=-1) & jnp.all(w1 > 0.0, axis=-1)

    # quad row order = (x0y0, x1y0, x0y1, x1y1)
    wx = jnp.stack([1.0 - fx, fx, 1.0 - fx, fx], axis=-1)
    wy = jnp.stack([1.0 - fy, 1.0 - fy, fy, fy], axis=-1)
    wq = wx * wy                                           # [...,4]
    s = (jnp.sum(wq * s0, axis=-1) * (1.0 - fz)
         + jnp.sum(wq * s1, axis=-1) * fz)
    if with_color:
        c0 = blockmap.unpack_rgb(tables[2][lin0])          # [...,4,3]
        c1 = blockmap.unpack_rgb(tables[2][lin1])
        col = (jnp.sum(wq[..., None] * c0, axis=-2) * (1.0 - fz[..., None])
               + jnp.sum(wq[..., None] * c1, axis=-2) * fz[..., None])
        return s, valid, col / 255.0
    return s, valid


def trilinear_sample_soa(grid: DenseGrid, cfg: DenseGridConfig, px, py, pz,
                         with_color: bool = False):
    """(sdf, valid[, color]) at flat world-coordinate arrays.

    The dense analog of blockmap trilinear sampling
    (distanceForPointTriLinear, RayCasting.hlsl:71-109): invalid when any
    of the 8 corners is out of bounds or zero-weight. One-shot API —
    builds the packed tables per call; a render (5 sample passes) builds
    them once via :func:`_packed_tables`.
    """
    tables = _packed_tables(grid, cfg, with_color=with_color)
    return _trilinear_packed(tables, cfg, px, py, pz, with_color=with_color)


def _ray_box_band(pose, cam: CameraConfig, cfg: DenseGridConfig):
    """Per-pixel [t_near, t_far] z-depth band where rays overlap the grid
    box (intersectRayBoxSafe, RayCastingUtil.h.hlsl — slab test), clamped
    to the camera depth range."""
    h, w = cam.height, cam.width
    u, v = geom.pixel_grid(w, h)
    xn = ((u - cam.cx) / cam.fx).reshape(-1)
    yn = ((v - cam.cy) / cam.fy).reshape(-1)
    rot = pose[:3, :3]
    o = pose[:3, 3]
    nx, ny, nz = cfg.dims
    lo = jnp.asarray(cfg.origin, jnp.float32)
    hi = lo + cfg.voxel_size * jnp.asarray(
        [nx - 1, ny - 1, nz - 1], jnp.float32)
    t_near = jnp.full(xn.shape, cam.depth_min, jnp.float32)
    t_far = jnp.full(xn.shape, cam.depth_max, jnp.float32)
    for ax in range(3):
        d = rot[ax, 0] * xn + rot[ax, 1] * yn + rot[ax, 2]
        safe = jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
        t1 = (lo[ax] - o[ax]) / safe
        t2 = (hi[ax] - o[ax]) / safe
        tmin = jnp.minimum(t1, t2)
        tmax = jnp.maximum(t1, t2)
        t_near = jnp.maximum(t_near, tmin)
        t_far = jnp.minimum(t_far, tmax)
    return t_near, jnp.maximum(t_far, t_near)


def render(grid: DenseGrid, cfg: DenseGridConfig, pose, cam: CameraConfig,
           num_samples: int = 64, thres_dist: float = None
           ) -> RaycastResult:
    """Surface prediction over the dense grid (rayCastingCS,
    RayCasting.hlsl + DX11RayCasting.h:31-104): ray-box entry, trilinear
    march, linear zero-crossing refinement — via the shared
    :func:`raycast.march_core`."""
    t_min, t_max = _ray_box_band(pose, cam, cfg)
    td = cfg.voxel_size * 5.0 if thres_dist is None else thres_dist
    tables = _packed_tables(grid, cfg, with_color=True)

    def sample_soa(px, py, pz, with_color=False):
        return _trilinear_packed(tables, cfg, px, py, pz,
                                 with_color=with_color)

    return march_core(sample_soa, pose, cam, t_min, t_max,
                      num_samples=num_samples,
                      ray_inc=0.8 * cfg.truncation,
                      thres_sample_dist=2.0 * cfg.truncation,
                      thres_dist=td)


def extract_mesh(grid: DenseGrid, cfg: DenseGridConfig,
                 mesh_cfg: MeshConfig = None,
                 cube_cap: int = 1 << 17,
                 tri_cap: int = 1 << 18) -> MeshChunk:
    """Isosurface extraction (ExtractIsoSurface.hlsl semantics) via the
    shared marching-tetrahedra emitter.

    Surface cubes are pre-compacted exactly like the sparse path (the
    dense analog of the reference's per-voxel truncation guard,
    MarchingCubesSDFUtil.h:190-210)."""
    nx, ny, nz = cfg.dims
    vs = cfg.voxel_size
    thresh = (mesh_cfg.thresh_factor if mesh_cfg else 10.0) * vs

    near = (grid.weight > 0.0) & (jnp.abs(grid.sdf) < 2.0 * vs)
    # cubes need all 8 corners in-bounds: drop the +1 boundary layer
    near = near.at[-1, :, :].set(False).at[:, -1, :].set(False) \
               .at[:, :, -1].set(False)
    flat = near.reshape(-1)
    rank = jnp.cumsum(flat.astype(jnp.int32)) - 1
    n_total = jnp.sum(flat.astype(jnp.int32))
    keep = flat & (rank < cube_cap)
    src = jnp.arange(flat.shape[0], dtype=jnp.int32)
    slots = jnp.zeros((cube_cap,), jnp.int32).at[
        jnp.where(keep, rank, cube_cap)].set(src, mode="drop")
    n_cubes = jnp.minimum(n_total, cube_cap)
    cube_valid = jnp.arange(cube_cap) < n_cubes

    iz = slots // (ny * nx)
    iy = (slots // nx) % ny
    ix = slots % nx

    sdf_flat = grid.sdf.reshape(-1)
    w_flat = grid.weight.reshape(-1)
    c_flat = grid.color.reshape(-1)
    sdf8, pos8, col8 = [], [], []
    ox, oy, oz = cfg.origin
    for (dx, dy, dz) in _CUBE_CORNERS:
        cx = jnp.clip(ix + dx, 0, nx - 1)
        cy = jnp.clip(iy + dy, 0, ny - 1)
        cz = jnp.clip(iz + dz, 0, nz - 1)
        lin = (cz * ny + cy) * nx + cx
        sdf8.append(sdf_flat[lin])
        cube_valid &= w_flat[lin] > 0.0
        pos8.append(jnp.stack([ox + vs * cx.astype(jnp.float32),
                               oy + vs * cy.astype(jnp.float32),
                               oz + vs * cz.astype(jnp.float32)], axis=-1))
        col8.append(blockmap.unpack_rgb(c_flat[lin]) / 255.0)
    sdf8 = jnp.stack(sdf8, 0)                               # [8,C]
    span_ok = (jnp.max(sdf8, axis=0) - jnp.min(sdf8, axis=0)) < thresh
    cube_valid &= span_ok

    chunk = emit_tet_triangles(sdf8, pos8, col8, cube_valid, tri_cap)
    return chunk._replace(overflow=chunk.overflow + (n_total - n_cubes))
