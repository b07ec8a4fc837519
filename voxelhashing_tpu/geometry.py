"""Coordinate transforms, camera model, and SE(3) utilities.

JAX-native (vectorised, jit-safe) re-derivations of the device math the
reference keeps in ``VoxelUtilHashSDF.h`` (world<->voxel<->block transforms,
:260-347), ``DepthCameraUtil.h`` (pinhole projection :74-122, frustum test
:141-147), and ``CUDACameraTrackingMultiRes.cpp`` (Euler ZYX delinearisation
:194-211).

Conventions (match the reference):
  * Camera frame: x right, y down, z forward; depth = z.
  * ``pose`` is a 4x4 camera-to-world rigid transform (the reference's
    ``m_rigidTransform``); its inverse is the view matrix.
  * Voxel coordinates are "virtual voxel positions": world / voxel_size,
    rounded symmetrically around 0 (sign-aware, VoxelUtilHashSDF.h:266-270).
  * A block is SDF_BLOCK_SIZE^3 voxels; block coords use floor division with
    the reference's negative-coordinate correction (:272-283).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .config import SDF_BLOCK_SIZE, CameraConfig

# Rigid transforms are pinned to full f32: at default precision a GPU may
# run an f32 product in TF32 (10 mantissa bits, ~1 mm at 2 m).
_HI = jax.lax.Precision.HIGHEST

# ---------------------------------------------------------------------------
# Voxel / block coordinate transforms
# ---------------------------------------------------------------------------


def world_to_voxel_f(pos, voxel_size):
    """World position -> continuous virtual-voxel coordinates ([...,3] f32)."""
    return pos / voxel_size


def world_to_voxel(pos, voxel_size):
    """World position -> integer virtual-voxel coordinates.

    Symmetric rounding: int(p + sign(p)*0.5) (VoxelUtilHashSDF.h:266-270).
    Note sign(0) = 0 so exact zeros round to 0, matching CUDA's sign().
    """
    p = pos / voxel_size
    return (p + jnp.sign(p) * 0.5).astype(jnp.int32)


def voxel_to_block(voxel):
    """Integer voxel coords -> block coords (floor division by 8).

    The reference implements floor division on truncating C division by
    shifting negatives (VoxelUtilHashSDF.h:272-283); in JAX ``//`` already
    floors.
    """
    return jnp.floor_divide(voxel, SDF_BLOCK_SIZE)


def block_to_voxel(block):
    """Block coords -> voxel coords of the block's corner sample (:286-289)."""
    return block * SDF_BLOCK_SIZE


def voxel_to_world(voxel, voxel_size):
    """Integer voxel coords -> world position of the sample point (:292-295)."""
    return voxel.astype(jnp.float32) * voxel_size


def block_to_world(block, voxel_size):
    return voxel_to_world(block_to_voxel(block), voxel_size)


def world_to_block(pos, voxel_size):
    return voxel_to_block(world_to_voxel(pos, voxel_size))


def voxel_local_index(voxel):
    """Voxel coords -> linear index within its block, in [0, 512).

    Python-style modulo already yields non-negative remainders for negative
    coordinates (the reference fixes up C's remainder, :327-341).
    """
    local = jnp.remainder(voxel, SDF_BLOCK_SIZE)
    return (local[..., 2] * SDF_BLOCK_SIZE + local[..., 1]) * SDF_BLOCK_SIZE \
        + local[..., 0]


def delinearize_voxel_index(idx):
    """Linear index in [0,512) -> local (x,y,z) in [0,8)^3 (:313-319)."""
    x = idx % SDF_BLOCK_SIZE
    y = (idx // SDF_BLOCK_SIZE) % SDF_BLOCK_SIZE
    z = idx // (SDF_BLOCK_SIZE * SDF_BLOCK_SIZE)
    return jnp.stack([x, y, z], axis=-1)


# ---------------------------------------------------------------------------
# Block keys: pack block coords into one int32
# ---------------------------------------------------------------------------

# Block coordinates live in [-world_blocks/2, world_blocks/2). With the
# default world_blocks=1024, keys use 30 bits and fit an int32. This replaces
# the reference's int3 HashEntry.pos field; the streaming layer owns space
# beyond this extent.

INVALID_KEY = 0x7FFFFFFF  # Python int, NOT a jnp scalar: a module-level
# device array would be captured as a constant into every jit program


def pack_block_key(block, world_blocks: int):
    """Block coords [...,3] int32 -> sortable scalar key [...] int32.

    Out-of-extent blocks map to INVALID_KEY.
    """
    half = world_blocks // 2
    shifted = block + half
    in_range = jnp.all((shifted >= 0) & (shifted < world_blocks), axis=-1)
    key = (shifted[..., 2] * world_blocks + shifted[..., 1]) * world_blocks \
        + shifted[..., 0]
    return jnp.where(in_range, key, INVALID_KEY)


def unpack_block_key(key, world_blocks: int):
    """Inverse of :func:`pack_block_key` (valid keys only)."""
    half = world_blocks // 2
    x = key % world_blocks
    y = (key // world_blocks) % world_blocks
    z = key // (world_blocks * world_blocks)
    return jnp.stack([x, y, z], axis=-1) - half


# ---------------------------------------------------------------------------
# Pinhole camera
# ---------------------------------------------------------------------------


def camera_to_screen(pos, cam: CameraConfig):
    """Camera-space point [...,3] -> continuous pixel coords [...,2].

    (DepthCameraUtil.h:74-79.)
    """
    z = pos[..., 2]
    u = pos[..., 0] * cam.fx / z + cam.cx
    v = pos[..., 1] * cam.fy / z + cam.cy
    return jnp.stack([u, v], axis=-1)


def camera_to_screen_int(pos, cam: CameraConfig):
    """Nearest-pixel projection (+0.5 then truncate, DepthCameraUtil.h:81-84).

    Note: C float->int casts truncate toward zero; for the (rare) negative
    continuous coordinates this differs from floor, and those pixels are
    off-screen anyway, so we use floor for determinism.
    """
    return jnp.floor(camera_to_screen(pos, cam) + 0.5).astype(jnp.int32)


def screen_to_camera(u, v, depth, cam: CameraConfig):
    """Pixel + depth -> camera-space point (kinectDepthToSkeleton, :117-122)."""
    x = (u - cam.cx) / cam.fx
    y = (v - cam.cy) / cam.fy
    return jnp.stack([depth * x, depth * y, depth], axis=-1)


def depth_to_zero_one(z, cam: CameraConfig):
    """Normalised depth in [0,1] (cameraToKinectProjZ, :93-96)."""
    return (z - cam.depth_min) / (cam.depth_max - cam.depth_min)


def camera_to_ndc(pos, cam: CameraConfig):
    """Camera point -> NDC (cameraToKinectProj, :99-110). y is flipped."""
    uv = camera_to_screen(pos, cam)
    x = (2.0 * uv[..., 0] - (cam.width - 1.0)) / (cam.width - 1.0)
    y = ((cam.height - 1.0) - 2.0 * uv[..., 1]) / (cam.height - 1.0)
    z = depth_to_zero_one(pos[..., 2], cam)
    return jnp.stack([x, y, z], axis=-1)


def in_frustum_approx(world_pos, view_matrix, cam: CameraConfig,
                      shrink: float = 0.95):
    """Approximate frustum test with the reference's 0.95 NDC shrink hack
    (DepthCameraUtil.h:141-147)."""
    p_cam = transform_points(view_matrix, world_pos)
    ndc = camera_to_ndc(p_cam, cam) * shrink
    return (
        (ndc[..., 0] >= -1.0) & (ndc[..., 0] <= 1.0)
        & (ndc[..., 1] >= -1.0) & (ndc[..., 1] <= 1.0)
        & (ndc[..., 2] >= 0.0) & (ndc[..., 2] <= 1.0)
    )


def block_in_frustum(block, view_matrix, cam: CameraConfig, voxel_size):
    """Frustum test at the block centre (isSDFBlockInCameraFrustumApprox,
    VoxelUtilHashSDF.h:305-309): corner + 0.5*voxel*(8-1)."""
    centre = block_to_world(block, voxel_size) \
        + 0.5 * voxel_size * (SDF_BLOCK_SIZE - 1.0)
    return in_frustum_approx(centre, view_matrix, cam)


def pixel_grid(width: int, height: int):
    """Integer pixel coordinate grids (u[h,w], v[h,w]) as float32."""
    v, u = jnp.meshgrid(jnp.arange(height, dtype=jnp.float32),
                        jnp.arange(width, dtype=jnp.float32), indexing="ij")
    return u, v


def depth_to_points(depth, cam: CameraConfig):
    """Depth image [h,w] -> camera-space position map [h,w,3]; invalid depth
    (<=0 or nan) -> nan (the reference uses MINF)."""
    u, v = pixel_grid(cam.width, cam.height)
    pts = screen_to_camera(u, v, depth, cam)
    valid = jnp.isfinite(depth) & (depth > 0.0)
    return jnp.where(valid[..., None], pts, jnp.nan)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


def transform_points(mat4, pts):
    """Apply a 4x4 rigid transform to points [...,3]."""
    return jnp.matmul(pts, mat4[:3, :3].T, precision=_HI) + mat4[:3, 3]


def rotate_vectors(mat4, vecs):
    """Apply only the rotation part to vectors [...,3]."""
    return jnp.matmul(vecs, mat4[:3, :3].T, precision=_HI)


def invert_rigid(mat4):
    """Inverse of a rigid 4x4 transform (R^T, -R^T t)."""
    r_t = mat4[:3, :3].T
    t = -jnp.matmul(r_t, mat4[:3, 3], precision=_HI)
    out = jnp.eye(4, dtype=mat4.dtype)
    out = out.at[:3, :3].set(r_t)
    out = out.at[:3, 3].set(t)
    return out


def euler_zyx_to_matrix(angles):
    """R = Rz(a0) @ Ry(a1) @ Rx(a2) -- the reference's delinearisation order
    (CUDACameraTrackingMultiRes.cpp:196-199)."""
    cz, sz = jnp.cos(angles[0]), jnp.sin(angles[0])
    cy, sy = jnp.cos(angles[1]), jnp.sin(angles[1])
    cx, sx = jnp.cos(angles[2]), jnp.sin(angles[2])
    rz = jnp.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]])
    ry = jnp.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    rx = jnp.array([[1.0, 0.0, 0.0], [0.0, cx, -sx], [0.0, sx, cx]])
    return jnp.matmul(jnp.matmul(rz, ry, precision=_HI), rx, precision=_HI)


def pose_from_x(x):
    """6-vector (alpha, beta, gamma, tx, ty, tz) -> 4x4 rigid transform.

    Matches delinearizeTransformation with mean=0, meanStDev=1 (the CUDA
    tracker always passes those, CUDACameraTrackingMultiRes.cpp:341-344).
    """
    r = euler_zyx_to_matrix(x[:3])
    out = jnp.eye(4, dtype=jnp.float32)
    out = out.at[:3, :3].set(r)
    out = out.at[:3, 3].set(x[3:6])
    return out


def rotation_angle(r):
    """Rotation angle of a 3x3 rotation matrix (Eigen::AngleAxisf equivalent,
    used by checkRigidTransformation :183-192)."""
    trace = jnp.clip((jnp.trace(r) - 1.0) * 0.5, -1.0, 1.0)
    return jnp.arccos(trace)


def normals_from_points(points):
    """Screen-space normals by central differences of the position map.

    Re-derivation of computeNormals (CameraUtil.cu:669-714): the reference
    computes n = -cross(p[y+1]-p[y-1], p[x+1]-p[x-1]) / |.| (note the
    negation at CameraUtil.cu:692). With x right / y down / z forward this
    yields +z for a front-facing wall; what matters for ICP is that input
    and model normals use the same convention. Edge pixels are invalid.
    """
    # Neighbour differences (pad edges with nan -> invalid).
    nan = jnp.nan
    py = jnp.pad(points, ((1, 1), (0, 0), (0, 0)), constant_values=nan)
    px = jnp.pad(points, ((0, 0), (1, 1), (0, 0)), constant_values=nan)
    ddy = py[2:, :, :] - py[:-2, :, :]
    ddx = px[:, 2:, :] - px[:, :-2, :]
    n = -jnp.cross(ddy, ddx)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    valid = jnp.isfinite(norm) & (norm > 0.0)
    n = jnp.where(valid, n / jnp.where(valid, norm, 1.0), nan)
    return n
