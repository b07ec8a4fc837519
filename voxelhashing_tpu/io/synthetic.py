"""Synthetic RGB-D sequence generator (offline-replay test source).

Plays the role of the reference's offline readers (BinaryDumpReader /
SensorDataReader with ground-truth trajectories, RGBDSensor.h:85-100) in an
environment with no datasets: renders exact depth images of an analytic
scene (plane + spheres) along a known camera trajectory so end-to-end tests
can check TSDF values, raycast depth, ICP pose recovery, and ATE against
ground truth.

Camera convention matches the engine: x right, y down, z forward;
pose = camera-to-world.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..config import CameraConfig


@dataclasses.dataclass(frozen=True)
class Sphere:
    center: Tuple[float, float, float]
    radius: float
    color: Tuple[float, float, float] = (0.8, 0.3, 0.2)


@dataclasses.dataclass(frozen=True)
class Box:
    """Axis-aligned box (clutter/occluder primitive for stress scenes)."""

    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]
    color: Tuple[float, float, float] = (0.7, 0.5, 0.2)


@dataclasses.dataclass(frozen=True)
class Scene:
    """A wall plane z = wall_z (world) plus spheres/boxes in front of it."""

    wall_z: float = 2.5
    wall_color: Tuple[float, float, float] = (0.6, 0.6, 0.65)
    floor_y: Optional[float] = 1.0   # plane y = floor_y (y points down)
    floor_color: Tuple[float, float, float] = (0.45, 0.4, 0.35)
    spheres: Tuple[Sphere, ...] = (
        Sphere(center=(0.0, 0.2, 1.8), radius=0.3),
        Sphere(center=(-0.5, -0.2, 2.0), radius=0.25,
               color=(0.2, 0.5, 0.8)),
    )
    boxes: Tuple[Box, ...] = ()

    def sdf(self, p: np.ndarray) -> np.ndarray:
        """Signed distance to the scene surface at world points [...,3]."""
        d = self.wall_z - p[..., 2]
        if self.floor_y is not None:
            d = np.minimum(d, self.floor_y - p[..., 1])
        for s in self.spheres:
            d = np.minimum(
                d, np.linalg.norm(p - np.asarray(s.center), axis=-1) - s.radius)
        for b in self.boxes:
            lo = np.asarray(b.lo, np.float32)
            hi = np.asarray(b.hi, np.float32)
            c = (lo + hi) * 0.5
            h = (hi - lo) * 0.5
            q = np.abs(p - c) - h
            outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
            inside = np.minimum(np.max(q, axis=-1), 0.0)
            d = np.minimum(d, outside + inside)
        return d


def render_depth(pose: np.ndarray, cam: CameraConfig, scene: Scene,
                 noise_sigma: float = 0.0, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact depth + color render via analytic ray intersections.

    Returns (depth [h,w] float32 metres with NaN invalid,
             color [h,w,3] float32 in [0,1]).
    """
    h, w = cam.height, cam.width
    v, u = np.meshgrid(np.arange(h, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing="ij")
    # Unit-z ray directions in camera space.
    dirs_cam = np.stack([(u - cam.cx) / cam.fx,
                         (v - cam.cy) / cam.fy,
                         np.ones_like(u)], axis=-1)
    r = pose[:3, :3].astype(np.float32)
    t = pose[:3, 3].astype(np.float32)
    dirs = dirs_cam @ r.T            # world-space, z-depth parameterised
    origin = t

    best_t = np.full((h, w), np.inf, np.float32)
    color = np.zeros((h, w, 3), np.float32)

    def consider(t_hit, mask, col):
        nonlocal best_t, color
        better = mask & (t_hit < best_t) & (t_hit > 0.05)
        best_t = np.where(better, t_hit, best_t)
        color = np.where(better[..., None], np.asarray(col, np.float32), color)

    # Wall plane z = wall_z: origin.z + t*dir.z = wall_z.
    dz = dirs[..., 2]
    t_wall = np.where(np.abs(dz) > 1e-9, (scene.wall_z - origin[2]) / dz, np.inf)
    consider(t_wall, np.isfinite(t_wall), scene.wall_color)

    if scene.floor_y is not None:
        dy = dirs[..., 1]
        t_floor = np.where(np.abs(dy) > 1e-9,
                           (scene.floor_y - origin[1]) / dy, np.inf)
        consider(t_floor, np.isfinite(t_floor), scene.floor_color)

    for s in scene.spheres:
        oc = origin - np.asarray(s.center, np.float32)
        a = np.sum(dirs * dirs, axis=-1)
        b = 2.0 * np.sum(dirs * oc, axis=-1)
        c = float(np.dot(oc, oc) - s.radius ** 2)
        disc = b * b - 4 * a * c
        hit = disc > 0
        sq = np.sqrt(np.maximum(disc, 0.0))
        t_s = (-b - sq) / (2 * a)
        consider(t_s, hit, s.color)

    for bx in scene.boxes:
        # Slab-method ray/AABB intersection, vectorised over pixels.
        lo = np.asarray(bx.lo, np.float32)
        hi = np.asarray(bx.hi, np.float32)
        safe = np.where(np.abs(dirs) > 1e-12, dirs, 1e-12)
        t0 = (lo - origin) / safe
        t1 = (hi - origin) / safe
        t_near = np.max(np.minimum(t0, t1), axis=-1)
        t_far = np.min(np.maximum(t0, t1), axis=-1)
        hit = (t_near <= t_far) & (t_far > 0.0)
        consider(np.where(t_near > 0.0, t_near, np.inf), hit, bx.color)

    # best_t parameterises unit-z rays, so it IS the z-depth.
    depth = np.where(np.isfinite(best_t), best_t, np.nan).astype(np.float32)
    depth = np.where((depth >= cam.depth_min) & (depth <= cam.depth_max),
                     depth, np.nan)
    if noise_sigma > 0.0:
        rng = np.random.default_rng(seed)
        depth = depth + rng.normal(
            0.0, noise_sigma, depth.shape).astype(np.float32)
    return depth, color


def kinect_noise(depth: np.ndarray, cam: CameraConfig, seed: int = 0,
                 baseline: float = 0.075, dropout_grad: float = 0.04,
                 salt_dropout: float = 0.002,
                 fx_raw: float = 580.0) -> np.ndarray:
    """Realistic structured-light depth corruption (stress-test model).

    Models the three dominant Kinect-class artifacts the reference's real
    replays contain (BinaryDumpReader/.sens dumps of actual sensors):

    * **Disparity quantisation**: depth is observed as d = f*b/z rounded to
      1/8 disparity steps, so axial error grows ~z^2 and depth comes in
      discrete slabs.
    * **Axial Gaussian noise** on the disparity (constant in disparity =
      quadratic in depth), sigma = 1/12 disparity step.
    * **Edge dropout**: pixels across strong depth discontinuities return
      invalid (occlusion shadows of the projector), plus a small salt
      dropout everywhere.
    """
    rng = np.random.default_rng(seed)
    # quantisation is a property of the RAW sensor (640-px-class fx), not of
    # the downsampled working resolution
    fb = fx_raw * baseline
    valid = np.isfinite(depth) & (depth > 0)
    z = np.where(valid, depth, 1.0)
    disp = fb / z                               # disparity in pixels
    disp = disp + rng.normal(0.0, 1.0 / 12.0, disp.shape)
    disp = np.round(disp * 8.0) / 8.0           # 1/8-pixel quantisation
    z_q = fb / np.maximum(disp, 1e-6)

    # edge dropout: strong local depth gradient -> invalid
    gy = np.abs(np.diff(z, axis=0, prepend=z[:1]))
    gx = np.abs(np.diff(z, axis=1, prepend=z[:, :1]))
    edge = (np.maximum(gx, gy) > dropout_grad)
    # dilate the edge band one pixel (occlusion shadow)
    edge = (edge
            | np.roll(edge, 1, 0) | np.roll(edge, -1, 0)
            | np.roll(edge, 1, 1) | np.roll(edge, -1, 1))
    drop = edge | (rng.random(z.shape) < salt_dropout)
    out = np.where(valid & ~drop, z_q, np.nan).astype(np.float32)
    return out


def _rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _rot_x(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def make_trajectory(n_frames: int, translation_step: float = 0.008,
                    rotation_step: float = 0.004) -> List[np.ndarray]:
    """Smooth handheld-like camera-to-world trajectory starting at identity.

    Small per-frame motion (<= ~1 cm / ~0.25 deg) keeps projective ICP in
    its convergence basin, like the real sensor sequences the reference
    replays.
    """
    poses = []
    for i in range(n_frames):
        pose = np.eye(4, dtype=np.float32)
        ang = rotation_step * i
        pose[:3, :3] = _rot_y(ang * np.cos(0.15 * i)) @ _rot_x(0.5 * ang)
        pose[0, 3] = translation_step * i
        pose[1, 3] = 0.3 * translation_step * np.sin(0.2 * i) * i
        pose[2, 3] = -0.2 * translation_step * i
        poses.append(pose)
    return poses


def clutter_scene() -> Scene:
    """Occlusion-heavy stress scene: boxes in front of spheres in front of
    wall+floor, with strong depth discontinuities from every view."""
    return Scene(
        wall_z=2.6,
        floor_y=0.9,
        spheres=(
            Sphere(center=(0.0, 0.25, 2.0), radius=0.3),
            Sphere(center=(-0.55, -0.15, 2.2), radius=0.25,
                   color=(0.2, 0.5, 0.8)),
            Sphere(center=(0.65, 0.0, 1.9), radius=0.2,
                   color=(0.3, 0.7, 0.3)),
        ),
        boxes=(
            Box(lo=(-0.15, -0.05, 1.15), hi=(0.2, 0.45, 1.45)),
            Box(lo=(-0.75, 0.3, 1.5), hi=(-0.35, 0.75, 1.85),
                color=(0.4, 0.3, 0.6)),
            Box(lo=(0.35, -0.5, 1.6), hi=(0.75, -0.15, 2.0),
                color=(0.25, 0.55, 0.55)),
            Box(lo=(-0.3, 0.6, 2.0), hi=(0.5, 0.9, 2.5),
                color=(0.6, 0.55, 0.3)),
        ),
    )


def sphere_cluster_scene() -> Scene:
    """Five spheres before wall+floor: keeps the 6-DoF ICP system
    well-conditioned over the whole trajectory (a bare wall degenerates
    the yaw/translation nullspace exactly as it would for the reference
    tracker). The benchmark's scene."""
    return Scene(spheres=(
        Sphere(center=(0.0, 0.2, 1.8), radius=0.3),
        Sphere(center=(-0.5, -0.2, 2.0), radius=0.25, color=(0.2, 0.5, 0.8)),
        Sphere(center=(0.6, 0.1, 1.5), radius=0.2, color=(0.3, 0.7, 0.3)),
        Sphere(center=(0.3, -0.4, 2.2), radius=0.28, color=(0.7, 0.7, 0.2)),
        Sphere(center=(-0.3, 0.45, 1.4), radius=0.18, color=(0.6, 0.3, 0.7)),
    ))


def wall_only_scene(z: float = 2.0) -> Scene:
    """Textureless-wall degeneracy scene: a single fronto-parallel plane.
    Point-to-plane ICP on it constrains only (z, pitch, yaw); the 6x6
    system's condition number must trip the tracking-lost gate."""
    return Scene(wall_z=z, floor_y=None, spheres=(), boxes=())


def make_sequence(n_frames: int, cam: CameraConfig,
                  scene: Optional[Scene] = None,
                  noise_sigma: float = 0.0):
    """Render a full synthetic sequence.

    Returns (depths [n,h,w], colors [n,h,w,3], poses list of 4x4).
    """
    scene = scene or Scene()
    poses = make_trajectory(n_frames)
    depths, colors = [], []
    for i, pose in enumerate(poses):
        d, c = render_depth(pose, cam, scene, noise_sigma=noise_sigma, seed=i)
        depths.append(d)
        colors.append(c)
    return np.stack(depths), np.stack(colors), poses
