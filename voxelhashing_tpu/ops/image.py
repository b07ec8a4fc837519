"""Image-space preprocessing ops (the CameraUtil.cu equivalents).

JAX re-derivations of the ~30 CUDA image kernels in
/root/reference/DepthSensingCUDA/Source/CameraUtil.cu used by the input
pipeline (CUDARGBDSensor.cpp:147-256): bilateral/gauss depth filtering,
intensity conversion, camera-space position maps, normal maps, and
2x pyramid resampling. All ops are static-shape, jit-safe, and expressed as
stacked shifted views (XLA fuses them into a single VPU pass) rather than
scalar loops.

Invalid pixels are NaN (the reference uses MINF).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from ..config import CameraConfig, FilterConfig
from .. import geometry as geom


def _shifted(img, dy: int, dx: int):
    """img shifted by (dy,dx) with NaN padding; shape-preserving."""
    pad_y = (max(dy, 0), max(-dy, 0))
    pad_x = (max(dx, 0), max(-dx, 0))
    padding = (pad_y, pad_x) + ((0, 0),) * (img.ndim - 2)
    p = jnp.pad(img, padding, constant_values=jnp.nan)
    h, w = img.shape[:2]
    return p[pad_y[1]:pad_y[1] + h, pad_x[1]:pad_x[1] + w]


def bilateral_filter_depth(depth, sigma_d: float, sigma_r: float):
    """Edge-preserving depth smoothing.

    bilateralFilterFloatMapDevice (CameraUtil.cu:446-484): window radius
    ceil(2*sigma_d), weight = gaussD(sigma_d, dx, dy) * gaussR(sigma_r,
    d - d_center); invalid neighbours skipped; centre must be valid.
    """
    radius = int(math.ceil(2.0 * sigma_d))
    valid_c = jnp.isfinite(depth)
    acc = jnp.zeros_like(depth)
    wsum = jnp.zeros_like(depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = _shifted(depth, dy, dx)
            ok = jnp.isfinite(nb)
            diff = jnp.where(ok, nb - depth, 0.0)
            w = math.exp(-(dx * dx + dy * dy) / (2.0 * sigma_d * sigma_d)) \
                * jnp.exp(-(diff * diff) / (2.0 * sigma_r * sigma_r))
            w = jnp.where(ok, w, 0.0)
            acc += w * jnp.where(ok, nb, 0.0)
            wsum += w
    out = jnp.where((wsum > 0.0) & valid_c, acc / jnp.maximum(wsum, 1e-20),
                    jnp.nan)
    return out


def gauss_filter_depth(depth, sigma_d: float, sigma_r: float):
    """Gaussian depth smoothing with range gate |d-dc| < sigma_r
    (gaussFilterFloatMapDevice, CameraUtil.cu:555-600)."""
    radius = int(math.ceil(2.0 * sigma_d))
    valid_c = jnp.isfinite(depth)
    acc = jnp.zeros_like(depth)
    wsum = jnp.zeros_like(depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = _shifted(depth, dy, dx)
            ok = jnp.isfinite(nb) & (jnp.abs(nb - depth) < sigma_r)
            w = jnp.where(
                ok, math.exp(-(dx * dx + dy * dy) / (2.0 * sigma_d * sigma_d)),
                0.0)
            acc += w * jnp.where(ok, nb, 0.0)
            wsum += w
    return jnp.where((wsum > 0.0) & valid_c, acc / jnp.maximum(wsum, 1e-20),
                     jnp.nan)


def color_to_intensity(color):
    """RGB [h,w,3] (0..1) -> luma intensity [h,w]
    (convertColorToIntensityFloat, standard BT.601 weights)."""
    return (0.299 * color[..., 0] + 0.587 * color[..., 1]
            + 0.114 * color[..., 2])


def resample_half(img):
    """2x downsample by even-pixel decimation for pyramid levels.

    The tracker's resampleFloat4Map with out = in/2 evaluates the bilinear
    interpolator exactly at even source pixels (scale = (w-1)/(w/2-1) applied
    at integer x maps within half a pixel of 2x; the reference's
    nearest-valid bilinear then degenerates to a near-point sample). We use
    strict even-pixel decimation: identical validity semantics, deterministic.
    """
    return img[::2, ::2]


def erode_depth(depth, radius: int = 2, thresh: float = 0.1,
                frac_req: float = 0.5):
    """Invalidate depth pixels whose neighbourhood disagrees
    (erodeDepthMapDevice: a pixel dies if more than ``frac_req`` of its
    window differs by > thresh or is invalid)."""
    count_bad = jnp.zeros_like(depth)
    count_all = 0.0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = _shifted(depth, dy, dx)
            bad = ~jnp.isfinite(nb) | (jnp.abs(nb - depth) > thresh)
            count_bad += bad.astype(depth.dtype)
            count_all += 1.0
    keep = count_bad < frac_req * count_all
    return jnp.where(keep & jnp.isfinite(depth), depth, jnp.nan)


def fill_holes_pullpush(depth, levels: int = 5, smooth_iters: int = 2):
    """Pull-push pyramid depth inpainting + Laplace smoothing of the
    filled-in pixels (CUDAHoleFiller.cu's pull/push kernels + smoothing;
    unused in the reference main loop but part of its component set).

    pull: average valid pixels into a coarser level per 2x2 cell;
    push: fill invalid fine pixels from the coarser level; finally a few
    Jacobi-Laplace iterations smooth ONLY the synthesized pixels.
    """
    orig = depth
    orig_valid = jnp.isfinite(depth)

    # pad to a multiple of 2^levels so 2x2 pooling stays exact
    m = 1 << levels
    h, w = depth.shape
    ph = (-h) % m
    pw = (-w) % m
    d = jnp.pad(depth, ((0, ph), (0, pw)), constant_values=jnp.nan)

    pyr = [d]
    for _ in range(levels):
        cur = pyr[-1]
        v = jnp.isfinite(cur)
        vals = jnp.where(v, cur, 0.0)
        s = (vals[0::2, 0::2] + vals[0::2, 1::2]
             + vals[1::2, 0::2] + vals[1::2, 1::2])
        c = (v[0::2, 0::2].astype(jnp.float32) + v[0::2, 1::2]
             + v[1::2, 0::2] + v[1::2, 1::2])
        pyr.append(jnp.where(c > 0, s / jnp.maximum(c, 1.0), jnp.nan))

    filled = pyr[-1]
    for lvl in range(levels - 1, -1, -1):
        fine = pyr[lvl]
        up = jnp.repeat(jnp.repeat(filled, 2, axis=0), 2, axis=1)
        filled = jnp.where(jnp.isfinite(fine), fine, up)

    filled = filled[:h, :w]
    synth = ~orig_valid & jnp.isfinite(filled)
    out = jnp.where(orig_valid, orig, filled)

    # Laplace smoothing restricted to synthesized pixels
    for _ in range(smooth_iters):
        p = jnp.pad(out, 1, mode="edge")
        lap = 0.25 * (p[:-2, 1:-1] + p[2:, 1:-1]
                      + p[1:-1, :-2] + p[1:-1, 2:])
        out = jnp.where(synth & jnp.isfinite(lap), lap, out)
    return out


def depth_to_hsv(depth, d_min: float, d_max: float):
    """Depth visualisation (convertDepthToHSV equivalent): map depth in
    [d_min,d_max] to HSV hue ramp, invalid -> black. Returns RGB [h,w,3]."""
    t = jnp.clip((depth - d_min) / (d_max - d_min), 0.0, 1.0)
    h = (1.0 - t) * 240.0 / 60.0  # blue (far=0? reference: near=blue ramp)
    i = jnp.floor(h)
    f = h - i
    p, q = jnp.zeros_like(f), 1.0 - f
    vals = jnp.stack([
        jnp.stack([jnp.ones_like(f), f, p], -1),
        jnp.stack([q, jnp.ones_like(f), p], -1),
        jnp.stack([p, jnp.ones_like(f), f], -1),
        jnp.stack([p, q, jnp.ones_like(f)], -1),
        jnp.stack([f, p, jnp.ones_like(f)], -1),
    ])
    idx = jnp.clip(i.astype(jnp.int32), 0, 4)
    rgb = jnp.take_along_axis(
        vals, idx[None, ..., None], axis=0)[0]
    return jnp.where(jnp.isfinite(depth)[..., None], rgb, 0.0)


class FrameInputs:
    """Preprocessed per-frame GPU inputs (CUDARGBDSensor outputs).

    Attributes mirror what the reference hands to tracking/integration:
    filtered depth, camera-space position map, normal map, color, intensity.
    """

    __slots__ = ("depth", "points", "normals", "color", "intensity")

    def __init__(self, depth, points, normals, color, intensity):
        self.depth = depth
        self.points = points
        self.normals = normals
        self.color = color
        self.intensity = intensity

    def tree_flatten(self):
        return ((self.depth, self.points, self.normals, self.color,
                 self.intensity), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


jax.tree_util.register_pytree_node(
    FrameInputs, FrameInputs.tree_flatten, FrameInputs.tree_unflatten)


def preprocess(depth_raw, color_raw, cam: CameraConfig, flt: FilterConfig
               ) -> FrameInputs:
    """Full input preprocessing (CUDARGBDSensor::process,
    CUDARGBDSensor.cpp:147-256): optional bilateral depth filter, optional
    color filter, intensity, camera-space position map, input normal map.

    depth_raw: [h,w] float32 metres, NaN/<=0 invalid.
    color_raw: [h,w,3] float32 in [0,1], or None.
    """
    depth = jnp.where(
        jnp.isfinite(depth_raw)
        & (depth_raw >= cam.depth_min) & (depth_raw <= cam.depth_max),
        depth_raw, jnp.nan)
    if flt.depth_filter:
        depth = bilateral_filter_depth(depth, flt.depth_sigma_d,
                                       flt.depth_sigma_r)
    color = color_raw
    intensity = None
    if color_raw is not None:
        if flt.color_filter:
            color = jnp.stack(
                [gauss_filter_depth(color_raw[..., i], flt.color_sigma_d,
                                    flt.color_sigma_r)
                 for i in range(3)], axis=-1)
        intensity = color_to_intensity(color)
    points = geom.depth_to_points(depth, cam)
    normals = geom.normals_from_points(points)
    return FrameInputs(depth=depth, points=points, normals=normals,
                       color=color, intensity=intensity)


def remap_depth_to_color(depth, depth_intr, color_intr, color_width: int,
                         color_height: int, depth_extr=None, color_extr=None,
                         disc_offset: float = 0.03, disc_lin: float = 0.02):
    """Depth -> color-camera-space remapping (host-side numpy, IO path).

    The reference's camera-calibration path rasterizes the depth map as a
    mesh into the color camera's viewpoint and continues the whole
    pipeline in color space (``RenderDepthMap``,
    /root/reference/DepthSensingCUDA/Source/CUDARGBDSensor.cpp:200-217,
    with ``s_remappingDepthDiscontinuityThresOffset/Lin`` killing
    stretched triangles at depth edges). Device-side rasterization is not
    worth a kernel for an IO-path fixup, so this re-derivation:

    * drops depth pixels whose 3x3 neighborhood spread exceeds
      ``disc_offset + disc_lin * z`` (the same discontinuity rule, applied
      per-source-pixel instead of per-triangle),
    * unprojects with the depth intrinsics, transforms by
      ``inv(color_extr) @ depth_extr``, projects with the color
      intrinsics,
    * z-buffer scatters into the color grid with a 3x3 footprint (covers
      the sampling-density gap a triangle raster would fill).

    Returns f32[color_height, color_width] metres, NaN where nothing maps.
    Downstream, an unmapped pixel behaves exactly like the reference's
    MINF: integrate requires BOTH depth and color valid
    (CUDASceneRepHashSDF.cu:443; integrate.integrate's update mask).
    """
    import numpy as np

    d = np.asarray(depth, np.float32)
    h, w = d.shape
    valid = np.isfinite(d) & (d > 0.0)

    # discontinuity filter: 3x3 min/max spread
    dpad = np.pad(np.where(valid, d, np.nan), 1, constant_values=np.nan)
    win = np.lib.stride_tricks.sliding_window_view(dpad, (3, 3))
    with np.errstate(invalid="ignore"):
        spread = np.nanmax(win, axis=(2, 3)) - np.nanmin(win, axis=(2, 3))
    keep = valid & (spread <= disc_offset + disc_lin * np.where(valid, d, 0))

    fx_d, fy_d = depth_intr[0, 0], depth_intr[1, 1]
    cx_d, cy_d = depth_intr[0, 2], depth_intr[1, 2]
    u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    z = np.where(keep, d, np.nan)
    x = (u - cx_d) / fx_d * z
    y = (v - cy_d) / fy_d * z

    t = np.eye(4, dtype=np.float64)
    if depth_extr is not None:
        t = t @ np.asarray(depth_extr, np.float64)
    if color_extr is not None:
        t = np.linalg.inv(np.asarray(color_extr, np.float64)) @ t
    pts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=0)
    q = t[:3, :3] @ pts + t[:3, 3:4]
    qz = q[2]
    ok = np.isfinite(qz) & (qz > 1e-6)
    qz_s = np.where(ok, qz, 1.0)
    uc = np.floor(color_intr[0, 0] * q[0] / qz_s + color_intr[0, 2]
                  + 0.5).astype(np.int64)
    vc = np.floor(color_intr[1, 1] * q[1] / qz_s + color_intr[1, 2]
                  + 0.5).astype(np.int64)

    out = np.full((color_height + 2, color_width + 2), np.inf, np.float32)
    for dv in (-1, 0, 1):
        for du in (-1, 0, 1):
            ui = uc + 1 + du
            vi = vc + 1 + dv
            m = ok & (ui >= 0) & (ui < color_width + 2) \
                & (vi >= 0) & (vi < color_height + 2)
            np.minimum.at(out, (vi[m], ui[m]), qz[m].astype(np.float32))
    res = out[1:-1, 1:-1]
    return np.where(np.isfinite(res), res, np.nan)
