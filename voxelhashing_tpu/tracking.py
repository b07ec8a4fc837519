"""Frame-to-model camera tracking: multi-resolution projective ICP.

JAX re-derivation of ``CUDACameraTrackingMultiRes`` (reference
DepthSensingCUDA/Source/CUDACameraTrackingMultiRes.cpp:252-348) and its
kernels:

* Projective correspondence search (``projectiveCorrespondencesKernel``,
  CUDAImageHelper.cu:70-125) as one fused gather + mask pass per iteration.
* Point-to-plane normal equations: instead of the reference's shared-memory
  tree reduction into 30 floats per CUDA block followed by a **CPU** sum and
  an Eigen SVD solve (CUDABuildLinearSystem.cu:92-181,
  CUDABuildLinearSystem.cpp:45-92, CUDACameraTrackingMultiRes.cpp:232-233),
  the whole system is reduced with one XLA reduction and solved on device
  with a 6x6 SVD — the per-iteration device->host sync is gone; only the
  final pose ever leaves the chip.
* Coarse-to-fine over a decimation pyramid with per-level iteration budgets
  and residual early-out (GlobalCameraTrackingState defaults,
  zParametersTrackingDefault.txt:1-37); iteration counts are static so the
  whole tracker jits as straight-line code with `done` masking.
* Tracking-lost detection mirrors the reference's three levels: per-step
  pose-delta thresholds (checkRigidTransformation,
  CUDACameraTrackingMultiRes.cpp:183-192), system degeneracy / condition
  number (:228-237), and the -inf-matrix "lost" sentinel becomes a boolean
  in :class:`TrackingResult`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .config import CameraConfig, TrackerConfig
from . import geometry as geom
from .ops.image import resample_half

# Every device-side f32 product here is pinned to full f32: at default
# precision a GPU may run it in TF32 (10 mantissa bits).
_HI = lax.Precision.HIGHEST


class TrackingResult(NamedTuple):
    pose: jax.Array        # f32[4,4] new camera-to-world estimate
    valid: jax.Array       # bool[]   False = tracking lost (keep last pose)
    residual: jax.Array    # f32[]    mean point-to-plane residual (finest lvl)
    corr_count: jax.Array  # i32[]    correspondences at the finest level
    condition: jax.Array   # f32[]    condition number of the last 6x6 system
    # Per-level solve records (LinearSystemConfidence, ICPErrorLog.h:16-58):
    # [levels, 4] = (mean_residual, condition, corr_count, sum_weight) at
    # each level's last executed iteration; row 0 = finest.
    level_stats: jax.Array
    # Residual-vs-iteration curves (ConvergenceAnalysis.h): [levels,
    # max_iters] mean residual per (level, outer*inner iteration),
    # NaN-padded past each level's budget; row 0 = finest.
    iter_residuals: jax.Array
    # f32[] planarity probe I2 ~ lam2/lam1 of the valid finest-level
    # input normals' scatter (report-only twin of the _planarity gate;
    # 0.0 when the gate is disabled / GT modes) — bare wall <= ~1e-3,
    # trackable scenes >= ~2e-2 (scripts/measure_planarity.py)
    planarity: jax.Array = 0.0


def stats_shapes(cfg: TrackerConfig):
    """Static shapes of TrackingResult.level_stats / .iter_residuals."""
    max_iters = max(o * i for o, i in
                    zip(cfg.max_outer_iter, cfg.max_inner_iter))
    return (cfg.levels, 4), (cfg.levels, max_iters)


def empty_stats(cfg: TrackerConfig):
    """Zero/NaN-filled diagnostic arrays (frame 0 / GT-trajectory mode)."""
    s_shape, c_shape = stats_shapes(cfg)
    return jnp.zeros(s_shape, jnp.float32), jnp.full(c_shape, jnp.nan,
                                                     jnp.float32)


def _level_camera(cam: CameraConfig, level: int) -> CameraConfig:
    """Intrinsics for pyramid level built by even-pixel decimation:
    u_l = u/2^l exactly at kept pixels => fx,cx scale by 1/2^l."""
    s = 1 << level
    return dataclasses.replace(
        cam, width=cam.width // s, height=cam.height // s,
        fx=cam.fx / s, fy=cam.fy / s, cx=cam.cx / s, cy=cam.cy / s)


def build_pyramid(points, normals, levels: int):
    """Decimation pyramid of (points, normals), level 0 = finest.

    The reference resamples both maps then renormalises the normals
    (CUDACameraTrackingMultiRes.cpp:271-278); decimation keeps the exact
    camera model of :func:`_level_camera`.
    """
    pyr = [(points, normals)]
    for _ in range(1, levels):
        points = resample_half(points)
        normals = resample_half(normals)
        pyr.append((points, normals))
    return pyr


def _soa(m):
    """[h,w,3] map -> flat per-component ([P],[P],[P]) SoA views.

    Every hot op in the tracker runs on flat [P] arrays: the
    per-iteration transform/reject/linearise chain is ~40 elementwise ops
    over contiguous components instead of a [...,3]-minor layout.
    """
    f = m.reshape(-1)
    return f[0::3], f[1::3], f[2::3]


def _interleave_target(tgt_pts, tgt_nrm):
    """[h,w,3] model maps -> one [P,8] interleaved row table
    (qx,qy,qz,nqx,nqy,nqz,0,0): one 8-wide row gather per pixel fetches
    point and normal together instead of six scalar gathers."""
    p = tgt_pts.reshape(-1, 3)
    n = tgt_nrm.reshape(-1, 3)
    return jnp.concatenate(
        [p, n, jnp.zeros((p.shape[0], 2), p.dtype)], axis=1)


def _associate(delta, in_soa, tgt8,
               cam: CameraConfig, dist_thres: float, normal_thres: float,
               depth_min: float, depth_max: float):
    """Projective correspondence search at the current delta.

    The reference's projectiveCorrespondencesKernel
    (CUDAImageHelper.cu:70-125): transform, project, 1x1 lookup, reject by
    distance and normal agreement, store the confidence weight.
    ``in_soa`` = (px,py,pz,nx,ny,nz) flat input SoA; ``tgt8`` is the
    [P,8] interleaved model table from :func:`_interleave_target`. Returns
    (q, nq, wgt, ok) SoA — fixed inputs for the inner Gauss-Newton
    iterations.
    """
    ipx, ipy, ipz, inx, iny, inz = in_soa
    r, t = delta[:3, :3], delta[:3, 3]
    px = r[0, 0] * ipx + r[0, 1] * ipy + r[0, 2] * ipz + t[0]
    py = r[1, 0] * ipx + r[1, 1] * ipy + r[1, 2] * ipz + t[1]
    pz = r[2, 0] * ipx + r[2, 1] * ipy + r[2, 2] * ipz + t[2]
    nx = r[0, 0] * inx + r[0, 1] * iny + r[0, 2] * inz
    ny = r[1, 0] * inx + r[1, 1] * iny + r[1, 2] * inz
    nz = r[2, 0] * inx + r[2, 1] * iny + r[2, 2] * inz

    safe_z = jnp.where(pz == 0.0, 1e-12, pz)
    uf = px * cam.fx / safe_z + cam.cx
    vf = py * cam.fy / safe_z + cam.cy
    ui = jnp.floor(uf + 0.5).astype(jnp.int32)
    vi = jnp.floor(vf + 0.5).astype(jnp.int32)
    on = ((ui >= 0) & (ui < cam.width) & (vi >= 0) & (vi < cam.height)
          & (pz > 0.0))
    lin = jnp.where(on, vi * cam.width + ui, 0)

    g8 = jnp.transpose(tgt8[lin], (1, 0))          # one row gather -> [8,P]
    qx, qy, qz = g8[0], g8[1], g8[2]
    nqx, nqy, nqz = g8[3], g8[4], g8[5]

    dx, dy, dz = px - qx, py - qy, pz - qz
    dist2 = dx * dx + dy * dy + dz * dz
    ndot = nx * nqx + ny * nqy + nz * nqz
    fin = (jnp.isfinite(px) & jnp.isfinite(py) & jnp.isfinite(pz)
           & jnp.isfinite(nx) & jnp.isfinite(ny) & jnp.isfinite(nz)
           & jnp.isfinite(qx) & jnp.isfinite(qy) & jnp.isfinite(qz)
           & jnp.isfinite(nqx) & jnp.isfinite(nqy) & jnp.isfinite(nqz))
    ok = (on & fin & (dist2 <= dist_thres * dist_thres)
          & (ndot >= normal_thres))

    # Confidence weight (CUDAImageHelper.cu:117): distance + depth falloff.
    dist = jnp.sqrt(dist2)
    depth01 = jnp.clip((pz - depth_min) / (depth_max - depth_min), 0.0, 1.0)
    wgt = 0.5 * ((1.0 - dist / dist_thres) + (1.0 - depth01))
    wgt = jnp.where(ok, jnp.maximum(wgt, 0.0), 0.0)
    zero = jnp.zeros_like(qx)
    q = (jnp.where(ok, qx, zero), jnp.where(ok, qy, zero),
         jnp.where(ok, qz, zero))
    nq = (jnp.where(ok, nqx, zero), jnp.where(ok, nqy, zero),
          jnp.where(ok, nqz, zero))
    return q, nq, wgt, ok


def _whitening(q, ok, reduce_sys):
    """Centroid + scale of the valid correspondence targets.

    The reference's computeBestRigidAlignment is built to solve in a
    centered/scaled frame and de-whiten as ``meanStDev*t + mean - R*mean``
    (CUDACameraTrackingMultiRes.cpp:205-207, delinearize :194-211), but its
    kernel hardcodes mean=0, stddev=1 (CUDABuildLinearSystem.cu:154-155) —
    the machinery is vestigial there. Here it is implemented for real:
    centering removes the |p|-scale imbalance between the rotation and
    translation blocks of JtJ, so the condition number actually measures
    geometric degeneracy (a bare wall) rather than coordinate units.
    ``reduce_sys`` makes the moments global across a device mesh.
    """
    qx, qy, qz = q
    okf = ok.astype(jnp.float32)
    sum_q = jnp.stack([jnp.sum(qx * okf), jnp.sum(qy * okf),
                       jnp.sum(qz * okf)])
    sum_qq = jnp.sum((qx * qx + qy * qy + qz * qz) * okf)
    cnt = jnp.sum(okf)
    sum_q, sum_qq, cnt = reduce_sys((sum_q, sum_qq, cnt))
    n = jnp.maximum(cnt, 1.0)
    mean = sum_q / n
    var = jnp.maximum(sum_qq / n - jnp.sum(mean * mean), 1e-8)
    inv_std = jax.lax.rsqrt(var)
    return mean, inv_std


def _planarity(in_soa, wgt, thres: float, reduce_sys):
    """Planar-degeneracy probe on the accepted INPUT normals.

    A bare wall leaves 3 DoF unconstrained, but only the reference-faithful
    march renderer exposes it through the 6x6 condition number (exactly
    planar model normals -> true rank-3); the production splat renderer's
    O(view-delta) surface roughness weakly fakes the missing constraints
    (cond ~1.5e3 vs the 2e4 gate, BASELINE.md). The INPUT normals are
    renderer-independent: on a wall the weighted scatter S = sum w n n^T
    is rank-1. Degeneracy measure: with S normalised to unit trace, the
    second symmetric invariant I2 = (1 - tr(S^2))/2 ~ lam2/lam1 for
    lam2,lam3 << lam1 — closed form, no eigendecomposition. Matches the
    reference's conditionThres intent (CUDACameraTrackingMultiRes.cpp:
    228-237) for the case its own gate covers only in march mode.
    Rotating the normals by delta leaves eigenvalues unchanged, so the raw
    (untransformed) input normals suffice.
    """
    zero = jnp.float32(0.0)
    use = wgt > 0.0
    # where(), not mask-multiply: rejected rows carry NaN normals
    nr = jnp.stack([jnp.where(use, in_soa[3], zero),
                    jnp.where(use, in_soa[4], zero),
                    jnp.where(use, in_soa[5], zero)], axis=0)   # [3,P]
    s = lax.dot_general(nr * wgt[None, :], nr, (((1,), (1,)), ((), ())),
                        precision=_HI,
                        preferred_element_type=jnp.float32)     # [3,3]
    (s,) = reduce_sys((s,))
    tr = s[0, 0] + s[1, 1] + s[2, 2]
    sh = s / jnp.maximum(tr, 1e-12)
    i2 = 0.5 * (1.0 - jnp.sum(sh * sh.T))
    return (i2 < thres) & (tr > 0.0), i2


def _linearize(delta, in_soa, q, nq, wgt, ok, mean, inv_std,
               precision=_HI):
    """Point-to-plane normal equations about the current delta against
    FIXED correspondences (the applyBL re-build inside the inner loop,
    CUDABuildLinearSystem.cu:71-114 / CUDACameraTrackingMultiRes.cpp:217-246),
    built in the whitened frame p' -> (p' - mean) * inv_std.

    Returns (A[6,6], b[6], sum_res, sum_w, count).

    Linearisation: residual e = n_q . (pc - qc) with pc = white(delta(p));
    about identity pc' = pc + w x pc + t, so the Jacobian row is
    j = [pc x n_q | n_q] and the rhs accumulates -j * e.  The reduction is
    phrased as J_w [8,P] @ J^T [P,8] with P on the minor axis (the
    reference's shared-memory tree reduction, CUDABuildLinearSystem.cu:
    92-181, became one matmul). ``precision`` defaults to full f32
    (``_HI``).
    """
    ipx, ipy, ipz = in_soa[0], in_soa[1], in_soa[2]
    r, t = delta[:3, :3], delta[:3, 3]
    px = r[0, 0] * ipx + r[0, 1] * ipy + r[0, 2] * ipz + t[0]
    py = r[1, 0] * ipx + r[1, 1] * ipy + r[1, 2] * ipz + t[1]
    pz = r[2, 0] * ipx + r[2, 1] * ipy + r[2, 2] * ipz + t[2]
    # Rejected rows must be zeroed with where(), NOT by multiplying with
    # the 0/1 mask: invalid input pixels carry NaN positions and
    # IEEE NaN*0 = NaN. (XLA's simplifier happens to fold the masked
    # product under jit, which hid this in compiled runs — eager/
    # interpret paths and other backends get an all-NaN system.)
    zero = jnp.float32(0.0)
    pcx = jnp.where(ok, (px - mean[0]) * inv_std, zero)
    pcy = jnp.where(ok, (py - mean[1]) * inv_std, zero)
    pcz = jnp.where(ok, (pz - mean[2]) * inv_std, zero)
    qx, qy, qz = q
    okf = ok.astype(jnp.float32)
    qcx = (qx - mean[0]) * inv_std * okf
    qcy = (qy - mean[1]) * inv_std * okf
    qcz = (qz - mean[2]) * inv_std * okf
    nqx, nqy, nqz = nq
    e = nqx * (pcx - qcx) + nqy * (pcy - qcy) + nqz * (pcz - qcz)
    e = jnp.where(ok, e, 0.0)
    # Jacobian row about identity: e ~ e0 + (pc x n).w + n.t.  The solve's x
    # is delinearised as Euler ZYX (pose_from_x), whose small-angle rotation
    # vector is (gamma, beta, alpha) = (w_x, w_y, w_z) with x = (alpha, beta,
    # gamma, t): so the rotation block is REVERSED: (w_z, w_y, w_x).
    crx = pcy * nqz - pcz * nqy
    cry = pcz * nqx - pcx * nqz
    crz = pcx * nqy - pcy * nqx
    jrows = jnp.stack([crz, cry, crx, nqx, nqy, nqz,
                       e, jnp.ones_like(e)], axis=0)       # [8,P]
    jw = jrows * wgt[None, :]
    # One [8,P]@[P,8] contraction yields A (rows 0-5), b (row 6), sum_res
    # (m[6,6] = sum w e^2) and sum_w (m[7,7] = sum w * 1 * 1) together.
    m = lax.dot_general(jw, jrows, (((1,), (1,)), ((), ())),
                        precision=precision,
                        preferred_element_type=jnp.float32)   # [8,8]
    a = m[:6, :6]
    b = -m[6, :6]
    sum_res = m[6, 6]
    sum_w = m[7, 7]
    count = jnp.sum(ok.astype(jnp.int32))
    return a, b, sum_res, sum_w, count


def _pose_from_x_whitened(x, mean, inv_std):
    """De-whiten the solved update: R unchanged, translation
    ``t = x_t/inv_std + mean - R.mean`` (delinearizeTransformation,
    CUDACameraTrackingMultiRes.cpp:194-211 with meanStDev*t+mean-R*mean)."""
    r = geom.euler_zyx_to_matrix(x[:3])
    t = x[3:6] / inv_std + mean - jnp.matmul(r, mean, precision=_HI)
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[:3, :3].set(r).at[:3, 3].set(t)
    return m


def _build_system(delta, in_pts, in_nrm, tgt_pts, tgt_nrm,
                  cam: CameraConfig, dist_thres: float, normal_thres: float,
                  depth_min: float, depth_max: float):
    """Associate + linearise in one pass (single-inner-iteration shape;
    unwhitened — kept for unit tests of the raw linearisation). Takes
    [...,3] maps; the hot path inside works on flat SoA."""
    in_soa = _soa(in_pts) + _soa(in_nrm)
    q, nq, wgt, ok = _associate(delta, in_soa,
                                _interleave_target(tgt_pts, tgt_nrm),
                                cam, dist_thres, normal_thres,
                                depth_min, depth_max)
    zero = jnp.zeros((3,), jnp.float32)
    return _linearize(delta, in_soa, q, nq, wgt, ok, zero, jnp.float32(1.0))


def _solve6(a, b, cond_thres: float):
    """Solve the 6x6 system with truncated SVD + condition gate, on device.

    Mirrors the Eigen JacobiSVD solve and sigma0/sigma5 condition record
    (CUDACameraTrackingMultiRes.cpp:228-237), with two robustness upgrades:
    singular directions weaker than s0/cond_thres are truncated (weakly
    constrained DoF are left unchanged instead of amplifying noise), and
    the lost gate fires only on true rank deficiency — a bare wall's 6x6
    has three ~0 singular values (cond -> 1e20+), while hard-but-trackable
    noisy scenes sit at cond ~100-1000.
    """
    u, s, vt = jnp.linalg.svd(a, full_matrices=False)
    cond = s[0] / jnp.maximum(s[5], 1e-20)
    degenerate = (s[0] <= 0.0) | (cond > cond_thres) | ~jnp.all(
        jnp.isfinite(a))
    s_min = jnp.maximum(s[0] / cond_thres, 1e-10)
    s_inv = jnp.where(s > s_min, 1.0 / s, 0.0)
    x = jnp.matmul(vt.T, s_inv * jnp.matmul(u.T, b, precision=_HI),
                   precision=_HI)
    x = jnp.where(degenerate, jnp.zeros_like(x), x)
    return x, cond, degenerate


def _check_step(x, angle_thres: float, dist_thres: float):
    """Per-step plausibility gate (checkRigidTransformation,
    CUDACameraTrackingMultiRes.cpp:183-192)."""
    r = geom.euler_zyx_to_matrix(x[:3])
    ang = geom.rotation_angle(r)
    return (ang <= angle_thres) & (jnp.linalg.norm(x[3:6]) <= dist_thres)


def _build_system_color(delta, in_pts, in_int, tgt_int, tgt_gx, tgt_gy,
                        cam: CameraConfig, dist_sigma: float,
                        mean=None, inv_std=None):
    """Photometric (intensity) rows of the joint RGB-D system.

    The reference's RGBD variant adds intensity + intensity-derivative
    residuals (CUDABuildLinearSystemRGBD.cu:78-104, jacobians from
    ICPUtil.h dehomogenize-derivative :16-28): residual
    e = I_model(pi(delta p)) - I_input(p); the jacobian row is
    a = J_pi^T grad(I); j = [(p x a) reversed | a].

    ``mean``/``inv_std``: the depth block's whitening moments. The solved
    x parametrizes rotation about ``mean`` with translation ``x_t /
    inv_std`` (see _pose_from_x_whitened), so the photometric rows must
    be built in the SAME parametrization — rotation block
    ``cross(p - mean, a)``, translation block ``a / inv_std`` — or the
    joint solve mixes two coordinate frames and systematically
    under-corrects translation.
    """
    if mean is None:
        mean = jnp.zeros((3,), jnp.float32)
    if inv_std is None:
        inv_std = jnp.float32(1.0)
    r = delta[:3, :3]
    p = jnp.matmul(in_pts, r.T, precision=_HI) + delta[:3, 3]

    # Bilinear intensity sample at the CONTINUOUS projection (the
    # reference's getValueNearestNeighbour->bilinear path in ICPUtil.h):
    # nearest-pixel sampling aliases sub-pixel motion — the photometric
    # residual then oscillates around the optimum instead of converging
    # (a 0.65 px true shift reads as 1 px, the solver over-corrects,
    # reads 0 px, under-corrects, ...). Gradients stay nearest-sampled.
    safe_pz = jnp.where(p[..., 2] == 0.0, 1e-12, p[..., 2])
    uf = p[..., 0] * cam.fx / safe_pz + cam.cx
    vf = p[..., 1] * cam.fy / safe_pz + cam.cy
    on = ((uf >= 0.0) & (uf <= cam.width - 1.0)
          & (vf >= 0.0) & (vf <= cam.height - 1.0) & (p[..., 2] > 0.0))
    uf_c = jnp.clip(uf, 0.0, cam.width - 1.0)
    vf_c = jnp.clip(vf, 0.0, cam.height - 1.0)
    u0 = jnp.clip(jnp.floor(uf_c).astype(jnp.int32), 0, cam.width - 2)
    v0 = jnp.clip(jnp.floor(vf_c).astype(jnp.int32), 0, cam.height - 2)
    fu = uf_c - u0.astype(jnp.float32)
    fv = vf_c - v0.astype(jnp.float32)
    i00 = tgt_int[v0, u0]
    i01 = tgt_int[v0, u0 + 1]
    i10 = tgt_int[v0 + 1, u0]
    i11 = tgt_int[v0 + 1, u0 + 1]
    i_t = ((1 - fv) * ((1 - fu) * i00 + fu * i01)
           + fv * ((1 - fu) * i10 + fu * i11))
    ui = jnp.clip(jnp.floor(uf_c + 0.5).astype(jnp.int32), 0, cam.width - 1)
    vi = jnp.clip(jnp.floor(vf_c + 0.5).astype(jnp.int32), 0,
                  cam.height - 1)
    gx = tgt_gx[vi, ui]
    gy = tgt_gy[vi, ui]
    e = i_t - in_int
    # all four bilinear corners must be finite for a valid sample
    fin_t = (jnp.isfinite(i00) & jnp.isfinite(i01)
             & jnp.isfinite(i10) & jnp.isfinite(i11))

    z = jnp.where(p[..., 2] == 0.0, 1e-12, p[..., 2])
    # a = J_pi^T [gx, gy]
    ax = gx * cam.fx / z
    ay = gy * cam.fy / z
    az = -(gx * cam.fx * p[..., 0] + gy * cam.fy * p[..., 1]) / (z * z)
    a = jnp.stack([ax, ay, az], axis=-1)

    ok = (on & jnp.all(jnp.isfinite(p), axis=-1) & jnp.isfinite(in_int)
          & fin_t & jnp.isfinite(gx) & jnp.isfinite(gy)
          & (jnp.abs(e) < dist_sigma))
    wgt = jnp.where(ok, 1.0 - jnp.abs(e) / dist_sigma, 0.0)

    cr = jnp.cross(p - mean, a)
    j = jnp.concatenate([cr[..., ::-1], a / inv_std], axis=-1)
    j = jnp.where(ok[..., None], j, 0.0)
    e = jnp.where(ok, e, 0.0)
    jw = j * wgt[..., None]
    a_mat = jnp.einsum("...i,...j->ij", jw, j, precision=_HI)
    b = -jnp.sum(jw * e[..., None], axis=tuple(range(e.ndim)))
    return a_mat, b, jnp.sum(wgt * e * e), jnp.sum(wgt), \
        jnp.sum(ok.astype(jnp.int32))


def intensity_gradients(intensity):
    """Central-difference image gradients (the intensity-derivative maps of
    CameraTrackingInput.h:17-27)."""
    gx = jnp.zeros_like(intensity)
    gy = jnp.zeros_like(intensity)
    gx = gx.at[:, 1:-1].set(0.5 * (intensity[:, 2:] - intensity[:, :-2]))
    gy = gy.at[1:-1, :].set(0.5 * (intensity[2:, :] - intensity[:-2, :]))
    return gx, gy


def track(input_points, input_normals, model_points, model_normals,
          last_pose, cam: CameraConfig, cfg: TrackerConfig,
          input_intensity=None, model_intensity=None,
          weight_depth: float = 1.0, weight_color: float = 0.1,
          color_sigma: float = 0.1, reduce_fn=None) -> TrackingResult:
    """Align the current frame to the raycast model; returns the new pose.

    ``input_*``: current-frame camera-space maps; ``model_*``: raycast maps
    in the last pose's camera frame. The solved delta maps current-frame
    camera space to last-frame camera space; new_pose = last_pose @ delta
    (the reference's applyCT contract, CUDACameraTrackingMultiRes.cpp:252-348).

    When both intensities are given, photometric residuals join the system
    (the RGBD variant, CUDACameraTrackingMultiResRGBD; disabled by default
    like the reference's useRGBDTracking=false, DepthSensing.cpp:816).

    ``reduce_fn``: optional reduction applied to the per-iteration system
    tuple (A, b, sum_res, sum_w, count) — the distributed step passes a
    psum over the device mesh here so the sharded tracker runs THIS loop
    (no forked copy); ``input_*`` is then the device's row shard while the
    model maps are global.
    """
    levels = cfg.levels
    reduce_sys = reduce_fn if reduce_fn is not None else (lambda t: t)
    in_pyr = build_pyramid(input_points, input_normals, levels)
    md_pyr = build_pyramid(model_points, model_normals, levels)
    use_rgbd = input_intensity is not None and model_intensity is not None
    if use_rgbd:
        ii_pyr, mi_pyr = [input_intensity], [model_intensity]
        for _ in range(1, levels):
            ii_pyr.append(resample_half(ii_pyr[-1]))
            mi_pyr.append(resample_half(mi_pyr[-1]))

    # Report-only planarity probe over the valid finest-level input
    # normals (the gate inside the loop uses correspondence weights; this
    # unconditional probe tracks it closely and gives the frame loop /
    # diagnostics an observable for WHY a frame was declared lost)
    plan_i2 = jnp.float32(0.0)
    if cfg.normal_aniso_thres > 0.0 and not use_rgbd:
        soa0 = _soa(in_pyr[0][0]) + _soa(in_pyr[0][1])
        valid0 = (jnp.isfinite(soa0[3]) & jnp.isfinite(soa0[4])
                  & jnp.isfinite(soa0[5]))
        _, plan_i2 = _planarity(soa0, valid0.astype(jnp.float32),
                                cfg.normal_aniso_thres, reduce_sys)

    delta = jnp.eye(4, dtype=jnp.float32)
    lost = jnp.array(False)
    residual = jnp.float32(0.0)
    corr = jnp.int32(0)
    condition = jnp.float32(0.0)
    _, (_, max_iters) = stats_shapes(cfg)
    level_stats = [None] * levels          # per-level confidence records
    curves = [None] * levels               # per-level residual curves

    for level in range(levels - 1, -1, -1):        # coarse -> fine
        cam_l = _level_camera(cam, level)
        in_p, in_n = in_pyr[level]
        md_p, md_n = md_pyr[level]
        in_soa = _soa(in_p) + _soa(in_n)
        md8 = _interleave_target(md_p, md_n)
        done = jnp.array(False)
        last_res = jnp.float32(jnp.inf)
        lvl_res = jnp.float32(0.0)
        lvl_cond = jnp.float32(0.0)
        lvl_corr = jnp.int32(0)
        lvl_w = jnp.float32(0.0)
        curve = []

        def outer_iter(carry):
            """One outer iteration (associate + inner GN solves)."""
            (delta, lost, residual, corr, condition,
             lvl_res, lvl_cond, lvl_corr, lvl_w, done, last_res) = carry
            cvals = []
            q, nq, wgt, ok = _associate(
                delta, in_soa, md8, cam_l,
                cfg.dist_thres[level], cfg.normal_thres[level],
                cam.depth_min, cam.depth_max)
            mean, inv_std = _whitening(q, ok, reduce_sys)
            # RGBD mode: photometric rows restore the in-plane rank a
            # textured wall loses geometrically, so the planarity gate
            # applies to the depth-only tracker only
            if cfg.normal_aniso_thres > 0.0 and not use_rgbd:
                planar, _ = _planarity(in_soa, wgt, cfg.normal_aniso_thres,
                                       reduce_sys)
            else:
                planar = jnp.array(False)
            # Inner iterations: re-linearise + solve against the fixed
            # correspondences (computeBestRigidAlignment, MultiRes.cpp:217).
            for _inner in range(cfg.max_inner_iter[level]):
                sys_d = _linearize(
                    delta, in_soa, q, nq, wgt, ok, mean, inv_std)
                if use_rgbd:
                    # The photometric rows are built over the SAME input
                    # shard as the depth rows, so they must join the
                    # system BEFORE the mesh reduction — reducing only the
                    # depth block would fold each device's local color
                    # rows into a globally-reduced depth system.
                    gx, gy = intensity_gradients(mi_pyr[level])
                    sys_c = _build_system_color(
                        delta, in_p, ii_pyr[level], mi_pyr[level], gx, gy,
                        cam_l, color_sigma, mean=mean, inv_std=inv_std)
                    (a, b, sum_res, sum_w, count,
                     a_c, b_c, res_c, w_c, _n_c) = reduce_sys(
                        tuple(sys_d) + tuple(sys_c))
                    a = weight_depth * a + weight_color * a_c
                    b = weight_depth * b + weight_color * b_c
                    sum_res = weight_depth * sum_res + weight_color * res_c
                    sum_w = weight_depth * sum_w + weight_color * w_c
                else:
                    a, b, sum_res, sum_w, count = reduce_sys(sys_d)
                mean_res = sum_res / jnp.maximum(sum_w, 1e-12)
                # Residual early-out (reference :300-335).
                done |= jnp.abs(last_res - mean_res) \
                    < cfg.residual_early_out[level]
                last_res = mean_res
                # convergence curve: residual while the level still runs
                cvals.append(jnp.where(done, jnp.nan, mean_res))

                x, cond, degen = _solve6(a, b, cfg.cond_thres)
                # Step gate in physical units: rotation angle, and motion
                # of the cloud centroid ||x_t||/inv_std in metres.
                x_phys = x.at[3:6].set(x[3:6] / inv_std)
                step_ok = _check_step(x_phys,
                                      cfg.angle_trans_thres[level],
                                      cfg.dist_trans_thres[level])
                # Degenerate or implausible at any level => tracking lost
                # (reference signals with the -inf matrix, :96, :228-246).
                bad = degen | ~step_ok | (count < 64) | planar
                lost |= bad & ~done
                use = ~done & ~bad
                delta = jnp.where(
                    use, jnp.matmul(_pose_from_x_whitened(x, mean, inv_std),
                                    delta, precision=_HI),
                    delta)
                residual = jnp.where(use | done, mean_res, residual)
                corr = jnp.where(use | done, count, corr)
                condition = jnp.where(use, cond, condition)
                lvl_res = jnp.where(use | done, mean_res, lvl_res)
                lvl_cond = jnp.where(use, cond, lvl_cond)
                lvl_corr = jnp.where(use | done, count, lvl_corr)
                lvl_w = jnp.where(use | done, sum_w, lvl_w)
                done |= bad
            return ((delta, lost, residual, corr, condition, lvl_res,
                     lvl_cond, lvl_corr, lvl_w, done, last_res),
                    jnp.stack(cvals))

        def skip_iter(carry):
            # converged/bad level: all outputs carry through unchanged
            # (identical to what the masked body would produce)
            return carry, jnp.full((cfg.max_inner_iter[level],), jnp.nan)

        carry = (delta, lost, residual, corr, condition,
                 lvl_res, lvl_cond, lvl_corr, lvl_w, done, last_res)
        for _ in range(cfg.max_outer_iter[level]):
            if reduce_fn is None:
                # single-device: skip the whole iteration once `done` —
                # the masked updates above are provably no-ops then, and
                # a converged level saves its associate+solve cost.
                carry, cvals = jax.lax.cond(carry[9], skip_iter, outer_iter,
                                            carry)
            else:
                # distributed: collectives must run on every device in
                # lockstep — keep the masked (always-execute) form
                carry, cvals = outer_iter(carry)
            curve.extend(cvals[i] for i in range(cvals.shape[0]))
        (delta, lost, residual, corr, condition, lvl_res, lvl_cond,
         lvl_corr, lvl_w, done, last_res) = carry
        level_stats[level] = jnp.stack(
            [lvl_res, lvl_cond, lvl_corr.astype(jnp.float32), lvl_w])
        curves[level] = jnp.stack(
            curve + [jnp.float32(jnp.nan)] * (max_iters - len(curve)))

    new_pose = jnp.matmul(last_pose, delta, precision=_HI)
    valid = ~lost & jnp.all(jnp.isfinite(new_pose))
    pose_out = jnp.where(valid, new_pose, last_pose)
    return TrackingResult(pose=pose_out, valid=valid, residual=residual,
                          corr_count=corr, condition=condition,
                          level_stats=jnp.stack(level_stats),
                          iter_residuals=jnp.stack(curves),
                          planarity=plan_i2)
