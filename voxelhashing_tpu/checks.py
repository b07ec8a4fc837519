"""Result checks shared by ``bench.py`` and ``chip_smoke.py``.

* :func:`integrate_reference` — a plain f32 NumPy twin of
  :func:`integrate.integrate`'s sdf/weight fusion, independent of the
  XLA code it checks.
* :func:`compare_voxels`, :func:`compare_depth`, :func:`compare_system`
  — the stage comparators (two devices, or a device and the NumPy
  reference), each with its tolerance stated where it is defined.
* :func:`check_run` — what a tracked sequence must show: every frame
  valid, an ATE bound against ground truth, clean map invariants, a map
  that grew past frame 0.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .config import CameraConfig, MapConfig, SDF_BLOCK_SIZE, VOXELS_PER_BLOCK
from .geometry import INVALID_KEY

# Projection margin (pixels) below which a voxel counts as borderline: its
# nearest-pixel rounding floor(u + 0.5) may land on either neighbour when
# two implementations round the f32 projection differently in the last
# bits (FMA contraction, operation order). f32 projections at 320 px
# agree to ~1e-4 px, so 1e-3 px is a safe margin.
PIXEL_MARGIN = 1e-3
# Same idea for the update mask's depth thresholds (metres).
DEPTH_MARGIN = 1e-5
# Share of compared voxels allowed to differ at all (every one of them must
# be borderline): a projection within PIXEL_MARGIN of a pixel edge is rare.
BORDER_SHARE = 1e-3
# Absolute sdf floor (metres): the fused sdf is a weighted average of terms
# up to 255 x 0.1 m, so an f32 last-bit difference in those terms can move
# a near-zero result by ~255 * 0.1 * 2^-23 ~ 3e-6 m, far below a voxel.
SDF_ABS_TOL = 4e-6
# Share of voxels allowed a one-step bf16 weight difference: the stored
# weight is the f32 running weight rounded to bf16, and an f32 last-bit
# difference flips that rounding with probability ~2^-16 per voxel.
ROUNDING_SHARE = 1e-3


def _bf16_ulp(x):
    """Spacing of bf16 values at magnitude ``x`` (8 significand bits)."""
    _, e = np.frexp(np.maximum(np.abs(x), np.float32(1e-30)))
    return np.ldexp(np.float32(1.0), e - 8).astype(np.float32)


def to_bf16_f32(x):
    """Round f32 values to bf16 storage and back (the pool's precision)."""
    import ml_dtypes
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32)


def integrate_reference(block_keys, old_sdf, old_w, depth, color, pose,
                        cam: CameraConfig, cfg: MapConfig):
    """f32 NumPy fusion of one frame into the pool rows keyed ``block_keys``.

    integrateDepthMapKernel (CUDASceneRepHashSDF.cu:412-492) for every
    voxel: project into the frame, nearest-sample depth, sdf = depth -
    voxel z, truncate, and fuse ``combineVoxel``'s weighted average with
    the distance-scaled sample weight. ``old_sdf``/``old_w`` are the rows
    before the frame [M,512]; ``depth`` [h,w] is NaN/<=0 where invalid;
    ``color`` [h,w,3] (only its validity gates the update, as in the
    device path). Rows with an INVALID key are left unchanged.

    Returns (sdf f32[M,512], weight f32[M,512], borderline bool[M,512]);
    ``borderline`` marks voxels whose outcome hinges on last-bit rounding
    (see PIXEL_MARGIN / DEPTH_MARGIN).
    """
    f32 = np.float32
    keys = np.asarray(block_keys, np.int64)
    valid_row = keys != INVALID_KEY
    wb, half = cfg.world_blocks, cfg.world_blocks // 2
    base = np.stack([keys % wb - half, (keys // wb) % wb - half,
                     keys // (wb * wb) - half], axis=-1) * SDF_BLOCK_SIZE
    idx = np.arange(VOXELS_PER_BLOCK)
    off = np.stack([idx % SDF_BLOCK_SIZE, (idx // SDF_BLOCK_SIZE)
                    % SDF_BLOCK_SIZE, idx // SDF_BLOCK_SIZE ** 2], axis=-1)
    vs = f32(cfg.voxel_size)
    wx = (base[:, None, 0] + off[None, :, 0]).astype(f32) * vs
    wy = (base[:, None, 1] + off[None, :, 1]).astype(f32) * vs
    wz = (base[:, None, 2] + off[None, :, 2]).astype(f32) * vs

    pose = np.asarray(pose, f32)
    r = pose[:3, :3].T                                 # view rotation
    t = -(r @ pose[:3, 3])
    px = r[0, 0] * wx + r[0, 1] * wy + r[0, 2] * wz + t[0]
    py = r[1, 0] * wx + r[1, 1] * wy + r[1, 2] * wz + t[1]
    pz = r[2, 0] * wx + r[2, 1] * wy + r[2, 2] * wz + t[2]
    safe_z = np.where(pz == 0.0, f32(1e-12), pz)
    uf = px * f32(cam.fx) / safe_z + f32(cam.cx) + f32(0.5)
    vf = py * f32(cam.fy) / safe_z + f32(cam.cy) + f32(0.5)
    # within a pixel of the image: on screen under some last-bit rounding
    near = ((uf > -1.0) & (uf < cam.width + 1.0) & (vf > -1.0)
            & (vf < cam.height + 1.0) & (pz > 0.0))
    # off-screen projections are masked below; keep their casts finite
    uf = np.clip(uf, -1.0, cam.width + 1.0)
    vf = np.clip(vf, -1.0, cam.height + 1.0)
    ui, vi = np.floor(uf), np.floor(vf)
    margin = np.minimum(np.minimum(uf - ui, ui + 1 - uf),
                        np.minimum(vf - vi, vi + 1 - vf))
    ui, vi = ui.astype(np.int64), vi.astype(np.int64)
    on_screen = ((ui >= 0) & (ui < cam.width) & (vi >= 0)
                 & (vi < cam.height) & (pz > 0.0))
    pix = np.clip(vi, 0, cam.height - 1) * cam.width \
        + np.clip(ui, 0, cam.width - 1)

    dflat = np.asarray(depth, f32).reshape(-1)
    d = dflat[pix]
    d_valid = np.isfinite(d) & (d > 0.0)
    d = np.where(d_valid, d, f32(0.0))
    col = np.asarray(color, f32).reshape(-1, 3)
    c_ok = (np.all(np.isfinite(col), axis=-1)
            & np.all(col >= 0.0, axis=-1))[pix]

    sdf = d - pz
    trunc = f32(cfg.truncation) + f32(cfg.truncation_scale) * d
    dmax = f32(cfg.max_integration_distance)
    update = (on_screen & d_valid & c_ok & (d < dmax) & (sdf > -trunc)
              & valid_row[:, None])
    sdf = np.clip(sdf, -trunc, trunc)
    depth01 = (d - f32(cam.depth_min)) / f32(cam.depth_max - cam.depth_min)
    w_new = np.maximum(f32(cfg.integration_weight_sample) * f32(1.5)
                       * (f32(1.0) - depth01), f32(1.0))
    o_sdf = np.asarray(old_sdf, f32)
    o_w = np.asarray(old_w, f32)
    w_sum = o_w + w_new
    fused_sdf = (o_sdf * o_w + sdf * w_new) / w_sum
    fused_w = np.minimum(w_sum, f32(cfg.integration_weight_max))
    out_sdf = np.where(update, fused_sdf, o_sdf)
    out_w = np.where(update, fused_w, o_w)
    # (a pixel-edge voxel may be on screen for one rounding and off it
    # for another, so `near`, not `on_screen`)
    borderline = (near & valid_row[:, None]) & (
        (margin < PIXEL_MARGIN) | (np.abs(sdf + trunc) < DEPTH_MARGIN)
        | (np.abs(d - dmax) < DEPTH_MARGIN))
    return out_sdf, out_w, borderline


def compare_voxels(sdf_a, w_a, sdf_b, w_b, borderline) -> Dict:
    """Compare two integrate results stored at bf16 (as f32 arrays).

    Tolerance (each voxel): weights equal, or one bf16 rounding step apart
    (counted; share <= ROUNDING_SHARE); sdf within two bf16 ulps (one
    storage rounding each side) or SDF_ABS_TOL. A voxel outside that is a *difference*;
    every difference must be borderline (``borderline`` from
    :func:`integrate_reference`), and differences may be at most
    BORDER_SHARE of the voxels.
    """
    sa, sb = np.asarray(sdf_a, np.float32), np.asarray(sdf_b, np.float32)
    wa, wb = np.asarray(w_a, np.float32), np.asarray(w_b, np.float32)
    s_err = np.abs(sa - sb)
    sdf_bad = s_err > np.maximum(
        2 * _bf16_ulp(np.maximum(np.abs(sa), np.abs(sb))), SDF_ABS_TOL)
    w_err = np.abs(wa - wb)
    w_step = _bf16_ulp(np.maximum(wa, wb))
    w_round = (w_err > 0) & (w_err <= w_step)
    diff = sdf_bad | (w_err > w_step)
    n = sa.size
    unexplained = diff & ~np.asarray(borderline)
    res = {
        "voxels": int(n),
        "differing": int(diff.sum()),
        "unexplained": int(unexplained.sum()),
        # up to 3 (row, voxel, sdf_a, sdf_b, w_a, w_b) for the record
        "unexplained_examples": [
            (int(i), int(j), float(sa[i, j]), float(sb[i, j]),
             float(wa[i, j]), float(wb[i, j]))
            for i, j in np.argwhere(unexplained)[:3]],
        "weight_rounding": int(w_round.sum()),
        "max_sdf_err_agreeing": float(s_err[~diff].max()) if (~diff).any()
        else 0.0,
    }
    res["ok"] = (res["unexplained"] == 0
                 and res["differing"] <= max(BORDER_SHARE * n, 8)
                 and res["weight_rounding"] <= max(ROUNDING_SHARE * n, 8))
    return res


def compare_depth(depth_a, depth_b, tol_m: float = 1e-3,
                  max_share: float = 1e-2) -> Dict:
    """Compare two rendered depth maps (NaN = no surface).

    Tolerance: the splat z-buffer is a scatter-min, which does not depend
    on the order of its writes, so a pixel can differ only where a
    surface voxel's projection rounds to a neighbouring pixel (then the
    3x3 hole fill can carry it to its neighbours). At most ``max_share``
    of the covered pixels may differ in coverage or by more than
    ``tol_m``.
    """
    a, b = np.asarray(depth_a), np.asarray(depth_b)
    fa, fb = np.isfinite(a), np.isfinite(b)
    both = fa & fb
    far = both & (np.abs(np.where(both, a - b, 0.0)) > tol_m)
    covered = int((fa | fb).sum())
    n_diff = int((fa != fb).sum() + far.sum())
    share = n_diff / max(covered, 1)
    return {"covered": covered, "differing": n_diff, "share": share,
            "ok": covered > 0 and share <= max_share}


def compare_system(sys_a: Sequence, sys_b: Sequence,
                   max_rel: float = 1e-4) -> Dict:
    """Compare two ICP linear systems (A[6,6], b[6], sum_res, sum_w, count).

    Tolerance: relative Frobenius error of (A, b, sum_res, sum_w) at most
    ``max_rel``. Both sums run over the same P products in f32, in
    another order on each device: ~sqrt(P)*2^-24 ~ 2e-5 at P = 76800.
    """
    def vec(s):
        a, b, res, w = (np.asarray(x, np.float64) for x in s[:4])
        return np.concatenate([a.ravel(), b.ravel(), [res, w]])

    va, vb = vec(sys_a), vec(sys_b)
    rel = float(np.linalg.norm(va - vb) / max(np.linalg.norm(vb), 1e-30))
    return {"rel_err": rel, "count_a": int(sys_a[4]), "count_b": int(sys_b[4]),
            "ok": rel <= max_rel and int(sys_a[4]) == int(sys_b[4])}


def check_run(est: Sequence, gt: Sequence, valid: Sequence,
              invariants: Dict, n_blocks: Sequence,
              ate_limit: float) -> Tuple[float, List[str]]:
    """(ATE without alignment, failures) of a tracked sequence."""
    from .evaluation import ate_rmse
    failures = []
    bad = [i for i, v in enumerate(valid) if not v]
    if bad:
        failures.append(f"tracking invalid at frames {bad}")
    ate = float(ate_rmse(est, gt, align=False))
    if not ate < ate_limit:
        failures.append(f"ATE {ate * 1e3:.3f} mm >= {ate_limit * 1e3:.1f} mm")
    viol = {k: v for k, v in invariants.items() if v}
    if viol:
        failures.append(f"invariant violations {viol}")
    if not n_blocks[-1] > n_blocks[0]:
        failures.append(f"map did not grow past frame 0 "
                        f"({n_blocks[0]} -> {n_blocks[-1]} blocks)")
    return ate, failures
