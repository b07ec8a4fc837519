"""Tests for DDA allocation and TSDF fusion against analytic ground truth."""

import dataclasses

import numpy as np
import jax.numpy as jnp

from voxelhashing_tpu import blockmap, geometry as geom, integrate
from voxelhashing_tpu.config import CameraConfig, MapConfig, SDF_BLOCK_SIZE
from voxelhashing_tpu.geometry import INVALID_KEY
from voxelhashing_tpu.io.synthetic import Scene, Sphere, render_depth

CAM = CameraConfig(width=80, height=60, fx=65.0, fy=65.0, cx=39.5, cy=29.5)
CFG = MapConfig(voxel_size=0.02, num_blocks=4096, table_size=16384,
                max_active_blocks=4096, world_blocks=1024)
WALL = Scene(wall_z=2.0, floor_y=None, spheres=())


def wall_depth():
    depth, color = render_depth(np.eye(4, dtype=np.float32), CAM, WALL)
    return jnp.asarray(depth), jnp.asarray(color)


class TestAllocCandidates:
    def test_candidates_cover_truncation_band(self):
        depth, _ = wall_depth()
        pose = jnp.eye(4)
        keys = integrate.alloc_candidates(depth, pose, CAM, CFG)
        keys = np.unique(np.asarray(keys))
        keys = keys[keys != int(INVALID_KEY)]
        blocks = np.asarray(geom.unpack_block_key(jnp.asarray(keys), 1024))
        # every voxel centre within the truncation band around the wall must
        # be inside some allocated block: check centre pixel column of blocks
        z_lo, z_hi = 2.0 - CFG.truncation_at(2.0), 2.0 + CFG.truncation_at(2.0)
        bs = CFG.block_size_world
        z_blocks = set(blocks[(np.abs(blocks[:, 0]) < 2)
                              & (np.abs(blocks[:, 1]) < 2)][:, 2].tolist())
        needed = set(range(int(np.floor(z_lo / bs)), int(z_hi / bs) + 1))
        assert needed <= z_blocks, (needed, z_blocks)

    def test_invalid_depth_produces_no_candidates(self):
        depth = jnp.full((CAM.height, CAM.width), jnp.nan)
        keys = integrate.alloc_candidates(depth, jnp.eye(4), CAM, CFG)
        assert np.all(np.asarray(keys) == int(INVALID_KEY))

    def test_beyond_max_integration_distance_skipped(self):
        cfg = dataclasses.replace(CFG, max_integration_distance=1.5)
        depth, _ = wall_depth()   # wall at 2.0 > 1.5
        keys = integrate.alloc_candidates(depth, jnp.eye(4), CAM, cfg)
        assert np.all(np.asarray(keys) == int(INVALID_KEY))


class TestIntegrate:
    def _fuse_wall(self, n_frames=1):
        depth, color = wall_depth()
        pose = jnp.eye(4)
        state = blockmap.create(CFG)
        state, n = integrate.allocate_from_depth(state, depth, pose, CAM, CFG)
        assert int(n) > 0
        for _ in range(n_frames):
            state = integrate.integrate(state, depth, color, pose, CAM, CFG)
        return state

    def test_tsdf_values_match_wall_distance(self):
        state = self._fuse_wall()
        # sample voxels along the central axis around z=2.0
        z = np.arange(1.95, 2.05, CFG.voxel_size)
        pts = np.stack([np.zeros_like(z), np.zeros_like(z), z], -1)
        vox = geom.world_to_voxel(jnp.asarray(pts, jnp.float32),
                                  CFG.voxel_size)
        sdf, w, _ = blockmap.gather_voxels(state, vox, CFG)
        sdf, w = np.asarray(sdf), np.asarray(w)
        assert np.all(w > 0), "band voxels must be observed"
        # true sdf = wall_z - voxel_z (positive in front of the wall);
        # projective TSDF along the optical axis equals the true distance
        true = 2.0 - np.asarray(geom.voxel_to_world(vox, CFG.voxel_size))[:, 2]
        np.testing.assert_allclose(sdf, true, atol=CFG.voxel_size * 0.75)

    def test_weights_accumulate_and_clamp(self):
        state1 = self._fuse_wall(1)
        state5 = self._fuse_wall(5)
        idx1, n1 = blockmap.compactify_all(state1, CFG)
        w1 = np.asarray(state1.weight)[np.asarray(idx1[:int(n1)])]
        w5 = np.asarray(state5.weight)[np.asarray(idx1[:int(n1)])]
        observed = w1 > 0
        assert np.all(w5[observed] >= w1[observed])
        assert np.all(w5 <= CFG.integration_weight_max)
        # one frame's sample weight: max(10*1.5*(1-d01), 1) at d=2.0
        d01 = (2.0 - CAM.depth_min) / (CAM.depth_max - CAM.depth_min)
        expected = max(10.0 * 1.5 * (1.0 - d01), 1.0)
        centre_w = w1[observed]
        # voxels on the optical axis see d≈2.0
        assert np.isclose(np.max(centre_w), expected, rtol=0.05)

    def test_color_fused(self):
        state = self._fuse_wall()
        z = np.asarray([[0.0, 0.0, 2.0]])
        vox = geom.world_to_voxel(jnp.asarray(z, jnp.float32), CFG.voxel_size)
        _, w, c = blockmap.gather_voxels(state, vox, CFG)
        assert float(w[0]) > 0
        c = np.asarray(c[0]).astype(np.float32) / 255.0
        # first fusion blends 50/50 with initial black: expect wall_color/2
        np.testing.assert_allclose(c, np.asarray(WALL.wall_color) / 2.0,
                                   atol=0.02)

    def test_bilinear_color_flag(self):
        """cfg.bilinear_color samples color with the validity-weighted
        4-tap filter (bilinearFilterColor, CUDASceneRepHashSDF.cu:379-410):
        on a constant-color wall it matches nearest; the flag is exercised
        end-to-end."""
        cfg = dataclasses.replace(CFG, bilinear_color=True)
        depth, color = wall_depth()
        pose = jnp.eye(4)
        state = blockmap.create(cfg)
        state, _ = integrate.allocate_from_depth(state, depth, pose, CAM, cfg)
        state = integrate.integrate(state, depth, color, pose, CAM, cfg)
        z = np.asarray([[0.0, 0.0, 2.0]])
        vox = geom.world_to_voxel(jnp.asarray(z, jnp.float32), cfg.voxel_size)
        _, w, c = blockmap.gather_voxels(state, vox, cfg)
        assert float(w[0]) > 0
        c = np.asarray(c[0]).astype(np.float32) / 255.0
        np.testing.assert_allclose(c, np.asarray(WALL.wall_color) / 2.0,
                                   atol=0.02)

    def test_sdf_converges_with_noise(self):
        rng_frames = 6
        state = blockmap.create(CFG)
        pose = jnp.eye(4)
        for i in range(rng_frames):
            depth, color = render_depth(np.eye(4, dtype=np.float32), CAM,
                                        WALL, noise_sigma=0.004, seed=i)
            depth, color = jnp.asarray(depth), jnp.asarray(color)
            state, _ = integrate.allocate_from_depth(state, depth, pose, CAM,
                                                     CFG)
            state = integrate.integrate(state, depth, color, pose, CAM, CFG)
        vox = geom.world_to_voxel(jnp.asarray([[0.0, 0.0, 1.96]], jnp.float32),
                                  CFG.voxel_size)
        sdf, w, _ = blockmap.gather_voxels(state, vox, CFG)
        assert abs(float(sdf[0]) - 0.04) < 0.01


class TestGarbageCollect:
    def test_starve_and_collect_removes_unsupported_blocks(self):
        state = TestIntegrate()._fuse_wall(1)
        idx, n = blockmap.compactify_all(state, CFG)
        n0 = int(n)
        mask = jnp.arange(idx.shape[0]) < n
        # starve more times than the max weight so every voxel hits 0
        for _ in range(20):
            state = integrate.starve(state, idx, mask)
        state = integrate.garbage_collect(state, idx, mask, CFG)
        assert int(blockmap.stats(state, CFG)["n_allocated"]) == 0
        viol = blockmap.check_invariants(state, CFG)
        assert all(v == 0 for v in viol.values()), viol

    def test_collect_keeps_supported_blocks(self):
        state = TestIntegrate()._fuse_wall(3)
        idx, n = blockmap.compactify_all(state, CFG)
        mask = jnp.arange(idx.shape[0]) < n
        n0 = int(blockmap.stats(state, CFG)["n_allocated"])
        state = integrate.garbage_collect(state, idx, mask, CFG)
        n1 = int(blockmap.stats(state, CFG)["n_allocated"])
        # blocks holding the wall surface survive; empty-band blocks may go
        assert 0 < n1 <= n0
        # surface voxel still present
        vox = geom.world_to_voxel(jnp.asarray([[0.0, 0.0, 2.0]], jnp.float32),
                                  CFG.voxel_size)
        _, w, _ = blockmap.gather_voxels(state, vox, CFG)
        assert float(w[0]) > 0


class TestTiledAllocCandidates:
    """Online tile decimation (MapConfig.alloc_tile): two rays per 2x2
    tile must cover (nearly) the per-pixel key set, and anything extra
    must be adjacent to it (band extension across tile depth spreads)."""

    def _key_sets(self, depth, pose):
        k1 = np.asarray(integrate.alloc_candidates(depth, pose, CAM, CFG))
        k2 = np.asarray(integrate.alloc_candidates(depth, pose, CAM, CFG,
                                                   tile=2))
        s1 = set(k1[k1 != int(INVALID_KEY)].tolist())
        s2 = set(k2[k2 != int(INVALID_KEY)].tolist())
        return s1, s2

    def test_flat_scene_tile_covers_per_pixel(self):
        depth, _ = wall_depth()
        s1, s2 = self._key_sets(depth, jnp.eye(4))
        assert len(s1 & s2) / len(s1) > 0.95
        # stream is 2S/(fold*tile^2) = shorter than the per-pixel stream
        assert (CFG.alloc_fold_tile * depth.size // 4
                < CFG.alloc_fold * depth.size)

    def test_static_camera_phase_rotation_converges(self):
        # A 2x2 tile holding 3+ distinct surfaces only emits its min/max
        # bands per frame; the rotating pooling-grid phase
        # (alloc_candidates ``phase=frame``) must recover the mid-depth
        # band across tile*tile frames even with a STATIC camera.
        # Pattern: rows r%4 in {0,3} alternate 1.0/2.2 by column; rows
        # r%4 in {1,2} are flat 1.5 — at phase 0 every tile brackets
        # [1.0, 2.2] so the 1.5 band is strictly interior (missed), but
        # phase py=1 groups the two 1.5 rows into their own tiles.
        h, w = CAM.height, CAM.width
        r = np.arange(h)[:, None] % 4
        c = np.arange(w)[None, :] % 2
        depth = np.where((r == 0) | (r == 3),
                         np.where(c == 0, 1.0, 2.2), 1.5).astype(np.float32)
        depth = jnp.asarray(np.broadcast_to(depth, (h, w)))
        pose = jnp.eye(4)

        k1 = np.asarray(integrate.alloc_candidates(depth, pose, CAM, CFG))
        s1 = set(k1[k1 != int(INVALID_KEY)].tolist())

        def tiled(phase):
            k = np.asarray(integrate.alloc_candidates(
                depth, pose, CAM, CFG, tile=2, phase=jnp.int32(phase)))
            return set(k[k != int(INVALID_KEY)].tolist())

        s_ph0 = tiled(0)
        union = set()
        for ph in range(4):
            union |= tiled(ph)
        missed0 = len(s1 - s_ph0)
        missed_u = len(s1 - union)
        # phase 0 alone demonstrably misses the mid-depth band...
        assert missed0 > 0
        # ...and the 4-phase union recovers (nearly) everything
        assert missed_u < missed0
        assert missed_u / len(s1) < 0.02, (missed_u, len(s1))

    def test_depth_discontinuity_covers_both_sides(self):
        # half the image at 1.0 m, half at 2.2 m: both surfaces' bands
        # must allocate (the min/max tile rays), even at the seam tiles
        depth = jnp.full((60, 80), 1.0).at[:, 40:].set(2.2)
        s1, s2 = self._key_sets(depth, jnp.eye(4))
        assert len(s1 & s2) / len(s1) > 0.9
        near = {k for k in s1 if True}
        # extras must be within 1 block (Chebyshev) of a per-pixel key
        wb = CFG.world_blocks
        def unpack(ks):
            a = np.array(sorted(ks), np.int64)
            return np.stack([a % wb, (a // wb) % wb, a // (wb * wb)], 1)
        extra = s2 - s1
        if extra:
            a, b = unpack(extra), unpack(s1)
            d = np.abs(a[:, None, :] - b[None, :, :]).max(-1).min(-1)
            assert d.max() <= 2


class TestNoveltyDrivenAlloc:
    def test_agreeing_pixels_drop_novel_object_allocates(self):
        depth, _ = wall_depth()
        pose = jnp.eye(4)
        # model that agrees exactly with the wall -> no candidates at all
        k_agree = np.asarray(integrate.alloc_candidates(
            depth, pose, CAM, CFG, tile=2, model_depth=depth))
        assert np.all(k_agree == int(INVALID_KEY))

        # a novel box appears in front of the wall: its pixels disagree
        # and their bands (and only regions near them) become candidates
        d2 = np.asarray(depth).copy()
        d2[20:40, 30:50] = 1.2
        d2 = jnp.asarray(d2)
        k_new = np.asarray(integrate.alloc_candidates(
            d2, pose, CAM, CFG, tile=2, model_depth=depth))
        s_new = set(k_new[k_new != int(INVALID_KEY)].tolist())
        assert s_new, "novel geometry must produce candidates"
        # the novel keys must cover the z~1.2 band
        wb = CFG.world_blocks
        zs = {int(k) // (wb * wb) - wb // 2 for k in s_new}
        bs = CFG.block_size_world
        z_band = set(range(int((1.2 - CFG.truncation_at(1.2)) / bs),
                           int((1.2 + CFG.truncation_at(1.2)) / bs) + 1))
        assert z_band & zs, (sorted(zs), sorted(z_band))

    def test_model_invalid_keeps_full_coverage(self):
        depth, _ = wall_depth()
        pose = jnp.eye(4)
        nan_model = jnp.full_like(depth, jnp.nan)
        k_no = np.asarray(integrate.alloc_candidates(
            depth, pose, CAM, CFG, tile=2))
        k_nan = np.asarray(integrate.alloc_candidates(
            depth, pose, CAM, CFG, tile=2, model_depth=nan_model))
        s0 = set(k_no[k_no != int(INVALID_KEY)].tolist())
        s1 = set(k_nan[k_nan != int(INVALID_KEY)].tolist())
        assert s0 == s1


def test_round_to_pool_matches_storage_rounding():
    """blockmap.round_to_pool is exactly the pool's storage rounding, so
    flags derived from it agree with the stored rows (a reduce_precision
    that the GPU compiler cannot fold away)."""
    import jax
    x = jnp.asarray(np.random.default_rng(0).normal(
        0.0, 0.02, 20000).astype(np.float32))
    r = jax.jit(blockmap.round_to_pool)(x)
    stored = x.astype(blockmap.POOL_DTYPE).astype(jnp.float32)
    assert bool(jnp.all(r == stored))
    assert r.dtype == jnp.float32
    depth, color = wall_depth()
    jaxpr = jax.make_jaxpr(lambda s, d, c: integrate.integrate(
        s, d, c, jnp.eye(4), CAM, CFG))(blockmap.create(CFG), depth, color)
    assert "reduce_precision" in str(jaxpr)
