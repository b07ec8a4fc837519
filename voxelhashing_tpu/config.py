"""Configuration tree for the voxel-hashing SLAM engine.

Mirrors the semantics of the reference's X-macro config singletons
(``GlobalAppState.h:28-131``, ``GlobalCameraTrackingState.h:13-25`` in
/root/reference/DepthSensingCUDA/Source) and the ``zParameters*.txt`` key=value
files, but as plain Python dataclasses: everything is a runtime value (no
compile-time #defines), and derived parameters are computed by constructors
the way ``DepthSensing.cpp:1340-1355`` / ``CUDARayCastSDF.h:32-34`` derive
theirs.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

# Fixed structural constants (the reference pound-defines these:
# VoxelUtilHashSDF.h:40-41). Block size stays 8 -- 512 voxels per block,
# one contiguous pool row.
SDF_BLOCK_SIZE = 8
VOXELS_PER_BLOCK = SDF_BLOCK_SIZE ** 3


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics at the working (adapter) resolution.

    The reference rescales raw sensor intrinsics to the adapter resolution in
    ``CUDARGBDAdapter.cpp:53-66``; use :meth:`scaled` for the same rule.
    """

    width: int = 320
    height: int = 240
    fx: float = 262.65  # 525.0 * 320/640 (TUM-style defaults, rescaled)
    fy: float = 262.65
    cx: float = 159.75
    cy: float = 119.75
    depth_min: float = 0.5   # s_sensorDepthMin (zParametersDefault.txt:24)
    depth_max: float = 5.0   # s_sensorDepthMax (zParametersDefault.txt:23)

    def scaled(self, new_width: int, new_height: int) -> "CameraConfig":
        """Rescale intrinsics to a new resolution (CUDARGBDAdapter.cpp:53-66).

        The reference scales focal lengths and principal point by the
        resolution ratio (principal point via the (c+0.5)*s-0.5 pixel-center
        rule).
        """
        sx = new_width / self.width
        sy = new_height / self.height
        return dataclasses.replace(
            self,
            width=new_width,
            height=new_height,
            fx=self.fx * sx,
            fy=self.fy * sy,
            cx=(self.cx + 0.5) * sx - 0.5,
            cy=(self.cy + 0.5) * sy - 0.5,
        )


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Sparse TSDF voxel-block map parameters.

    Mirrors ``HashParams`` (CUDAHashParams.h:11-39) and the hash/SDF block of
    ``zParametersDefault.txt:33-41``, reshaped for the open-addressing
    block-sparse layout.
    """

    voxel_size: float = 0.004        # s_SDFVoxelSize
    truncation: float = 0.02         # s_SDFTruncation
    truncation_scale: float = 0.01   # s_SDFTruncationScale (m per m depth)
    max_integration_distance: float = 4.0  # s_SDFMaxIntegrationDistance
    integration_weight_sample: float = 10.0  # s_SDFIntegrationWeightSample
    integration_weight_max: float = 255.0    # s_SDFIntegrationWeightMax

    # Pool capacity: number of voxel blocks (s_hashNumSDFBlocks).
    num_blocks: int = 1 << 17
    # Open-addressing hash table slots; must be a power of two and should be
    # >= 2x num_blocks to keep probe counts low (replaces 500k buckets x 10).
    table_size: int = 1 << 19
    # Max probe rounds for insertion/lookup (replaces bucket scan + collision
    # linked lists, VoxelUtilHashSDF.h:423-468). With a >= 4x oversized
    # double-hashed table, chains are short; rounds are statically unrolled.
    max_probes: int = 8
    # Probe budget for the contended INSERT loop only (each unrolled round
    # costs ~7 scatter/gather passes over the insert list; lookups keep the
    # full max_probes chain). Keys losing every round drop-and-retry.
    # 3 rounds reach the same steady-state block count as 4 at <=25%
    # table load.
    insert_probes: int = 3
    # Active-set cap: max blocks in camera frustum handled per frame
    # (the reference reads this count back per frame; we keep it static).
    max_active_blocks: int = 1 << 15
    # Insert-list cap: new (non-resident) keys are compacted to this many
    # entries before the probe-insert loop, whose scatter cost scales with
    # list length. Steady-state frames allocate a few dozen blocks; a big
    # first view may exceed the cap and finishes allocating over the next
    # frame(s) (online) or the fixpoint rounds (offline) — the same
    # drop-and-retry semantics as a staging collision.
    alloc_insert_cap: int = 1 << 13
    # Steady-state insert lane width: when <= this many candidates are
    # genuinely new, the probe-insert loop runs on a list this wide
    # instead of alloc_insert_cap (lax.cond two-tier dispatch in
    # _allocate_unique — burst frames still get the full width).
    alloc_insert_small: int = 1 << 11
    # Stage-list cap: candidate keys surviving the allocator's resident
    # pre-drop are compacted to this many entries per round; everything
    # after the pre-drop scales with it. Steady-state frames see a few
    # hundred new keys; a big first view exceeds it and finishes over
    # subsequent frames/rounds (drop-and-retry, bounded by alloc_missed).
    alloc_stage_cap: int = 1 << 14
    # Per-pixel cap on DDA steps through block space during allocation
    # (the truncation band usually spans <= 4 blocks; reference caps the whole
    # ray walk at 1024 iters, CUDASceneRepHashSDF.cu:221).
    alloc_steps: int = 8
    # Candidate-stream fold: each pixel's surviving DDA keys are rank-
    # compacted into this many slots before the allocator (its compaction
    # scatters scale with stream length). Pixels whose band crosses more
    # blocks drop the excess for the frame (drop-and-retry semantics).
    alloc_fold: int = 4
    # Online allocation ray decimation: candidates come from one ray per
    # `alloc_tile` x `alloc_tile` pixel tile instead of one per pixel —
    # TWO rays actually, covering the tile's min-depth and max-depth
    # truncation bands, so both sides of a depth discontinuity allocate.
    # A tile's mid-range depths (3+ distinct surfaces in one 2x2 tile) are
    # the only per-frame coverage loss; the engine rotates the pooling-
    # grid origin through the tile*tile phases (alloc_candidates
    # ``phase=frame``) so the same pixels regroup into different tiles
    # each frame and mid-depth bands converge EVEN UNDER A STATIC CAMERA —
    # the reference's own online alloc is similarly incomplete per frame
    # (bucket-lock drops, CUDASceneRepHashSDF.cu allocBlock). The engine
    # uses tiles ONLINE only; offline fixpoint replay stays per-pixel
    # exact. Tiling shrinks the candidate stream (what the allocator's
    # staging scatters and probe passes scale with) by ~tile^2/fold; the
    # stress-suite ATE is the same at tile=4 as at tile=2 (phase rotation
    # covers a 4x4 tile's mid-depth bands within 16 frames; novelty-alloc
    # already drops the already-mapped pixels). NOTE: falls back to per-pixel
    # when the image dims aren't divisible by the tile. 1 = per-pixel.
    alloc_tile: int = 4
    # Joint fold cap for the two tile rays (each ray's band crosses <= ~4
    # blocks; when the tile is depth-flat the rays duplicate and the
    # cross-ray dedup removes the copies).
    alloc_fold_tile: int = 8
    # Novelty-driven online allocation: drop candidate pixels whose depth
    # agrees with the raycast model within trunc/2 (their band is already
    # fused); see integrate.alloc_candidates(model_depth=...). Offline
    # replay ignores this (exact per-pixel coverage).
    alloc_novelty: bool = True
    # World extent: block coords live in [-world_blocks/2, world_blocks/2).
    # 1024^3 block keys pack into one int32 (30 bits).
    world_blocks: int = 1024

    # Garbage collection (CUDASceneRepHashSDF.h:327-333): identify+free runs
    # every frame; starvation every `gc_starve_interval` frames.
    gc_starve_interval: int = 15  # s_garbageCollectionStarve
    # Pool compaction cadence when deletes broke the dense prefix
    # (blockmap.maybe_maintain): restores the half-width compactify tier
    # without thrashing on churny scenes.
    maintain_interval: int = 32
    gc_enabled: bool = True
    # GC free-pass list bound: culled blocks are compacted to this many
    # entries before the delete pass (its table re-probe loop and row
    # scatters then run over ~1K rows instead of the full active list).
    # Overflow culls re-flag from fresh stats next frame (drop-and-retry,
    # the same bounded-work semantics as allocation).
    gc_delete_cap: int = 1024
    # Bilinear (validity-weighted) color sampling during integration — the
    # reference ships this helper but calls it commented-out
    # (bilinearFilterColor, CUDASceneRepHashSDF.cu:379-410, call site :440);
    # both default to nearest.
    bilinear_color: bool = False
    # Offline replay loops allocation toward fixpoint with this many rounds
    # (the reference iterates until no new allocs, CUDASceneRepHashSDF.h:
    # 251-267; bounded here for static shapes — tests measure the residual
    # miss rate is zero at this bound). Online mode always uses 1 round.
    alloc_rounds_offline: int = 3

    @property
    def block_size_world(self) -> float:
        return self.voxel_size * SDF_BLOCK_SIZE

    def truncation_at(self, z) -> float:
        """Linear truncation model (VoxelUtilHashSDF.h:254-257)."""
        return self.truncation + self.truncation_scale * z


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Multi-resolution projective-ICP parameters.

    Mirrors ``GlobalCameraTrackingState`` defaults and
    ``zParametersTrackingDefault.txt:1-37``.
    """

    levels: int = 3
    max_outer_iter: Tuple[int, ...] = (8, 6, 4)       # fine -> coarse
    # Gauss-Newton re-solves per correspondence search: the outer iteration
    # re-associates, each inner iteration re-linearises about the updated
    # delta against the SAME correspondences (computeBestRigidAlignment,
    # CUDACameraTrackingMultiRes.cpp:213-250).
    max_inner_iter: Tuple[int, ...] = (1, 1, 1)
    dist_thres: Tuple[float, ...] = (0.15, 0.15, 0.15)
    normal_thres: Tuple[float, ...] = (0.97, 0.97, 0.97)
    angle_trans_thres: Tuple[float, ...] = (1.0, 1.0, 1.0)   # radians
    dist_trans_thres: Tuple[float, ...] = (1.0, 1.0, 1.0)    # meters
    residual_early_out: Tuple[float, ...] = (0.01, 0.01, 0.01)
    # Condition-number lost gate, ENFORCED inside the solve (unlike the
    # reference, whose condThres argument is threaded but never compared and
    # whose isTrackingLost() 150-heuristic lives in dead code,
    # ICPErrorLog.h:38-50 / CUDACameraTrackingMultiRes.cpp:213-250). The
    # system here is whitened (centered/scaled — the machinery the reference
    # stubs out with mean=0, stddev=1), so condition measures geometric
    # degeneracy: trackable scenes (even noisy, near-planar ones) sit at
    # cond ~50-1000, while a rank-deficient bare wall blows past 1e6.
    # Below the gate, singular directions weaker than s0/cond_thres are
    # truncated rather than amplified (see tracking._solve6).
    cond_thres: float = 2.0e4
    # Planar-degeneracy (normal-anisotropy) lost gate, renderer-independent
    # (tracking._planarity): the splat renderer's surface roughness fakes
    # enough rank that a bare wall passes the cond gate (cond ~1.5e3 vs
    # 2e4) — the accepted input normals' scatter matrix exposes it in any
    # mode. A frame is degenerate when the normalised scatter's second
    # invariant I2 ~ lam2/lam1 falls below this. Measured envelope
    # (scripts/measure_planarity.py): bare wall 8.2e-4 (bilateral-filtered
    # synthetic); hardest trackable scene (noisy clutter) 1.7e-2; easy
    # scenes >=0.1. 4e-3 = the geometric mean, >=4x margin to both bands.
    # 0 disables.
    normal_aniso_thres: float = 4.0e-3
    # Joint RGB-D (photometric + geometric) tracking — the reference's
    # CUDACameraTrackingMultiResRGBD variant, compiled in but disabled by
    # default (const bool useRGBDTracking = false, DepthSensing.cpp:816).
    # When on, the engine renders the model WITH color and intensity
    # residuals join the normal equations (tracking._build_system_color);
    # weights mirror s_weightsDepth/s_weightsColor
    # (GlobalCameraTrackingState.h:13-25).
    use_rgbd: bool = False
    weight_depth: float = 1.0
    weight_color: float = 0.1
    # photometric residual cutoff/falloff (|dI| >= sigma rejected)
    color_sigma: float = 0.1
    # NOTE: the reference's s_ICPAngleThres is dead in its non-RGBD tracker
    # (the angleThres argument threaded through computeBestRigidAlignment is
    # shadowed by the per-level s_angleTransThres inside
    # delinearizeTransformation, CUDACameraTrackingMultiRes.cpp:194-201), so
    # no equivalent knob exists here — angle_trans_thres is the real gate.


@dataclasses.dataclass(frozen=True)
class RaycastConfig:
    """Raycast parameters (CUDARayCastParams.h:8-29, CUDARayCastSDF.h:24-40)."""

    ray_increment_factor: float = 0.8    # s_SDFRayIncrementFactor
    thres_sample_dist_factor: float = 50.5  # s_SDFRayThresSampleDistFactor
    thres_dist_factor: float = 50.0      # s_SDFRayThresDistFactor
    use_gradients: bool = False          # s_SDFUseGradients
    # Renderer: "splat" (voxel-splat surface prediction; no per-sample map
    # gathers) or "march" (reference-style trilinear ray
    # march, batched). See raycast.py for the splat derivation.
    mode: str = "splat"
    # splat mode: rounds of 3x3 hole-fill dilation for close-range pixels
    # (voxel grid sparser than pixels nearer than ~1 m at default intrinsics)
    hole_fill_rounds: int = 2
    # splat mode: refine depth with one trilinear TSDF evaluation (quality
    # flag; costs one gather pass per pixel)
    refine_trilinear: bool = False
    # march mode: every ray evaluates `num_samples` TSDF samples in one
    # fused pass (no sequential loop); step = max(ray_increment,
    # band / num_samples) within the per-tile splat band. This IS the march
    # step cap (the reference's implicit g_MaxLoopIterCount analog).
    num_samples: int = 48
    splat_enabled: bool = True           # per-tile depth bounds from blocks
    splat_tile: int = 16                 # screen tile size for min/max bounds

    def derived(self, map_cfg: MapConfig):
        ray_increment = self.ray_increment_factor * map_cfg.truncation
        return {
            "ray_increment": ray_increment,
            "thres_sample_dist": self.thres_sample_dist_factor * ray_increment,
            "thres_dist": self.thres_dist_factor * ray_increment,
        }


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Depth/color prefiltering (zParametersDefault.txt:55-62)."""

    depth_sigma_d: float = 2.0
    depth_sigma_r: float = 0.1
    depth_filter: bool = True
    color_sigma_d: float = 2.0
    color_sigma_r: float = 0.1
    color_filter: bool = False


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """HBM<->host-DRAM block tiering (replaces CUDASceneRepChunkGrid).

    Semantics preserved from the reference (zParametersDefault.txt:94-101):
    an active sphere around the camera, a coarse chunk grid on the host, a
    bitmask preventing reallocation of streamed-out space, fractional
    sweeps out and bounded chunks in per frame.
    """

    enabled: bool = False
    chunk_size: float = 1.0       # s_streamingVoxelExtents (1 m^3 chunks)
    grid_dim: int = 257           # s_streamingGridDimensions
    radius: float = 4.0           # derived streaming sphere radius
    out_parts: int = 80           # s_streamingOutParts: sweep 1/N per frame
    in_chunks_per_frame: int = 1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Marching cubes (zParametersDefault.txt:26,91)."""

    max_triangles: int = 2_500_000
    thresh_factor: float = 10.0   # s_SDFMarchingCubeThreshFactor


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level configuration (the GlobalAppState analog)."""

    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    raycast: RaycastConfig = dataclasses.field(default_factory=RaycastConfig)
    filter: FilterConfig = dataclasses.field(default_factory=FilterConfig)
    streaming: StreamingConfig = dataclasses.field(default_factory=StreamingConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # Offline mode (s_offlineProcessing): deterministic replay semantics.
    offline: bool = True
    # Use ground-truth trajectory only to initialise ICP
    # (s_binaryDumpSensorUseTrajectoryOnlyInit, zParametersDefault.txt:50-51).
    use_trajectory: bool = False
    use_trajectory_only_init: bool = False


def realtime_config(num_blocks: int = 1 << 16,
                    table_size: int = 1 << 18) -> EngineConfig:
    """The reference's real-time operating point (zParametersDefault.txt:
    9-29): 320x240 processing, 4 mm voxels, truncation 0.02 m + 0.01 m/m,
    online allocation, GC and free ICP tracking. ``num_blocks`` defaults
    to a 64K-block pool; the reference's own default capacity is
    ``num_blocks=1 << 20, table_size=1 << 21`` (zParametersDefault.txt:
    34-36)."""
    return EngineConfig(
        camera=CameraConfig(),
        map=MapConfig(voxel_size=0.004, truncation=0.02,
                      truncation_scale=0.01, num_blocks=num_blocks,
                      table_size=table_size, max_active_blocks=1 << 15),
        offline=False)


_KV_RE = re.compile(
    r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*(?:\[(\d+)\])?\s*=\s*(.*?)\s*;?\s*(?://.*)?$"
)


def parse_parameter_file(text: str) -> dict:
    """Parse a reference-style ``key = value;`` parameter file.

    Same grammar as mLib's ParameterFile consumed by GlobalAppState::readMembers:
    one ``key = value;`` per line, ``//`` comments, optional ``[i]`` vector
    indices, trailing f suffixes on floats, quoted strings, booleans.
    Returns a flat dict; vector keys become lists.
    """
    out: dict = {}
    for line in text.splitlines():
        line = line.split("//", 1)[0].strip()
        if not line:
            continue
        m = _KV_RE.match(line)
        if not m:
            continue
        key, idx, raw = m.group(1), m.group(2), m.group(3).rstrip(";").strip()
        val = _parse_value(raw)
        if idx is None:
            out[key] = val
        else:
            lst = out.setdefault(key, [])
            i = int(idx)
            while len(lst) <= i:
                lst.append(None)
            lst[i] = val
    return out


def _parse_value(raw: str):
    if raw.startswith('"') and raw.endswith('"'):
        return raw[1:-1]
    low = raw.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    # space-separated numeric vectors ("1.0f 1.0f 1.0f",
    # "513 513 513" — the s_streaming* vec3 grammar)
    toks = raw.split()
    if len(toks) > 1:
        vals = [_parse_scalar(t) for t in toks]
        if all(isinstance(v, (int, float)) for v in vals):
            return vals
    return _parse_scalar(raw)


def _parse_scalar(raw: str):
    raw = raw.rstrip("fF") if re.match(r"^-?[\d.]+([eE][-+]?\d+)?[fF]$", raw) else raw
    try:
        if re.match(r"^-?\d+$", raw):
            return int(raw)
        return float(raw)
    except ValueError:
        return raw


def engine_config_from_parameters(params: dict,
                                  base: Optional[EngineConfig] = None) -> EngineConfig:
    """Build an EngineConfig from parsed reference-style parameters.

    Applies the same key semantics as GlobalAppState/GlobalCameraTrackingState
    (warn-and-default on missing keys -> here: just default).
    """
    cfg = base or EngineConfig()
    cam = cfg.camera
    if "s_adapterWidth" in params or "s_adapterHeight" in params:
        cam = dataclasses.replace(
            cam,
            width=int(params.get("s_adapterWidth", cam.width)),
            height=int(params.get("s_adapterHeight", cam.height)),
        )
    cam = dataclasses.replace(
        cam,
        depth_min=float(params.get("s_sensorDepthMin", cam.depth_min)),
        depth_max=float(params.get("s_sensorDepthMax", cam.depth_max)),
    )
    mp = dataclasses.replace(
        cfg.map,
        voxel_size=float(params.get("s_SDFVoxelSize", cfg.map.voxel_size)),
        truncation=float(params.get("s_SDFTruncation", cfg.map.truncation)),
        truncation_scale=float(
            params.get("s_SDFTruncationScale", cfg.map.truncation_scale)),
        max_integration_distance=float(
            params.get("s_SDFMaxIntegrationDistance",
                       cfg.map.max_integration_distance)),
        integration_weight_sample=float(
            params.get("s_SDFIntegrationWeightSample",
                       cfg.map.integration_weight_sample)),
        integration_weight_max=float(
            params.get("s_SDFIntegrationWeightMax",
                       cfg.map.integration_weight_max)),
        gc_enabled=bool(params.get("s_garbageCollectionEnabled",
                                   cfg.map.gc_enabled)),
        gc_starve_interval=int(params.get("s_garbageCollectionStarve",
                                          cfg.map.gc_starve_interval)),
    )
    # Map capacities (zParametersDefault.txt:34-36): the pool size follows
    # s_hashNumSDFBlocks directly; the open-addressing table replaces the
    # bucketed table (s_hashNumBuckets x HASH_BUCKET_SIZE slots) and is
    # sized to the next power of two >= max(2*num_blocks, numBuckets) so
    # probe chains stay short at the requested load.
    if "s_hashNumSDFBlocks" in params or "s_hashNumBuckets" in params:
        nb = int(params.get("s_hashNumSDFBlocks", mp.num_blocks))
        want = max(2 * nb, int(params.get("s_hashNumBuckets", 0)), 256)
        mp = dataclasses.replace(
            mp, num_blocks=nb,
            table_size=1 << (want - 1).bit_length(),
            max_active_blocks=min(mp.max_active_blocks, nb))
    rc = dataclasses.replace(
        cfg.raycast,
        ray_increment_factor=float(
            params.get("s_SDFRayIncrementFactor",
                       cfg.raycast.ray_increment_factor)),
        thres_sample_dist_factor=float(
            params.get("s_SDFRayThresSampleDistFactor",
                       cfg.raycast.thres_sample_dist_factor)),
        thres_dist_factor=float(
            params.get("s_SDFRayThresDistFactor",
                       cfg.raycast.thres_dist_factor)),
        use_gradients=bool(params.get("s_SDFUseGradients",
                                      cfg.raycast.use_gradients)),
    )
    flt = dataclasses.replace(
        cfg.filter,
        depth_sigma_d=float(params.get("s_depthSigmaD", cfg.filter.depth_sigma_d)),
        depth_sigma_r=float(params.get("s_depthSigmaR", cfg.filter.depth_sigma_r)),
        depth_filter=bool(params.get("s_depthFilter", cfg.filter.depth_filter)),
        color_sigma_d=float(params.get("s_colorSigmaD", cfg.filter.color_sigma_d)),
        color_sigma_r=float(params.get("s_colorSigmaR", cfg.filter.color_sigma_r)),
        color_filter=bool(params.get("s_colorFilter", cfg.filter.color_filter)),
    )
    tk = cfg.tracker
    if "s_maxLevels" in params:
        n = int(params["s_maxLevels"])

        def vec(key, default):
            v = params.get(key)
            if v is None:
                return tuple(default[:n]) if len(default) >= n else tuple(
                    list(default) + [default[-1]] * (n - len(default)))
            v = v[:n]
            return tuple(x if x is not None else default[min(i, len(default) - 1)]
                         for i, x in enumerate(v))

        tk = dataclasses.replace(
            tk,
            levels=n,
            max_outer_iter=tuple(int(x) for x in vec("s_maxOuterIter", tk.max_outer_iter)),
            max_inner_iter=tuple(int(x) for x in vec("s_maxInnerIter", tk.max_inner_iter)),
            dist_thres=vec("s_distThres", tk.dist_thres),
            normal_thres=vec("s_normalThres", tk.normal_thres),
            angle_trans_thres=vec("s_angleTransThres", tk.angle_trans_thres),
            dist_trans_thres=vec("s_distTransThres", tk.dist_trans_thres),
            residual_early_out=vec("s_residualEarlyOut", tk.residual_early_out),
            # RGBD variant weights (GlobalCameraTrackingState.h:13-25);
            # scalar here — the finest level's value is taken
            weight_depth=float(vec("s_weightsDepth",
                                   (tk.weight_depth,) * n)[0]),
            weight_color=float(vec("s_weightsColor",
                                   (tk.weight_color,) * n)[0]),
        )
    mesh = dataclasses.replace(
        cfg.mesh,
        max_triangles=int(params.get("s_marchingCubesMaxNumTriangles",
                                     cfg.mesh.max_triangles)),
        thresh_factor=float(params.get("s_SDFMarchingCubeThreshFactor",
                                       cfg.mesh.thresh_factor)),
    )
    def _vec0(v, default):
        """First component of a vec3 key (chunks are isotropic here; the
        reference's own chunk math treats the extents per-axis but every
        shipped config uses equal components)."""
        if v is None:
            return default
        return v[0] if isinstance(v, list) else v

    streaming = dataclasses.replace(
        cfg.streaming,
        enabled=bool(params.get("s_streamingEnabled", cfg.streaming.enabled)),
        out_parts=int(params.get("s_streamingOutParts", cfg.streaming.out_parts)),
        chunk_size=float(_vec0(params.get("s_streamingVoxelExtents"),
                               cfg.streaming.chunk_size)),
        grid_dim=int(_vec0(params.get("s_streamingGridDimensions"),
                           cfg.streaming.grid_dim)),
        # the reference marks s_streamingRadius "NOT USED; computed
        # automatically" (zParametersDefault.txt:99) but honours the key
        # when present; same here
        radius=float(params.get("s_streamingRadius", cfg.streaming.radius)),
    )
    return dataclasses.replace(
        cfg, camera=cam, map=mp, tracker=tk, raycast=rc, filter=flt,
        mesh=mesh, streaming=streaming,
        offline=bool(params.get("s_offlineProcessing", cfg.offline)),
        use_trajectory=bool(params.get("s_binaryDumpSensorUseTrajectory",
                                       cfg.use_trajectory)),
        use_trajectory_only_init=bool(
            params.get("s_binaryDumpSensorUseTrajectoryOnlyInit",
                       cfg.use_trajectory_only_init)),
    )
