"""Isosurface mesh extraction over the block-sparse TSDF map.

Re-derivation of the reference's two-pass marching cubes
(/root/reference/DepthSensingCUDA/Source/CUDAMarchingCubesHashSDF.cpp:17-224,
``MarchingCubesSDFUtil.h:155-263``): pass 1 compacts occupied blocks, pass 2
extracts per-voxel surface triangles with edge interpolation, color
interpolation, truncation guards, and a static triangle budget
(s_marchingCubesMaxNumTriangles).

Design notes (intentionally NOT the reference algorithm):
* Triangulation is **marching tetrahedra** over the 6-tetrahedron cube
  decomposition rather than classic 256-case marching cubes — every case
  reduces to 1-2 triangles derivable from first principles (no borrowed
  case tables), all branch-free and vectorisable.  Output quality is
  equivalent (same interpolated edge vertices, ~2x triangle count before
  dedup); ``save_ply`` merges duplicate vertices like the reference's mLib
  vertex merge (CUDAMarchingCubesHashSDF.cpp:88-143).
* Dynamic output sizes (the reference's atomic triangle append,
  ``appendTriangle`` :289-313) become mask -> prefix-sum -> scatter with a
  static cap; a surface-cube pre-compaction pass keeps the expensive
  per-tetrahedron work proportional to actual surface area.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import MapConfig, MeshConfig, SDF_BLOCK_SIZE, VOXELS_PER_BLOCK
from . import blockmap, geometry as geom
from .blockmap import MapState
from .geometry import INVALID_KEY

# Cube corners: corner i at offset ((i>>0)&1, (i>>1)&1, (i>>2)&1).
_CUBE_CORNERS = [(i & 1, (i >> 1) & 1, (i >> 2) & 1) for i in range(8)]

# Six-tetrahedron decomposition around the main diagonal 0-7; every tet is
# (0, a, b, 7) with (a, b) walking edges of the cube.
_TETS = [(0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7),
         (0, 6, 4, 7), (0, 4, 5, 7), (0, 5, 1, 7)]

# Tet edges as (corner, corner) index pairs into the 4 tet vertices.
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]

# Per 4-bit inside-mask: list of triangles, each a triple of tet-edge ids.
# Derived from first principles: 1 vertex inside -> 1 triangle on its 3
# incident edges; 2 inside -> quad on the 4 crossing edges (2 triangles);
# complements mirror. Orientation fixed later via the SDF gradient.
def _tet_cases():
    cases = []
    for mask in range(16):
        inside = [i for i in range(4) if mask & (1 << i)]
        cross = [e for e, (a, b) in enumerate(_TET_EDGES)
                 if (mask >> a & 1) != (mask >> b & 1)]
        if len(inside) in (0, 4):
            cases.append([])
        elif len(inside) in (1, 3):
            assert len(cross) == 3
            cases.append([tuple(cross)])
        else:
            assert len(cross) == 4
            # order the 4 crossing edges into a quad ring: two edges share
            # a tet vertex iff adjacent in the ring
            e0 = cross[0]
            ring = [e0]
            rest = cross[1:]
            while rest:
                a = set(_TET_EDGES[ring[-1]])
                nxt = next(e for e in rest if set(_TET_EDGES[e]) & a)
                ring.append(nxt)
                rest.remove(nxt)
            cases.append([(ring[0], ring[1], ring[2]),
                          (ring[0], ring[2], ring[3])])
    return cases


_TET_CASES = _tet_cases()
_MAX_TRIS_PER_TET = 2


class MeshChunk(NamedTuple):
    """Extracted triangle soup (device): fixed-capacity + count."""

    vertices: jax.Array   # f32[cap, 3, 3]  triangle corner positions (world)
    colors: jax.Array     # f32[cap, 3, 3]  per-corner RGB in [0,1]
    n_triangles: jax.Array  # i32[]
    overflow: jax.Array     # i32[] triangles dropped by the cap


def _compact_surface_cubes(state: MapState, block_idx, block_mask,
                           cfg: MapConfig, cap: int):
    """Indices of voxels whose cube straddles the isosurface.

    The cube of voxel v spans [v, v+1]^3; a quick reject keeps only voxels
    whose own sdf is within a voxel of zero and whose weight is positive
    (the reference's truncation guard, MarchingCubesSDFUtil.h:190-210).
    Returns (cube_block[cap], cube_local[cap], n, overflow).
    """
    sdf = state.sdf[block_idx]                     # [M,512]
    w = state.weight[block_idx]
    thresh = 2.0 * cfg.voxel_size
    near = (w > 0.0) & (jnp.abs(sdf) < thresh) & block_mask[:, None]
    flat = near.reshape(-1)                        # [M*512]
    rank = jnp.cumsum(flat.astype(jnp.int32)) - 1
    n_total = jnp.sum(flat.astype(jnp.int32))
    keep = flat & (rank < cap)
    m = block_idx.shape[0]
    src = jnp.arange(m * VOXELS_PER_BLOCK, dtype=jnp.int32)
    dst = jnp.where(keep, rank, cap)
    slots = jnp.zeros((cap,), jnp.int32).at[dst].set(src, mode="drop")
    cube_block = block_idx[slots // VOXELS_PER_BLOCK]
    cube_local = slots % VOXELS_PER_BLOCK
    n = jnp.minimum(n_total, cap)
    return cube_block, cube_local, n, n_total - n


def extract_block_range(state: MapState, block_idx, block_mask,
                        cfg: MapConfig, mesh_cfg: MeshConfig,
                        cube_cap: int = 1 << 17,
                        tri_cap: int = 1 << 18) -> MeshChunk:
    """Extract triangles from the given blocks (device, static shapes)."""
    cube_block, cube_local, n_cubes, cube_ovf = _compact_surface_cubes(
        state, block_idx, block_mask, cfg, cube_cap)
    cube_valid = jnp.arange(cube_cap) < n_cubes

    # Base voxel coords of each cube: [C] per component.
    blocks = geom.unpack_block_key(state.block_key[cube_block],
                                   cfg.world_blocks)        # [C,3]
    lx = cube_local % SDF_BLOCK_SIZE
    ly = (cube_local // SDF_BLOCK_SIZE) % SDF_BLOCK_SIZE
    lz = cube_local // (SDF_BLOCK_SIZE * SDF_BLOCK_SIZE)
    vx = blocks[:, 0] * SDF_BLOCK_SIZE + lx
    vy = blocks[:, 1] * SDF_BLOCK_SIZE + ly
    vz = blocks[:, 2] * SDF_BLOCK_SIZE + lz

    # 8 corner samples: [8, C].
    cx = jnp.stack([vx + o[0] for o in _CUBE_CORNERS], 0)
    cy = jnp.stack([vy + o[1] for o in _CUBE_CORNERS], 0)
    cz = jnp.stack([vz + o[2] for o in _CUBE_CORNERS], 0)
    sdf, w, col = blockmap.gather_voxels_soa(state, cx, cy, cz, cfg,
                                             with_color=True)
    all_valid = jnp.all(w > 0.0, axis=0) & cube_valid        # [C]
    # Truncation guard: reject cubes spanning more than the MC threshold
    # (s_SDFMarchingCubeThreshFactor * voxel, zParametersDefault.txt:26).
    thresh = mesh_cfg.thresh_factor * cfg.voxel_size
    span_ok = (jnp.max(sdf, axis=0) - jnp.min(sdf, axis=0)) < thresh
    all_valid &= span_ok

    vs = cfg.voxel_size
    corner_pos = [jnp.stack([(cx[i]).astype(jnp.float32) * vs,
                             (cy[i]).astype(jnp.float32) * vs,
                             (cz[i]).astype(jnp.float32) * vs], axis=-1)
                  for i in range(8)]                          # 8 x [C,3]
    corner_col = [blockmap.unpack_rgb(col[i]) / 255.0 for i in range(8)]

    chunk = emit_tet_triangles(sdf, corner_pos, corner_col, all_valid,
                               tri_cap)
    return chunk._replace(overflow=chunk.overflow + cube_ovf)


def emit_tet_triangles(sdf, corner_pos, corner_col, all_valid,
                       tri_cap: int) -> MeshChunk:
    """Scene-rep-agnostic marching-tetrahedra emission.

    ``sdf`` [8,C] corner TSDF samples (corner order = _CUBE_CORNERS),
    ``corner_pos``/``corner_col``: 8 x [C,3] world positions / RGB in [0,1],
    ``all_valid`` [C]: cubes eligible for extraction. Shared by the sparse
    hash map (extract_block_range) and the dense voxel grid
    (densegrid.extract_mesh).
    """
    c = sdf.shape[1]
    # Per-tet processing: emit up to 2 triangles each into flat slot space.
    tri_masks = []
    tri_verts = []
    tri_cols = []
    for tet in _TETS:
        s4 = [sdf[i] for i in tet]                            # 4 x [C]
        inside = [(s4[i] < 0.0) for i in range(4)]
        case = (inside[0].astype(jnp.int32)
                + 2 * inside[1].astype(jnp.int32)
                + 4 * inside[2].astype(jnp.int32)
                + 8 * inside[3].astype(jnp.int32))            # [C]

        # Interpolated vertex on each of the 6 tet edges: [6][C,3].
        everts, ecols = [], []
        for (a, b) in _TET_EDGES:
            sa, sb = s4[a], s4[b]
            denom = sa - sb
            t = jnp.where(jnp.abs(denom) > 1e-12, sa / denom, 0.5)
            t = jnp.clip(t, 0.0, 1.0)[:, None]
            pa, pb = corner_pos[tet[a]], corner_pos[tet[b]]
            everts.append(pa + t * (pb - pa))
            ca, cb = corner_col[tet[a]], corner_col[tet[b]]
            ecols.append(ca + t * (cb - ca))
        ev = jnp.stack(everts, 0)                             # [6,C,3]
        ec = jnp.stack(ecols, 0)

        # Gradient proxy for orientation: from inside (-) centroid toward
        # outside (+) centroid; triangle normals must point outside
        # (toward positive sdf), matching the raycast normal convention.
        pos_w = jnp.stack([(~inside[i]).astype(jnp.float32)
                           for i in range(4)], 0)             # [4,C]
        neg_w = 1.0 - pos_w
        p4 = jnp.stack([corner_pos[i] for i in tet], 0)       # [4,C,3]
        cp = jnp.sum(pos_w[..., None] * p4, 0) / jnp.maximum(
            jnp.sum(pos_w, 0), 1.0)[..., None]
        cn = jnp.sum(neg_w[..., None] * p4, 0) / jnp.maximum(
            jnp.sum(neg_w, 0), 1.0)[..., None]
        outward = cp - cn                                     # [C,3]

        for slot in range(_MAX_TRIS_PER_TET):
            # Which edge-triple does this (case, slot) use?
            e_ids = np.full((16, 3), 0, np.int32)
            has = np.zeros((16,), bool)
            for m_case in range(16):
                tris = _TET_CASES[m_case]
                if slot < len(tris):
                    e_ids[m_case] = tris[slot]
                    has[m_case] = True
            e_sel = jnp.asarray(e_ids)[case]                  # [C,3]
            emit = jnp.asarray(has)[case] & all_valid         # [C]

            rows = jnp.arange(c, dtype=jnp.int32)
            v3 = jnp.stack([ev[e_sel[:, k], rows] for k in range(3)],
                           axis=1)                            # [C,3,3]
            c3 = jnp.stack([ec[e_sel[:, k], rows] for k in range(3)],
                           axis=1)
            # Fix winding: normal . outward >= 0.  Zero-area slivers (from
            # exact-zero sdf corners) are dropped.
            nrm = jnp.cross(v3[:, 1] - v3[:, 0], v3[:, 2] - v3[:, 0])
            emit_t = emit & (jnp.sum(nrm * nrm, axis=-1) > 1e-18)
            flip = jnp.sum(nrm * outward, axis=-1) < 0.0
            v3 = jnp.where(flip[:, None, None], v3[:, [0, 2, 1]], v3)
            c3 = jnp.where(flip[:, None, None], c3[:, [0, 2, 1]], c3)
            tri_masks.append(emit_t)
            tri_verts.append(v3)
            tri_cols.append(c3)

    emit = jnp.concatenate(tri_masks, 0)                      # [T]
    verts = jnp.concatenate(tri_verts, 0)                     # [T,3,3]
    cols = jnp.concatenate(tri_cols, 0)
    rank = jnp.cumsum(emit.astype(jnp.int32)) - 1
    n_total = jnp.sum(emit.astype(jnp.int32))
    keep = emit & (rank < tri_cap)
    dst = jnp.where(keep, rank, tri_cap)
    out_v = jnp.zeros((tri_cap, 3, 3), jnp.float32).at[dst].set(
        verts, mode="drop")
    out_c = jnp.zeros((tri_cap, 3, 3), jnp.float32).at[dst].set(
        cols, mode="drop")
    n = jnp.minimum(n_total, tri_cap)
    return MeshChunk(vertices=out_v, colors=out_c, n_triangles=n,
                     overflow=n_total - n)


def extract_mesh(state: MapState, cfg: MapConfig, mesh_cfg: MeshConfig,
                 blocks_per_chunk: int = 8192
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-map extraction, chunked over blocks (the analog of the
    reference's chunked whole-scene extraction,
    CUDAMarchingCubesHashSDF.cpp:147-190).

    Returns host arrays (triangles [T,3,3] f32, colors [T,3,3] f32).
    Total output is clamped at ``mesh_cfg.max_triangles``
    (s_marchingCubesMaxNumTriangles — the reference's appendTriangle
    overflow clamp, MarchingCubesSDFUtil.h:289-313); a warning reports
    any truncation.
    """
    active_idx, n_active = blockmap.compactify_all(state, cfg)
    n_active = int(n_active)
    all_v, all_c = [], []
    total = 0
    truncated = False
    fn = jax.jit(lambda s, bi, bm: extract_block_range(
        s, bi, bm, cfg, mesh_cfg))
    bpc = min(blocks_per_chunk, active_idx.shape[0])
    for start in range(0, max(n_active, 1), bpc):
        # fixed-size window (clamped at the tail to keep one jit shape)
        s0 = min(start, active_idx.shape[0] - bpc)
        idx = active_idx[s0:s0 + bpc]
        mask = (jnp.arange(bpc) + s0) < n_active
        if start != s0:           # tail overlap: mask out re-processed part
            mask &= (jnp.arange(bpc) + s0) >= start
        chunk = fn(state, idx, mask)
        n = int(chunk.n_triangles)
        if n > 0:
            take = min(n, mesh_cfg.max_triangles - total)
            if take < n:
                truncated = True
            if take > 0:
                all_v.append(np.asarray(chunk.vertices[:take]))
                all_c.append(np.asarray(chunk.colors[:take]))
                total += take
        if total >= mesh_cfg.max_triangles:
            # budget filled: a real truncation only if a triangle was
            # clipped (take < n, flagged above) or blocks remain unseen
            if s0 + bpc < n_active:
                truncated = True
            break
    if truncated:
        import warnings
        warnings.warn(
            f"extract_mesh: triangle budget s_marchingCubesMaxNumTriangles="
            f"{mesh_cfg.max_triangles} reached; output truncated")
    if not all_v:
        return (np.zeros((0, 3, 3), np.float32),
                np.zeros((0, 3, 3), np.float32))
    return np.concatenate(all_v), np.concatenate(all_c)


def _chunks_of_keys_np(keys: np.ndarray, world_blocks: int,
                       bpc: int) -> np.ndarray:
    """Block keys [n] -> chunk coords [n,3] (host twin of
    streaming.block_to_chunk)."""
    half = world_blocks // 2
    k = np.asarray(keys).astype(np.int64)
    b = np.stack([k % world_blocks - half,
                  (k // world_blocks) % world_blocks - half,
                  k // (world_blocks * world_blocks) - half], axis=1)
    return (b // bpc).astype(np.int32)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


def extract_mesh_streamed(state: MapState, cfg: MapConfig,
                          mesh_cfg: MeshConfig, manager
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-scene extraction composing device-resident blocks with the
    host chunk store — the reference's chunked whole-scene loop
    (CUDAMarchingCubesHashSDF.cpp:147-190: per occupied chunk, stream in
    chunk±1 neighborhood, extract in a box, stream back out), re-expressed
    without mutating residency: each chunk's blocks plus its 26-chunk
    neighborhood are materialised into a SCRATCH map (so every boundary
    cube sees its +1-voxel neighbors exactly as a fully-resident map
    would), and only the chunk's own blocks emit triangles — each block is
    extracted exactly once. Output equals :func:`extract_mesh` on the
    equivalent unstreamed map, up to triangle order.
    """
    from . import streaming as streaming_mod

    if hasattr(manager, "flush"):
        manager.flush()
    store = manager.store
    bpc = max(1, round(manager.scfg.chunk_size / cfg.block_size_world))

    # device-resident rows, grouped by chunk (the "already streamed in"
    # part of each neighborhood)
    dkeys, dsdf, dweight, dcolor = streaming_mod.resident_rows(state, cfg)
    dev_cc = _chunks_of_keys_np(dkeys, cfg.world_blocks, bpc)
    dev_rows: dict = {}
    for i, cc in enumerate(map(tuple, dev_cc.tolist())):
        dev_rows.setdefault(cc, []).append(i)

    host_cc = {tuple(c) for c in store.chunk_coords().tolist()}
    all_cc = sorted(host_cc | set(dev_rows.keys()))
    if not all_cc:
        return (np.zeros((0, 3, 3), np.float32),
                np.zeros((0, 3, 3), np.float32))

    offsets = np.array([(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1)
                        for z in (-1, 0, 1)], np.int32)

    def neigh_rows(cc):
        """Union rows (host + device) of chunk cc's 27-neighborhood."""
        ncc = np.asarray(cc, np.int32)[None, :] + offsets
        hk, hs, hw, hc = store.peek_chunks(ncc)
        sel = sum((dev_rows.get(tuple(c), []) for c in ncc.tolist()), [])
        if sel:
            sel = np.asarray(sel, np.int64)
            hk = np.concatenate([hk, dkeys[sel]])
            hs = np.concatenate([hs, dsdf[sel]])
            hw = np.concatenate([hw, dweight[sel]])
            hc = np.concatenate([hc, dcolor[sel]])
        return hk, hs, hw, hc

    # one scratch-map shape for all chunks (single jit set): capacity =
    # next pow2 of the largest neighborhood (counted, not copied)
    max_neigh = max(
        store.peek_count(np.asarray(cc, np.int32)[None, :] + offsets)
        + sum(len(dev_rows.get(tuple((np.asarray(cc) + o).tolist()), []))
              for o in offsets)
        for cc in all_cc)
    cap_n = max(_next_pow2(max_neigh), 256)
    import dataclasses as _dc
    # offline scratch: full probe budget + roomy table — the engine's
    # 3-round contended-insert drop-and-retry assumes the candidate set
    # changes next frame, but here the same keys retry against the same
    # residents, so a key whose short probe chain is fully occupied would
    # starve deterministically
    scfg_map = _dc.replace(cfg, num_blocks=cap_n,
                           table_size=_next_pow2(8 * cap_n),
                           max_active_blocks=cap_n,
                           insert_probes=cfg.max_probes)
    ins = jax.jit(lambda s, k, sd, w, c: streaming_mod.insert_blocks(
        s, k, sd, w, c, scfg_map))
    look = jax.jit(lambda s, k: blockmap.lookup(s, k, scfg_map))
    ext = jax.jit(lambda s, bi, bm: extract_block_range(
        s, bi, bm, scfg_map, mesh_cfg))
    empty = blockmap.create(scfg_map)

    all_v, all_c = [], []
    total = 0
    truncated = False
    remaining = False
    for cc in all_cc:
        if total >= mesh_cfg.max_triangles:
            remaining = True
            break
        keys, sdf, weight, color = neigh_rows(cc)
        n = len(keys)
        if n == 0:
            continue
        # staged-dedup allocation drops colliding keys per round
        # (drop-and-retry semantics); re-insert the leftovers until all
        # placed — bounded, every attempt strictly shrinks the list
        scratch = empty
        lk, ls, lw, lc = keys, sdf, weight, color
        for _attempt in range(6):
            m_left = len(lk)
            pad = cap_n - m_left
            scratch, _, placed = ins(
                scratch,
                jnp.asarray(np.pad(lk, (0, pad),
                                   constant_values=INVALID_KEY)),
                jnp.asarray(np.pad(ls, ((0, pad), (0, 0)))),
                jnp.asarray(np.pad(lw, ((0, pad), (0, 0)))),
                jnp.asarray(np.pad(lc, ((0, pad), (0, 0)))))
            pl = np.asarray(placed)[:m_left]
            if pl.all():
                break
            lk, ls, lw, lc = lk[~pl], ls[~pl], lw[~pl], lc[~pl]
        else:
            raise RuntimeError(
                f"extract_mesh_streamed: scratch insert failed for "
                f"{len(lk)} of {n} blocks (capacity bug)")
        # only chunk cc's own blocks emit (each block extracted once)
        own = np.all(_chunks_of_keys_np(keys, cfg.world_blocks, bpc)
                     == np.asarray(cc, np.int32)[None, :], axis=1)
        tgt = keys[own]
        m = len(tgt)
        if m == 0:
            continue
        tpad = cap_n - m
        idx, found = look(scratch, jnp.asarray(np.pad(
            tgt, (0, tpad), constant_values=INVALID_KEY)))
        mask = jnp.asarray(np.arange(cap_n) < m) & found
        chunk = ext(scratch, idx, mask)
        nt = int(chunk.n_triangles)
        if nt > 0:
            take = min(nt, mesh_cfg.max_triangles - total)
            if take < nt:
                truncated = True
            if take > 0:
                all_v.append(np.asarray(chunk.vertices[:take]))
                all_c.append(np.asarray(chunk.colors[:take]))
                total += take
    if truncated or (remaining and total >= mesh_cfg.max_triangles):
        import warnings
        warnings.warn(
            f"extract_mesh_streamed: triangle budget "
            f"s_marchingCubesMaxNumTriangles={mesh_cfg.max_triangles} "
            f"reached; output truncated")
    if not all_v:
        return (np.zeros((0, 3, 3), np.float32),
                np.zeros((0, 3, 3), np.float32))
    return np.concatenate(all_v), np.concatenate(all_c)


def merge_vertices(triangles: np.ndarray, colors: Optional[np.ndarray],
                   weld_eps: float):
    """Weld duplicate vertices (mLib's merge-close-vertices analog).

    Returns (vertices [V,3], faces [F,3] int32, vertex_colors [V,3] | None).
    """
    flat = triangles.reshape(-1, 3)
    q = np.round(flat / weld_eps).astype(np.int64)
    keys = (q[:, 0] * 73856093) ^ (q[:, 1] * 19349669) ^ (q[:, 2] * 83492791)
    # unique by quantised position
    _, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    verts = flat[first]
    faces = inv.reshape(-1, 3).astype(np.int32)
    vcols = None
    if colors is not None:
        vcols = colors.reshape(-1, 3)[first]
    # drop degenerate faces
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts, faces[ok], vcols


def save_ply(path: str, triangles: np.ndarray,
             colors: Optional[np.ndarray] = None,
             weld_eps: Optional[float] = None) -> int:
    """Write a binary little-endian PLY (the reference writes via mLib
    MeshIO, CUDAMarchingCubesHashSDF.cpp:116-143). Returns face count.

    Uses the native C++ weld+writer (native/voxelhash_host.cpp) when
    available; falls back to the numpy path."""
    if weld_eps is None:
        weld_eps = 1e-5
    try:
        from .native import weld_save_ply
        n = weld_save_ply(path, triangles, colors, weld_eps)
        if n is not None:
            return n
    except Exception:
        pass
    verts, faces, vcols = merge_vertices(triangles, colors, weld_eps)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {len(verts)}",
               "property float x", "property float y", "property float z"]
        if vcols is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {len(faces)}",
                "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        if vcols is not None:
            vc = np.clip(vcols * 255.0, 0, 255).astype(np.uint8)
            rec = np.zeros(len(verts),
                           dtype=[("p", np.float32, 3), ("c", np.uint8, 3)])
            rec["p"] = verts.astype(np.float32)
            rec["c"] = vc
            f.write(rec.tobytes())
        else:
            f.write(verts.astype("<f4").tobytes())
        frec = np.zeros(len(faces), dtype=[("n", np.uint8),
                                           ("idx", "<i4", 3)])
        frec["n"] = 3
        frec["idx"] = faces
        f.write(frec.tobytes())
    return len(faces)
