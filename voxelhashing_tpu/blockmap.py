"""Sparse TSDF voxel-block map: the heart of the engine.

Re-design of the reference's spatially-hashed SDF volume (``HashData``,
/root/reference/DepthSensingCUDA/Source/VoxelUtilHashSDF.h:93-824) for XLA:

* The bucketed hash with collision linked lists, per-bucket ``atomicExch``
  mutexes and an atomic free-list heap becomes an **open-addressing hash
  table over a stable voxel pool**, with allocation performed as a batched,
  deterministic ``sort -> unique -> probe -> contended-claim`` pipeline
  (prefix sums + scatters instead of atomics).
* Deletion (garbage collection) uses tombstones; probe chains are repaired
  by periodic deterministic rehash (the analog of the reference's
  linked-list repair in ``deleteHashEntryElement``, :722-809).
* "Compactify" (the per-frame dense list of in-frustum entries,
  CUDASceneRepHashSDF.cu:317-359) becomes mask + cumsum + scatter with a
  static cap, keeping every shape static for jit.

All state lives on device; nothing here ever syncs to host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .config import MapConfig, VOXELS_PER_BLOCK, SDF_BLOCK_SIZE
from . import geometry as geom
from .geometry import INVALID_KEY

# Table slot sentinels. INVALID_KEY marks an empty slot; TOMBSTONE marks a
# deleted slot (lookups skip over it, inserts may claim it).
TOMBSTONE = 0x7FFFFFFE  # Python int: a module-level jnp scalar would be a
# captured device constant in every jit program

# Pool storage dtype for sdf and weight rows. bf16 (a) matches the
# reference's 8-byte voxel memory envelope (float sdf + uchar weight +
# uchar3 color, VoxelUtilHashSDF.h:76-88 -> here bf16 sdf + bf16 weight +
# packed u32 color = 8 B/voxel) and (b) halves the row gather/scatter
# traffic around integrate/GC/splat. Precision: |sdf| <= truncation
# (~0.02-0.06 m), so bf16's 8-bit mantissa gives <= ~1e-4 m absolute quantisation (way
# under the 4 mm voxel size); weights are integer-valued and capped at
# 255 (s_SDFIntegrationWeightMax), exactly representable in bf16.  All
# fusion/sampling MATH stays f32: consumers upcast immediately after the
# row gather and downcast only at the final store.
POOL_DTYPE = jnp.bfloat16


def round_to_pool(x):
    """f32 values rounded to POOL_DTYPE precision, kept in f32.

    ``lax.reduce_precision`` survives XLA's excess-precision rewrites; a
    ``.astype(POOL_DTYPE).astype(f32)`` pair may not (XLA:GPU can remove
    it), which would let a value derived from it disagree with the
    value actually stored."""
    fi = jnp.finfo(POOL_DTYPE)
    return jax.lax.reduce_precision(x, exponent_bits=fi.nexp,
                                    mantissa_bits=fi.nmant)


class MapState(NamedTuple):
    """Device-resident sparse TSDF map (a pytree of fixed-shape arrays).

    Layout: every per-voxel array is [N, 512] with the 512-voxel block as
    the minor axis (one contiguous row per block); colors are bit-packed
    0x00RRGGBB into one uint32 so a voxel fetch is a single gather.
    """

    table_key: jax.Array   # int32[H]   key at slot (INVALID_KEY / TOMBSTONE)
    table_val: jax.Array   # int32[H]   pool index at slot
    block_key: jax.Array   # int32[N]   key per pool slot (INVALID_KEY = free)
    sdf: jax.Array         # f32[N,512] truncated signed distance
    weight: jax.Array      # f32[N,512] integration weight (0 = empty voxel)
    color: jax.Array       # u32[N,512] packed 0x00RRGGBB
    # bool[N]: block holds a surface-band voxel (w>0 and |sdf|<voxel) — the
    # PERSISTENT surface list: maintained by integrate (which rewrites
    # every active voxel anyway) / insert / delete, read by the splat cull
    # instead of re-scanning all active rows per frame. May be stale-TRUE
    # after starvation (harmless: the cull only over-includes).
    surf: jax.Array
    # Free-slot stack (the reference's d_heap + d_heapCounter,
    # VoxelUtilHashSDF.h:813-823, as a deterministic prefix-sum stack):
    # free_stack[0:n_free] holds the free pool slot indices; allocation
    # pops from the top (free_stack[n_free-1-rank]), deletion pushes at
    # n_free. Maintained incrementally instead of rebuilding the free list
    # (a pool-wide cumsum+scatter) every frame.
    free_stack: jax.Array    # int32[N]
    n_free: jax.Array        # int32[]
    n_tombstones: jax.Array  # int32[]  tombstone count (rehash trigger)
    # i32[]: pool row HIGH WATERMARK — every allocated row index is
    # < dense_upto. The free stack is initialised reversed so fresh pops
    # hand out the lowest slots (and deletes push holes that get reused
    # LIFO before the watermark moves), keeping the watermark ~= the
    # allocated count. While the watermark fits the lower half of the
    # pool, compactify and streaming's select_stream_out scan only that
    # half. compact_pool() resets the watermark to the allocated count
    # when fragmentation drives it up.
    dense_upto: jax.Array


def pack_rgb(rgb):
    """f32 [...,3] in 0..255 -> packed u32 0x00RRGGBB."""
    r = jnp.clip(rgb[..., 0], 0, 255).astype(jnp.uint32)
    g = jnp.clip(rgb[..., 1], 0, 255).astype(jnp.uint32)
    b = jnp.clip(rgb[..., 2], 0, 255).astype(jnp.uint32)
    return (r << 16) | (g << 8) | b


def unpack_rgb(packed):
    """packed u32 [...] -> f32 [...,3] in 0..255."""
    p = packed.astype(jnp.uint32)
    return jnp.stack([((p >> 16) & 0xFF).astype(jnp.float32),
                      ((p >> 8) & 0xFF).astype(jnp.float32),
                      (p & 0xFF).astype(jnp.float32)], axis=-1)


def create(cfg: MapConfig) -> MapState:
    """Fresh empty map (reference: resetHashKernel/resetHeapKernel,
    CUDASceneRepHashSDF.cu:23-61)."""
    h, n = cfg.table_size, cfg.num_blocks
    return MapState(
        table_key=jnp.full((h,), INVALID_KEY, jnp.int32),
        table_val=jnp.zeros((h,), jnp.int32),
        block_key=jnp.full((n,), INVALID_KEY, jnp.int32),
        sdf=jnp.zeros((n, VOXELS_PER_BLOCK), POOL_DTYPE),
        weight=jnp.zeros((n, VOXELS_PER_BLOCK), POOL_DTYPE),
        color=jnp.zeros((n, VOXELS_PER_BLOCK), jnp.uint32),
        surf=jnp.zeros((n,), bool),
        # reversed so pops (from the top, free_stack[n_free-1]) hand out
        # slots 0, 1, 2, ... — keeping the allocated set a dense prefix
        free_stack=jnp.arange(n - 1, -1, -1, dtype=jnp.int32),
        n_free=jnp.int32(n),
        n_tombstones=jnp.int32(0),
        dense_upto=jnp.int32(0),
    )


# ---------------------------------------------------------------------------
# Hashing / probing
# ---------------------------------------------------------------------------


def _mix(x):
    """32-bit integer finaliser (murmur3-style avalanche)."""
    x = jnp.asarray(x, jnp.uint32)
    x ^= x >> 16
    x *= jnp.uint32(0x7FEB352D)
    x ^= x >> 15
    x *= jnp.uint32(0x846CA68B)
    x ^= x >> 16
    return x


def _probe_slot(key, r, table_size: int):
    """Slot for probe round r: double hashing on a power-of-two table."""
    k = jnp.asarray(key, jnp.uint32)
    h1 = _mix(k)
    h2 = _mix(k ^ jnp.uint32(0x9E3779B9)) | jnp.uint32(1)  # odd => full cycle
    return ((h1 + jnp.uint32(r) * h2) & jnp.uint32(table_size - 1)).astype(jnp.int32)


def lookup(state: MapState, keys, cfg: MapConfig):
    """Batch key lookup -> (pool_idx int32, found bool). Not-found idx = 0.

    Replaces the bucket scan + linked-list traversal of
    ``getHashEntryForSDFBlockPos`` (VoxelUtilHashSDF.h:423-468) with a fixed
    number of double-hash probe rounds (empty slot terminates the chain;
    tombstones do not).
    """
    keys_in = jnp.asarray(keys, jnp.int32)
    shape = keys_in.shape
    k = keys_in.reshape(-1)   # flat [K]
    found = jnp.zeros(k.shape, bool)
    dead = k == INVALID_KEY   # finished probing (found, or chain ended)
    idx = jnp.zeros(k.shape, jnp.int32)
    # Statically unrolled probe rounds: pure dataflow, no data-dependent
    # while_loop.
    for r in range(cfg.max_probes):
        slots = _probe_slot(k, r, cfg.table_size)
        tk = state.table_key[slots]
        hit = (tk == k) & ~dead
        idx = jnp.where(hit, state.table_val[slots], idx)
        found |= hit
        dead |= hit | (tk == INVALID_KEY)
    return idx.reshape(shape), found.reshape(shape)


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------


def allocate(state: MapState, candidate_keys, cfg: MapConfig,
             rounds: int = 2) -> Tuple[MapState, jax.Array]:
    """Allocate pool blocks for any candidate keys not yet in the map.

    Deterministic, SORT-FREE replacement for ``allocBlock``'s bucket-mutex
    protocol (VoxelUtilHashSDF.h:532-638). Per round:

    1. **Resident pre-drop** over the raw candidate stream: two found-only
       probe gathers drop keys already in the table (nearly all of them in
       steady state), so later stages scale with the new-key count.
    2. **Compaction** of survivors to a bounded stage list.
    3. **Staging dedup**: scatter-min every candidate's instance id into a
       staging slot keyed by its per-round hash; the winning instance
       represents its key.  Two *different* keys colliding in staging drop
       the loser for this round — exactly the reference's semantics, where
       a failed bucket-lock drops the alloc and the next frame (or the
       offline fixpoint loop, CUDASceneRepHashSDF.h:251-267) retries.
       ``rounds=2`` makes same-frame misses vanishingly rare.
    4. **Contended open-addressing insert**: statically unrolled probe
       rounds; empty/tombstone slots are claimed by scatter-min (lowest
       candidate index wins — deterministic); winners take pool slots by
       prefix-sum rank over the free list.

    Returns (new_state, n_allocated).
    """
    keys0 = jnp.asarray(candidate_keys, jnp.int32).reshape(-1)
    h = cfg.table_size
    n_pool = cfg.num_blocks
    scap = min(cfg.alloc_stage_cap, keys0.shape[0])

    total = jnp.int32(0)
    for ri in range(rounds):
        # -- 1. resident pre-drop on the RAW stream: in steady state
        # (camera revisiting mapped space) nearly every candidate is
        # already resident and resolves within two probe rounds at ~10%
        # table load — two found-only gather passes drop them before any
        # compaction, so everything downstream scales with the NEW-key
        # count, not the frame's candidate count. Unresolved chains
        # (occupied-by-other twice, no empty) stay live conservatively;
        # _allocate_unique's full-chain check settles them.
        found = jnp.zeros(keys0.shape, bool)
        term = keys0 == INVALID_KEY
        for r in range(min(2, cfg.max_probes)):
            slots = _probe_slot(keys0, r, h)
            tk = state.table_key[slots]
            hit = (tk == keys0) & ~term
            found |= hit
            term |= hit | (tk == INVALID_KEY)
        live = (keys0 != INVALID_KEY) & ~found

        # -- 2. one compaction of the live keys to the bounded stage list.
        # Overflow drops-and-retries (next round against the updated table
        # frees window space; online, next frame / offline, the fixpoint
        # rounds + alloc_missed check) — the reference's bucket-lock drop
        # semantics (CUDASceneRepHashSDF.h:251-267).
        rank = jnp.cumsum(live.astype(jnp.int32)) - 1
        keep = live & (rank < scap)
        lkeys = jnp.full((scap,), INVALID_KEY, jnp.int32).at[
            jnp.where(keep, rank, scap)].set(keys0, mode="drop")

        # -- 3. staging dedup (hash varies per round so two distinct keys
        # colliding in round r stage to different slots in round r+1):
        # scatter-min instance ids; the winner represents its key.
        valid = lkeys != INVALID_KEY
        slot0 = _probe_slot(lkeys, ri, h)
        inst = jnp.arange(scap, dtype=jnp.int32)
        stage = jnp.full((h,), jnp.int32(0x7FFFFFFF)).at[
            jnp.where(valid, slot0, h)].min(inst, mode="drop")
        rep = valid & (stage[jnp.where(valid, slot0, 0)] == inst)
        keys = jnp.where(rep, lkeys, INVALID_KEY)

        # -- 4. contended insert over the deduped list ------------------
        state, n = _allocate_unique(state, keys, cfg)
        total = total + n
    return state, total


def _allocate_unique(state: MapState, keys, cfg: MapConfig
                     ) -> Tuple[MapState, jax.Array]:
    """Insert candidate keys (at most one instance per distinct key) and
    claim pool slots. Core of :func:`allocate`."""
    h = cfg.table_size
    n_pool = cfg.num_blocks
    k = keys.shape[0]
    inst = jnp.arange(k, dtype=jnp.int32)

    # A key's probe chain may contain tombstones BEFORE its occupied slot
    # (deletes don't compact chains), so claiming the first empty/tombstone
    # slot without knowing the key is absent would shadow the resident block
    # with a duplicate entry (losing its TSDF and leaking the pool slot).
    # Pre-probe the full chain — tombstone-aware, exactly `lookup` — and
    # drop keys that are already resident. Candidates are unique within
    # this call (staging dedup), so the pre-probe can't go stale mid-loop.
    #
    # Cost shape: `lookup` would pay max_probes table_key+table_val gather
    # pairs over the WHOLE list, but (a) only `found` is needed here, and
    # (b) at steady-state load (~10%) nearly every key resolves within two
    # probes — so run two found-only rounds over the full list, then
    # compact the rare unresolved keys to a short list for the remaining
    # rounds.  Overflow past the short list is treated as resident (drop
    # this round, retried next frame online / next fixpoint round offline
    # — the standard drop-and-retry semantics, counted by alloc_missed).
    table_key0 = state.table_key
    found = jnp.zeros(keys.shape, bool)
    dead = keys == INVALID_KEY
    for r in range(min(2, cfg.max_probes)):
        slots = _probe_slot(keys, r, h)
        tk = table_key0[slots]
        hit = (tk == keys) & ~dead
        found |= hit
        dead |= hit | (tk == INVALID_KEY)
    live = ~dead
    rcap = min(2048, k)
    lrank = jnp.cumsum(live.astype(jnp.int32)) - 1
    lkeep = live & (lrank < rcap)
    lkeys = jnp.full((rcap,), INVALID_KEY, jnp.int32).at[
        jnp.where(lkeep, lrank, rcap)].set(keys, mode="drop")
    lpos = jnp.full((rcap,), k, jnp.int32).at[
        jnp.where(lkeep, lrank, rcap)].set(inst, mode="drop")
    lfound = jnp.zeros(lkeys.shape, bool)
    ldead = lkeys == INVALID_KEY
    for r in range(2, cfg.max_probes):
        slots = _probe_slot(lkeys, r, h)
        tk = table_key0[slots]
        hit = (tk == lkeys) & ~ldead
        lfound |= hit
        ldead |= hit | (tk == INVALID_KEY)
    found = found.at[jnp.where(lfound, lpos, k)].set(True, mode="drop")
    overflow = live & ~lkeep
    resident = found | overflow
    keys = jnp.where(resident, INVALID_KEY, keys)

    # Two-tier insert: the probe loop below pays per-round scatter/gather
    # passes sized by its key-list width, and in steady state (camera
    # revisiting mapped space) only tens-to-hundreds of candidates are
    # genuinely new — but burst frames (startup, fast pans, stream-in)
    # legitimately need thousands (an under-capped first frame leaves the
    # model too sparse to track and the engine, reference-faithfully,
    # never integrates while lost — permanent loss). So the runtime picks
    # the lane width: a small list when everything fits, the full
    # alloc_insert_cap list on burst frames (lax.cond — only the taken
    # branch executes). Overflow past the FULL cap drops this round's
    # extras — retried next frame online / next fixpoint round offline,
    # the same semantics as a staging collision.
    small = min(cfg.alloc_insert_small, cfg.alloc_insert_cap, k)
    full = min(cfg.alloc_insert_cap, k)
    n_new = jnp.sum((keys != INVALID_KEY).astype(jnp.int32))
    if small < full:
        return jax.lax.cond(
            n_new <= small,
            lambda s: _insert_new(s, keys, cfg, small),
            lambda s: _insert_new(s, keys, cfg, full),
            state)
    return _insert_new(state, keys, cfg, full)


def _insert_new(state: MapState, keys, cfg: MapConfig, icap: int
                ) -> Tuple[MapState, jax.Array]:
    """Compact the new keys to an ``icap``-wide list and run the contended
    probe-insert loop (tail of :func:`_allocate_unique`)."""
    h = cfg.table_size
    n_pool = cfg.num_blocks
    k = keys.shape[0]
    if icap < k:
        is_new = keys != INVALID_KEY
        nrank = jnp.cumsum(is_new.astype(jnp.int32)) - 1
        nkeep = is_new & (nrank < icap)
        keys = jnp.full((icap,), INVALID_KEY, jnp.int32).at[
            jnp.where(nkeep, nrank, icap)].set(keys, mode="drop")
        k = icap
    inst = jnp.arange(k, dtype=jnp.int32)

    # Pool slots come off the incremental free stack (consumeHeap,
    # VoxelUtilHashSDF.h:518-529): pop from the top, deterministically
    # ordered by prefix-sum rank over this round's winners.
    n_free = state.n_free
    free_stack = state.free_stack

    table_key, table_val = state.table_key, state.table_val
    block_key = state.block_key
    pending = keys != INVALID_KEY
    alloc_base = jnp.int32(0)
    max_pslot = jnp.int32(-1)
    claim_init = jnp.full((h,), jnp.int32(0x7FFFFFFF))

    # Insert probes a SHORTER budget than lookup: at <= 50% pool/table load
    # the claim lands within a few rounds; a key that loses all of them
    # drops and retries next frame (same bucket-contention semantics as
    # the reference). Any slot claimed here is within lookup's longer
    # probe chain, so reachability is preserved.
    for r in range(min(cfg.insert_probes, cfg.max_probes)):
        slots = _probe_slot(keys, r, h)
        tk = table_key[slots]
        # key already present (prior frame): stop
        pending &= ~(pending & (tk == keys))
        empty = (tk == INVALID_KEY) | (tk == TOMBSTONE)
        contend = pending & empty
        claim = claim_init.at[jnp.where(contend, slots, h)].min(
            inst, mode="drop")
        win = contend & (claim[slots] == inst)
        rank = jnp.cumsum(win.astype(jnp.int32)) - 1 + alloc_base
        can = win & (rank < n_free)
        pslot = free_stack[jnp.clip(n_free - 1 - rank, 0, n_pool - 1)]
        table_key = table_key.at[jnp.where(can, slots, h)].set(
            keys, mode="drop")
        table_val = table_val.at[jnp.where(can, slots, h)].set(
            pslot, mode="drop")
        block_key = block_key.at[jnp.where(can, pslot, n_pool)].set(
            keys, mode="drop")
        alloc_base = alloc_base + jnp.sum(can.astype(jnp.int32))
        max_pslot = jnp.maximum(max_pslot,
                                jnp.max(jnp.where(can, pslot, -1)))
        # winners are done; pool-exhausted winners give up (slot unwritten)
        pending &= ~win

    # advance the row watermark past the highest slot handed out this
    # call (pops reuse freed holes first — LIFO — so it only moves when
    # fresh prefix slots are consumed)
    return state._replace(table_key=table_key, table_val=table_val,
                          block_key=block_key,
                          n_free=n_free - alloc_base,
                          dense_upto=jnp.maximum(state.dense_upto,
                                                 max_pslot + 1)), alloc_base


def _table_insert(table_key, table_val, keys, vals, pending, cfg: MapConfig):
    """Deterministic contended insertion of unique keys.

    Each round: pending keys probe one slot; keys hitting an empty/tombstone
    slot contend via scatter-min (lowest key wins — deterministic); winners
    write, losers and keys hitting occupied slots advance to the next round.
    """
    h = cfg.table_size
    inserted = jnp.zeros(keys.shape, bool)
    claim_init = jnp.full((h,), INVALID_KEY, jnp.int32)
    for r in range(cfg.max_probes):
        slots = _probe_slot(keys, r, cfg.table_size)
        tk = table_key[slots]
        empty = (tk == INVALID_KEY) | (tk == TOMBSTONE)
        contend = pending & empty
        claim = claim_init.at[jnp.where(contend, slots, h)].min(
            keys, mode="drop")
        win = contend & (claim[slots] == keys)
        table_key = table_key.at[jnp.where(win, slots, h)].set(
            keys, mode="drop")
        table_val = table_val.at[jnp.where(win, slots, h)].set(
            vals, mode="drop")
        inserted |= win
        pending &= ~win
    return table_key, table_val, inserted


# ---------------------------------------------------------------------------
# Compactify (active in-frustum block list)
# ---------------------------------------------------------------------------


def compactify(state: MapState, view_matrix, cam, cfg: MapConfig):
    """Dense list of allocated, in-frustum pool indices.

    Replaces ``compactifyHashAllInOneKernel`` (CUDASceneRepHashSDF.cu:317-359)
    with mask + cumsum + scatter at a static cap ``cfg.max_active_blocks``.
    Two-tier over the row watermark: every allocated row is < dense_upto
    (invariant 8), so while the watermark fits the lower half of the pool
    the frustum test + scan run over a half-width static slice
    (lax.cond dispatch, the alloc-insert/splat two-tier pattern).

    Returns (active_idx int32[M] (padded with 0), n_active, overflow_count).
    """
    m = cfg.max_active_blocks
    n = cfg.num_blocks

    def scan(keys):
        n_rows = keys.shape[0]
        allocated = keys != INVALID_KEY
        blocks = geom.unpack_block_key(keys, cfg.world_blocks)
        in_view = geom.block_in_frustum(blocks, view_matrix, cam,
                                        cfg.voxel_size)
        active = allocated & in_view
        rank = jnp.cumsum(active.astype(jnp.int32)) - 1
        n_active_total = jnp.sum(active.astype(jnp.int32))
        keep = active & (rank < m)
        active_idx = jnp.zeros((m,), jnp.int32).at[
            jnp.where(keep, rank, m)].set(
            jnp.arange(n_rows, dtype=jnp.int32), mode="drop")
        n_active = jnp.minimum(n_active_total, m)
        return active_idx, n_active, n_active_total - n_active

    half = n // 2
    if half < 64:          # tiny test pools: no tier
        return scan(state.block_key)
    return jax.lax.cond(
        state.dense_upto <= half,
        lambda s: scan(s.block_key[:half]),
        lambda s: scan(s.block_key),
        state)


def compactify_all(state: MapState, cfg: MapConfig):
    """Dense list of ALL allocated pool indices (for meshing/streaming)."""
    active = state.block_key != INVALID_KEY
    rank = jnp.cumsum(active.astype(jnp.int32)) - 1
    n = cfg.num_blocks
    active_idx = jnp.zeros((n,), jnp.int32).at[
        jnp.where(active, rank, n)].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")
    return active_idx, jnp.sum(active.astype(jnp.int32))


# ---------------------------------------------------------------------------
# Voxel access helpers (shared by raycast / meshing)
# ---------------------------------------------------------------------------


def gather_voxels(state: MapState, voxel_coords, cfg: MapConfig,
                  with_color: bool = True):
    """Fetch (sdf, weight, color[...,3]) for integer voxel coords [...,3].

    The reference's ``getVoxel(world)`` hash lookup per voxel
    (VoxelUtilHashSDF.h:364-377). Unallocated -> weight 0.  All work happens
    on flat 1-D views; color unpacks from u32.
    """
    vc = jnp.asarray(voxel_coords, jnp.int32)
    shape = vc.shape[:-1]
    vc = vc.reshape(-1, 3)
    sdf, w, c = gather_voxels_soa(state, vc[:, 0], vc[:, 1], vc[:, 2], cfg,
                                  with_color=with_color)
    sdf, w = sdf.reshape(shape), w.reshape(shape)
    if not with_color:
        return sdf, w, None
    return sdf, w, unpack_rgb(c).reshape(shape + (3,))


def gather_voxels_soa(state: MapState, vx, vy, vz, cfg: MapConfig,
                      with_color: bool = True, axis_name=None):
    """SoA voxel fetch: integer voxel coord component arrays (any equal
    shape) -> (sdf, weight, packed_color_u32 | None) of the same shape.

    ``axis_name``: when the map is hash-partitioned over a device mesh
    axis, each key resides on exactly ONE device, so a masked ``psum``
    of the local fetches reconstructs the global sample — this is the
    halo-free distributed trilinear access path (SURVEY §7 phase 4):
    every device gets the same global values back.
    """
    bs = SDF_BLOCK_SIZE
    bx = jnp.floor_divide(vx, bs)
    by = jnp.floor_divide(vy, bs)
    bz = jnp.floor_divide(vz, bs)
    half = cfg.world_blocks // 2
    wb = cfg.world_blocks
    gx, gy, gz = bx + half, by + half, bz + half
    in_range = ((gx >= 0) & (gx < wb) & (gy >= 0) & (gy < wb)
                & (gz >= 0) & (gz < wb))
    key = jnp.where(in_range, (gz * wb + gy) * wb + gx, INVALID_KEY)
    pool_idx, found = lookup(state, key, cfg)
    local = (jnp.remainder(vz, bs) * bs + jnp.remainder(vy, bs)) * bs \
        + jnp.remainder(vx, bs)
    lin = pool_idx * VOXELS_PER_BLOCK + local
    # gather in POOL_DTYPE (half the HBM traffic), upcast right after
    sdf = jnp.where(found, state.sdf.reshape(-1)[lin].astype(jnp.float32),
                    0.0)
    w = jnp.where(found, state.weight.reshape(-1)[lin].astype(jnp.float32),
                  0.0)
    if not with_color:
        if axis_name is not None:
            sdf = jax.lax.psum(sdf, axis_name)
            w = jax.lax.psum(w, axis_name)
        return sdf, w, None
    c = jnp.where(found, state.color.reshape(-1)[lin], 0)
    if axis_name is not None:
        sdf = jax.lax.psum(sdf, axis_name)
        w = jax.lax.psum(w, axis_name)
        # packed 24-bit colors are exact in f32; psum then re-cast
        c = jax.lax.psum(c.astype(jnp.float32), axis_name).astype(jnp.uint32)
    return sdf, w, c


def delete_blocks(state: MapState, pool_indices, delete_mask,
                  cfg: MapConfig) -> MapState:
    """Free the given pool slots and tombstone their table entries.

    Replaces ``deleteHashEntryElement`` + heap append
    (VoxelUtilHashSDF.h:722-809): voxels are zeroed (the invariant "free
    slots hold zero voxels" is what allocation relies on), the pool key is
    cleared, and the table slot becomes a TOMBSTONE counted for rehash.
    """
    pool_indices = jnp.asarray(pool_indices, jnp.int32)
    keys = state.block_key[pool_indices]
    delete_mask = delete_mask & (keys != INVALID_KEY)
    n = cfg.num_blocks

    # Find each key's table slot (re-probe) and tombstone it.
    h = cfg.table_size
    table_key = state.table_key
    done = ~delete_mask
    for r in range(cfg.max_probes):
        slots = _probe_slot(keys, r, cfg.table_size)
        hit = (table_key[slots] == keys) & ~done
        table_key = table_key.at[jnp.where(hit, slots, h)].set(
            TOMBSTONE, mode="drop")
        done |= hit
    n_deleted = jnp.sum(delete_mask.astype(jnp.int32))

    # Push freed slots onto the free stack (appendHeap analog).
    # CONTRACT: callers pass duplicate-free pool index lists (compactify
    # outputs), so each slot is pushed at most once; a duplicate would
    # double-push the slot and over-increment n_free (the same slot later
    # handed to two keys). check_invariants() item 7 (free-stack
    # partition) detects any violation post-hoc; tests assert it on the
    # delete/streaming paths.
    drank = jnp.cumsum(delete_mask.astype(jnp.int32)) - 1
    free_stack = state.free_stack.at[
        jnp.where(delete_mask, state.n_free + drank, n)].set(
        pool_indices, mode="drop")

    safe_idx = jnp.where(delete_mask, pool_indices, n)
    block_key = state.block_key.at[safe_idx].set(INVALID_KEY, mode="drop")
    zero_v = jnp.zeros((VOXELS_PER_BLOCK,), POOL_DTYPE)
    sdf = state.sdf.at[safe_idx].set(zero_v, mode="drop")
    weight = state.weight.at[safe_idx].set(zero_v, mode="drop")
    color = state.color.at[safe_idx].set(
        jnp.zeros((VOXELS_PER_BLOCK,), jnp.uint32), mode="drop")
    surf = state.surf.at[safe_idx].set(False, mode="drop")
    return state._replace(table_key=table_key, table_val=state.table_val,
                          block_key=block_key, sdf=sdf, weight=weight,
                          color=color, surf=surf,
                          free_stack=free_stack,
                          n_free=state.n_free + n_deleted,
                          n_tombstones=state.n_tombstones + n_deleted)
    # (row watermark unchanged: deletes create holes BELOW it, which
    # carry INVALID keys and which the LIFO stack reuses before the
    # watermark moves)


def rehash(state: MapState, cfg: MapConfig) -> MapState:
    """Rebuild the hash table from the pool (clears tombstones).

    Deterministic full re-insert; the analog of the reference's linked-list
    repair, amortised. Cheap relative to a frame (one sort-free insert pass
    over N keys).
    """
    table_key = jnp.full((cfg.table_size,), INVALID_KEY, jnp.int32)
    table_val = jnp.zeros((cfg.table_size,), jnp.int32)
    keys = state.block_key
    pending = keys != INVALID_KEY
    vals = jnp.arange(cfg.num_blocks, dtype=jnp.int32)
    table_key, table_val, inserted = _table_insert(
        table_key, table_val, keys, vals, pending, cfg)
    # Keys that fail re-insertion would be unreachable; drop them from the
    # pool (and return their slots to the free stack) to preserve the
    # table<->pool bijection invariant.
    lost = pending & ~inserted
    n = cfg.num_blocks
    safe_idx = jnp.where(lost, vals, n)
    block_key = keys.at[safe_idx].set(INVALID_KEY, mode="drop")
    # Lost slots go back on the free stack, so their voxel rows must be
    # zeroed (the "free slots hold zero voxels" allocation precondition,
    # invariants 5/6) — they land on TOP of the stack and are popped first,
    # so stale TSDF would otherwise leak straight into the next alloc.
    zero_v = jnp.zeros((VOXELS_PER_BLOCK,), POOL_DTYPE)
    sdf = state.sdf.at[safe_idx].set(zero_v, mode="drop")
    weight = state.weight.at[safe_idx].set(zero_v, mode="drop")
    color = state.color.at[safe_idx].set(
        jnp.zeros((VOXELS_PER_BLOCK,), jnp.uint32), mode="drop")
    surf = state.surf.at[safe_idx].set(False, mode="drop")
    lrank = jnp.cumsum(lost.astype(jnp.int32)) - 1
    free_stack = state.free_stack.at[
        jnp.where(lost, state.n_free + lrank, n)].set(vals, mode="drop")
    n_lost = jnp.sum(lost.astype(jnp.int32))
    return state._replace(table_key=table_key, table_val=table_val,
                          block_key=block_key,
                          sdf=sdf, weight=weight, color=color, surf=surf,
                          free_stack=free_stack,
                          n_free=state.n_free + n_lost,
                          n_tombstones=jnp.int32(0))


def maybe_rehash(state: MapState, cfg: MapConfig) -> MapState:
    """Rehash when tombstones exceed 1/8 of the table (jit-safe cond)."""
    return jax.lax.cond(
        state.n_tombstones > cfg.table_size // 8,
        lambda s: rehash(s, cfg),
        lambda s: s,
        state)


def compact_pool(state: MapState, cfg: MapConfig) -> MapState:
    """Permute the allocated rows to the pool prefix [0, n), rebuild the
    table, and reset the free stack — restoring ``dense_upto`` so
    compactify and select_stream_out take their half-width tier again.

    The reference never compacts its heap (allocBlock takes whatever slot
    ``consumeHeap`` returns, VoxelUtilHashSDF.h:518-529). Cost: one
    full-pool permutation — run it on the rehash cadence, not per frame
    (:func:`maybe_maintain`).
    """
    n_pool = cfg.num_blocks
    allocated = state.block_key != INVALID_KEY
    rank = jnp.cumsum(allocated.astype(jnp.int32)) - 1
    n = jnp.sum(allocated.astype(jnp.int32))
    # src[d] = old row index now living at dense position d (d < n)
    src = jnp.zeros((n_pool,), jnp.int32).at[
        jnp.where(allocated, rank, n_pool)].set(
        jnp.arange(n_pool, dtype=jnp.int32), mode="drop")
    live = jnp.arange(n_pool, dtype=jnp.int32) < n
    keys = jnp.where(live, state.block_key[src], INVALID_KEY)
    zero_v = jnp.zeros((1, VOXELS_PER_BLOCK), state.sdf.dtype)
    sdf = jnp.where(live[:, None], state.sdf[src], zero_v)
    weight = jnp.where(live[:, None], state.weight[src], zero_v)
    color = jnp.where(live[:, None], state.color[src],
                      jnp.zeros((1, VOXELS_PER_BLOCK), jnp.uint32))
    surf = jnp.where(live, state.surf[src], False)

    table_key = jnp.full((cfg.table_size,), INVALID_KEY, jnp.int32)
    table_val = jnp.zeros((cfg.table_size,), jnp.int32)
    vals = jnp.arange(n_pool, dtype=jnp.int32)
    table_key, table_val, inserted = _table_insert(
        table_key, table_val, keys, vals, keys != INVALID_KEY, cfg)
    # re-insertion losses (rare probe exhaustion): drop + zero, exactly as
    # rehash does; a mid-prefix loss breaks density again
    lost = (keys != INVALID_KEY) & ~inserted
    n_lost = jnp.sum(lost.astype(jnp.int32))
    safe_idx = jnp.where(lost, vals, n_pool)
    keys = keys.at[safe_idx].set(INVALID_KEY, mode="drop")
    zv = jnp.zeros((VOXELS_PER_BLOCK,), state.sdf.dtype)
    sdf = sdf.at[safe_idx].set(zv, mode="drop")
    weight = weight.at[safe_idx].set(zv, mode="drop")
    color = color.at[safe_idx].set(
        jnp.zeros((VOXELS_PER_BLOCK,), jnp.uint32), mode="drop")
    surf = surf.at[safe_idx].set(False, mode="drop")
    # reversed stack: pops hand out n, n+1, ...; lost slots pushed on top
    free_stack = jnp.arange(n_pool - 1, -1, -1, dtype=jnp.int32)
    lrank = jnp.cumsum(lost.astype(jnp.int32)) - 1
    n_free0 = n_pool - n
    free_stack = free_stack.at[
        jnp.where(lost, n_free0 + lrank, n_pool)].set(vals, mode="drop")
    return state._replace(table_key=table_key, table_val=table_val,
                          block_key=keys, sdf=sdf, weight=weight,
                          color=color, surf=surf,
                          free_stack=free_stack,
                          n_free=n_free0 + n_lost,
                          n_tombstones=jnp.int32(0),
                          dense_upto=n)   # lost slots are holes below n


def maybe_maintain(state: MapState, cfg: MapConfig, frame_idx) -> MapState:
    """Periodic map maintenance (jit-safe): compact+rebuild when
    tombstones pile up (the rehash trigger) OR hole fragmentation has
    pushed the row watermark well past the allocated count (the
    compactify/select tiers track the watermark)."""
    n_alloc = jnp.int32(cfg.num_blocks) - state.n_free
    need = (state.n_tombstones > cfg.table_size // 8) | (
        (state.dense_upto - n_alloc > cfg.num_blocks // 16)
        & (jnp.mod(frame_idx, cfg.maintain_interval) == 0))
    return jax.lax.cond(need, lambda s: compact_pool(s, cfg),
                        lambda s: s, state)


# ---------------------------------------------------------------------------
# Introspection (debugHash analog)
# ---------------------------------------------------------------------------


def stats(state: MapState, cfg: MapConfig) -> dict:
    """Occupancy statistics (heap-free watermark analog,
    DepthSensing.cpp:731-735)."""
    allocated = state.block_key != INVALID_KEY
    return {
        "n_allocated": jnp.sum(allocated.astype(jnp.int32)),
        "n_free": jnp.sum((~allocated).astype(jnp.int32)),
        "n_table_used": jnp.sum(
            ((state.table_key != INVALID_KEY)
             & (state.table_key != TOMBSTONE)).astype(jnp.int32)),
        "n_tombstones": state.n_tombstones,
    }


def check_invariants(state: MapState, cfg: MapConfig) -> dict:
    """Host-side invariant checker mirroring ``debugHash``
    (CUDASceneRepHashSDF.h:129-233). Returns a dict of violation counts
    (all zero = healthy). Not jit-compiled; for tests and diagnostics.
    """
    import numpy as np

    table_key = np.asarray(state.table_key)
    table_val = np.asarray(state.table_val)
    block_key = np.asarray(state.block_key)
    inv_key = int(INVALID_KEY)
    tomb = int(TOMBSTONE)

    live = (table_key != inv_key) & (table_key != tomb)
    live_vals = table_val[live]
    live_keys = table_key[live]

    # 1. No duplicate pool pointers in the table ("duplicate detection").
    dup_vals = len(live_vals) - len(np.unique(live_vals))
    # 2. No duplicate keys in the table.
    dup_keys = len(live_keys) - len(np.unique(live_keys))
    # 3. Every table entry points at a pool slot holding the same key
    #    ("HEAP CORRUPTED" cross-check).
    mismatch = int(np.sum(block_key[live_vals] != live_keys))
    # 4. Pool partition: every allocated pool slot is reachable from the
    #    table ("memory leak detected").
    allocated = np.flatnonzero(block_key != inv_key)
    unreachable = int(len(np.setdiff1d(allocated, live_vals)))
    # 5. Free slots hold zero voxels (allocation precondition).
    free = block_key == inv_key
    nonzero_free = int(np.sum(
        np.asarray(state.weight).astype(np.float32)[free].sum(axis=-1) > 0))
    # 6. Surface flags: never set on free slots, and never stale-FALSE on
    #    a block that actually holds surface voxels (stale-TRUE after
    #    starvation is allowed — the splat cull only over-includes).
    surf = np.asarray(state.surf)
    surf_on_free = int(np.sum(surf & free))
    w = np.asarray(state.weight).astype(np.float32)
    s = np.asarray(state.sdf).astype(np.float32)
    true_surf = np.any((w > 0) & (np.abs(s) < cfg.voxel_size), axis=1)
    surf_missing = int(np.sum(true_surf & ~surf & ~free))

    # 7. Free-stack partition: free_stack[0:n_free] is exactly the set of
    #    free pool slots (the reference's heap partition check,
    #    "HEAP CORRUPTED" / "memory leak detected",
    #    CUDASceneRepHashSDF.h:129-233).
    n_free = int(state.n_free)
    stack = np.asarray(state.free_stack)[:max(n_free, 0)]
    free_set = np.flatnonzero(free)
    stack_bad = (0 if (n_free == len(free_set)
                       and np.array_equal(np.sort(stack), free_set))
                 else 1 + abs(n_free - len(free_set)))

    # 8. Row-watermark claim: every allocated row index is < dense_upto
    #    (the compactify/select tiers scan only [0, dense_upto)).
    du = int(state.dense_upto)
    dense_bad = int(np.any(block_key[du:] != inv_key))

    return {
        "duplicate_table_vals": dup_vals,
        "duplicate_table_keys": dup_keys,
        "table_pool_mismatch": mismatch,
        "unreachable_blocks": unreachable,
        "nonzero_free_voxels": nonzero_free,
        "surf_flag_on_free": surf_on_free,
        "surf_flag_missing": surf_missing,
        "free_stack_mismatch": stack_bad,
        "dense_prefix_mismatch": dense_bad,
    }
