"""Out-of-core streaming: HBM <-> host-DRAM voxel-block tiering.

Re-derivation of the reference's GPU<->CPU chunk grid
(``CUDASceneRepChunkGrid``, /root/reference/DepthSensingCUDA/Source/
CUDASceneRepChunkGrid.h:152-753, .cpp:8-341, .cu:27-206) with the same
contract, as deterministic device programs:

* The world is a coarse uniform **chunk grid**; each host chunk holds the
  block keys + voxel payloads evicted from device HBM (ChunkDesc,
  :69-121).
* **Active sphere**: blocks outside a sphere around the camera are
  streamed out; chunks inside it are streamed back in
  (``isChunkInSphere`` :317-346).
* **Fractional sweeps**: only 1/``out_parts`` of the pool is scanned per
  frame (useParts, .cpp:75-84), and at most ``in_chunks_per_frame`` host
  chunks are uploaded per frame (:302-304) — bounding per-frame cost.
* **Eviction bitmask**: a device-resident bit array marks streamed-out
  chunks so the allocator never re-allocates evicted space within the
  streaming epoch (``isSDFBlockStreamedOut`` mask consulted by the alloc
  kernel, CUDASceneRepHashSDF.cu:219, re-uploaded each frame :306-309).

Differences from the reference: instead of a Win32 producer/consumer
thread pair with mutex/event handshakes (:661-673), the device halves are
deterministic jit programs (compact-outside-sphere = mask + prefix sum +
row gather; mass insert = the deterministic allocator) and the host half
is plain Python over numpy arrays — the async-dispatch queue plays the
role of the streaming thread.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import MapConfig, StreamingConfig, VOXELS_PER_BLOCK
from . import blockmap, geometry as geom
from .blockmap import MapState
from .geometry import INVALID_KEY


# ---------------------------------------------------------------------------
# Chunk coordinates
# ---------------------------------------------------------------------------


def block_to_chunk(block, cfg: MapConfig, scfg: StreamingConfig):
    """Block coords [...,3] -> chunk coords [...,3] (floor division)."""
    blocks_per_chunk = max(1, round(scfg.chunk_size / cfg.block_size_world))
    return jnp.floor_divide(block, blocks_per_chunk)


def chunk_linear(chunk, scfg: StreamingConfig):
    """Chunk coords -> linear index into the bitmask grid (clamped)."""
    g = scfg.grid_dim
    half = g // 2
    c = jnp.clip(chunk + half, 0, g - 1)
    return (c[..., 2] * g + c[..., 1]) * g + c[..., 0]


def key_to_chunk_linear(keys, cfg: MapConfig, scfg: StreamingConfig):
    blocks = geom.unpack_block_key(jnp.where(keys == INVALID_KEY, 0, keys),
                                   cfg.world_blocks)
    lin = chunk_linear(block_to_chunk(blocks, cfg, scfg), scfg)
    return jnp.where(keys == INVALID_KEY, 0, lin)


# ---------------------------------------------------------------------------
# Device halves (jit-compiled)
# ---------------------------------------------------------------------------


def select_stream_out(state: MapState, cam_pos, part, cfg: MapConfig,
                      scfg: StreamingConfig, cap: int):
    """Pick up to ``cap`` blocks of pool-slice ``part`` outside the active
    sphere; returns (pool_idx [cap], keys [cap], count).

    The analog of integrateFromGlobalHashPass1Kernel's select
    (CUDASceneRepChunkGrid.cu:27-74): d >= radius around the camera.
    Two-tier over the row watermark (every allocated row < dense_upto,
    blockmap invariant 8): steady state scans a half-width static slice.
    """
    n = cfg.num_blocks

    def scan(keys_rows):
        n_rows = keys_rows.shape[0]
        idx = jnp.arange(n_rows, dtype=jnp.int32)
        allocated = keys_rows != INVALID_KEY
        in_part = (idx % scfg.out_parts) == part
        blocks = geom.unpack_block_key(keys_rows, cfg.world_blocks)
        centre = geom.block_to_world(blocks, cfg.voxel_size) \
            + 0.5 * cfg.block_size_world
        d = jnp.linalg.norm(centre - cam_pos[None, :], axis=-1)
        pick = allocated & in_part & (d >= scfg.radius)

        rank = jnp.cumsum(pick.astype(jnp.int32)) - 1
        keep = pick & (rank < cap)
        out_idx = jnp.zeros((cap,), jnp.int32).at[
            jnp.where(keep, rank, cap)].set(idx, mode="drop")
        count = jnp.minimum(jnp.sum(pick.astype(jnp.int32)), cap)
        mask = jnp.arange(cap) < count
        keys = jnp.where(mask, keys_rows[out_idx], INVALID_KEY)
        return out_idx, keys, count

    half = n // 2
    if half < 64:          # tiny test pools: no tier
        return scan(state.block_key)
    return jax.lax.cond(
        state.dense_upto <= half,
        lambda s: scan(s.block_key[:half]),
        lambda s: scan(s.block_key),
        state)


def extract_blocks(state: MapState, pool_idx):
    """Row-gather payloads for transfer (pass-2 copy, ChunkGrid.cu:97-113)."""
    return (state.sdf[pool_idx], state.weight[pool_idx],
            state.color[pool_idx])


def insert_blocks(state: MapState, keys, sdf, weight, color,
                  cfg: MapConfig) -> Tuple[MapState, jax.Array, jax.Array]:
    """Mass-allocate streamed-in blocks and write their payloads
    (chunkToGlobalHashPass1/2, CUDASceneRepChunkGrid.cu:143-189).

    Returns (state, n_inserted, placed_mask). ``placed_mask`` marks keys
    whose payload landed in the map; allocation can fail under probe
    exhaustion or a full pool, and the caller must re-file unplaced blocks
    (the reference throws on staging overflow, ChunkGrid.cpp:82,289-291 —
    here the contract is: never silently drop a streamed-in payload)."""
    # enough alloc rounds that a batch larger than the per-round insert
    # cap (e.g. a whole-checkpoint load) still places every key
    rounds = max(2, -(-int(keys.shape[0]) // cfg.alloc_insert_cap) + 1)
    state, n_ins = blockmap.allocate(state, keys, cfg, rounds=rounds)
    pool_idx, found = blockmap.lookup(state, keys, cfg)
    ok = found & (keys != INVALID_KEY)
    safe = jnp.where(ok, pool_idx, cfg.num_blocks)
    sdf = jnp.asarray(sdf).astype(state.sdf.dtype)        # -> POOL_DTYPE
    weight = jnp.asarray(weight).astype(state.weight.dtype)
    surf = jnp.any((weight.astype(jnp.float32) > 0.0)
                   & (jnp.abs(sdf.astype(jnp.float32)) < cfg.voxel_size),
                   axis=1)
    return state._replace(
        sdf=state.sdf.at[safe].set(sdf, mode="drop"),
        weight=state.weight.at[safe].set(weight, mode="drop"),
        color=state.color.at[safe].set(color, mode="drop"),
        surf=state.surf.at[safe].set(surf, mode="drop"),
    ), n_ins, ok


# ---------------------------------------------------------------------------
# Host chunk store + manager
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HostChunk:
    keys: np.ndarray     # [k] int32
    sdf: np.ndarray      # [k, 512] f32
    weight: np.ndarray   # [k, 512] f32
    color: np.ndarray    # [k, 512] u32


class PyChunkStore:
    """Pure-Python chunk store (fallback when the native library is
    unavailable); same interface as :class:`..native.NativeChunkStore`."""

    def __init__(self, blocks_per_chunk: int, world_blocks: int):
        self.bpc = blocks_per_chunk
        self.world_blocks = world_blocks
        self.chunks: Dict[Tuple[int, int, int], HostChunk] = {}

    def _chunk_of_key(self, key: int) -> Tuple[int, int, int]:
        wb = self.world_blocks
        half = wb // 2
        gx, gy, gz = key % wb, (key // wb) % wb, key // (wb * wb)
        b = np.array([gx - half, gy - half, gz - half])
        return tuple((b // self.bpc).tolist())

    def file_blocks(self, keys, sdf, weight, color):
        # device rows arrive in POOL_DTYPE (bf16 over the wire — half the
        # D2H traffic); the host store keeps plain f32 so numpy ops and
        # np.savez work everywhere downstream
        keys = np.asarray(keys, np.int32)
        if len(keys) == 0:
            return
        sdf = np.asarray(sdf, np.float32)
        weight = np.asarray(weight, np.float32)
        color = np.asarray(color, np.uint32)
        # group incoming blocks by chunk coordinate (vectorised), then ONE
        # concatenate per touched chunk — per-block np.append/vstack is
        # O(n^2) in the call size
        wb = self.world_blocks
        half = wb // 2
        k = keys.astype(np.int64)
        b = np.stack([k % wb - half, (k // wb) % wb - half,
                      k // (wb * wb) - half], axis=1)
        cc_all = b // self.bpc                            # [n,3]
        order = np.lexsort((cc_all[:, 2], cc_all[:, 1], cc_all[:, 0]))
        cs = cc_all[order]
        change = np.any(cs[1:] != cs[:-1], axis=1) if len(cs) > 1 \
            else np.zeros((0,), bool)
        starts = np.concatenate([[0], np.nonzero(change)[0] + 1,
                                 [len(keys)]])
        for si, ei in zip(starts[:-1], starts[1:]):
            cc = tuple(int(v) for v in cs[si])
            sel = order[si:ei]
            ch = self.chunks.get(cc)
            if ch is None:
                self.chunks[cc] = HostChunk(
                    keys=keys[sel].copy(), sdf=sdf[sel].copy(),
                    weight=weight[sel].copy(), color=color[sel].copy())
            else:
                ch.keys = np.concatenate([ch.keys, keys[sel]])
                ch.sdf = np.concatenate([ch.sdf, sdf[sel]])
                ch.weight = np.concatenate([ch.weight, weight[sel]])
                ch.color = np.concatenate([ch.color, color[sel]])

    def block_count(self) -> int:
        return sum(len(c.keys) for c in self.chunks.values())

    def chunk_count(self) -> int:
        return len(self.chunks)

    def chunk_coords(self, cap: int = 1 << 20) -> np.ndarray:
        """Occupied chunk coords [m,3] (non-popping)."""
        if not self.chunks:
            return np.zeros((0, 3), np.int32)
        return np.asarray(list(self.chunks.keys()), np.int32)[:cap]

    def peek_count(self, coords) -> int:
        """Total blocks held by the given chunks [m,3] (no copy)."""
        n = 0
        for cc in np.asarray(coords, np.int32).reshape(-1, 3):
            ch = self.chunks.get((int(cc[0]), int(cc[1]), int(cc[2])))
            if ch is not None:
                n += len(ch.keys)
        return n

    def peek_chunks(self, coords) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]:
        """Copy (without removing) every block of the given chunks [m,3]."""
        ks, ss, ws, cs = [], [], [], []
        for cc in np.asarray(coords, np.int32).reshape(-1, 3):
            ch = self.chunks.get((int(cc[0]), int(cc[1]), int(cc[2])))
            if ch is None:
                continue
            ks.append(ch.keys); ss.append(ch.sdf)
            ws.append(ch.weight); cs.append(ch.color)
        if not ks:
            z = np.zeros((0, VOXELS_PER_BLOCK), np.float32)
            return (np.zeros((0,), np.int32), z, z.copy(),
                    np.zeros((0, VOXELS_PER_BLOCK), np.uint32))
        return (np.concatenate(ks), np.vstack(ss), np.vstack(ws),
                np.vstack(cs))

    def pop_in_sphere(self, cam_pos, radius, chunk_size_world, max_chunks,
                      cap):
        k, s, w, c, _ = self.pop_in_sphere_tracked(
            cam_pos, radius, chunk_size_world, max_chunks, cap)
        return k, s, w, c

    def pop_in_sphere_tracked(self, cam_pos, radius, chunk_size_world,
                              max_chunks, cap):
        """Pop + the chunk coords [m,3] of chunks removed ENTIRELY (the
        bitmask delta-clear set; split chunks stay resident -> bit stays)."""
        cam = np.asarray(cam_pos, np.float32)
        half_diag = (np.sqrt(3.0) / 2.0) * chunk_size_world
        keys, sdfs, ws, cs, cleared = [], [], [], [], []
        popped = total = 0
        for cc in list(self.chunks.keys()):
            if popped >= max_chunks:
                break
            centre = (np.asarray(cc, np.float32) + 0.5) * chunk_size_world
            if np.linalg.norm(centre - cam) + half_diag >= radius:
                continue
            ch = self.chunks[cc]
            take = len(ch.keys)
            if total + take > cap:
                # A chunk that alone exceeds the transfer cap would starve
                # forever under a skip rule; split it instead (the remainder
                # stays filed and moves on later calls).
                take = cap - total
                if take <= 0:
                    continue
                rest = HostChunk(keys=ch.keys[take:], sdf=ch.sdf[take:],
                                 weight=ch.weight[take:],
                                 color=ch.color[take:])
                ch = HostChunk(keys=ch.keys[:take], sdf=ch.sdf[:take],
                               weight=ch.weight[:take], color=ch.color[:take])
                self.chunks[cc] = rest
            else:
                self.chunks.pop(cc)
                cleared.append(cc)
            keys.append(ch.keys); sdfs.append(ch.sdf)
            ws.append(ch.weight); cs.append(ch.color)
            total += take
            popped += 1
        ccs = (np.asarray(cleared, np.int32).reshape(-1, 3)
               if cleared else np.zeros((0, 3), np.int32))
        if not keys:
            z = np.zeros((0, VOXELS_PER_BLOCK), np.float32)
            return (np.zeros((0,), np.int32), z, z.copy(),
                    np.zeros((0, VOXELS_PER_BLOCK), np.uint32), ccs)
        return (np.concatenate(keys), np.vstack(sdfs), np.vstack(ws),
                np.vstack(cs), ccs)

    def chunk_ids(self, grid_dim: int, cap: int = 1 << 20) -> np.ndarray:
        half = grid_dim // 2
        out = []
        for (x, y, z) in self.chunks.keys():
            cx = min(max(x + half, 0), grid_dim - 1)
            cy = min(max(y + half, 0), grid_dim - 1)
            cz = min(max(z + half, 0), grid_dim - 1)
            out.append((cz * grid_dim + cy) * grid_dim + cx)
        return np.asarray(out[:cap], np.int32)

    def save(self, path: str):
        flat_k, flat_s, flat_w, flat_c = [], [], [], []
        for ch in self.chunks.values():
            flat_k.append(ch.keys); flat_s.append(ch.sdf)
            flat_w.append(ch.weight); flat_c.append(ch.color)
        np.savez_compressed(
            path, bpc=self.bpc, world_blocks=self.world_blocks,
            keys=np.concatenate(flat_k) if flat_k else np.zeros(0, np.int32),
            sdf=np.vstack(flat_s) if flat_s else
            np.zeros((0, VOXELS_PER_BLOCK), np.float32),
            weight=np.vstack(flat_w) if flat_w else
            np.zeros((0, VOXELS_PER_BLOCK), np.float32),
            color=np.vstack(flat_c) if flat_c else
            np.zeros((0, VOXELS_PER_BLOCK), np.uint32))

    def load_file(self, path: str):
        z = np.load(path)
        self.chunks.clear()
        self.file_blocks(z["keys"], z["sdf"], z["weight"], z["color"])


def make_chunk_store(blocks_per_chunk: int, world_blocks: int,
                     prefer_native: bool = True):
    """Native C++ chunk store when available (native/voxelhash_host.cpp),
    else the Python fallback."""
    if prefer_native:
        try:
            from .native import NativeChunkStore
            return NativeChunkStore(blocks_per_chunk, world_blocks)
        except Exception:
            pass
    return PyChunkStore(blocks_per_chunk, world_blocks)


class StreamingManager:
    """Host-side orchestration (the streaming thread's role,
    StreamingFunc, CUDASceneRepChunkGrid.cpp:8-29)."""

    def __init__(self, cfg: MapConfig, scfg: StreamingConfig,
                 out_cap: int = 4096):
        self.cfg = cfg
        self.scfg = scfg
        self.out_cap = out_cap
        bpc = max(1, round(scfg.chunk_size / cfg.block_size_world))
        self._bpc = bpc
        self.store = make_chunk_store(bpc, cfg.world_blocks)
        self._part = 0
        g = scfg.grid_dim
        # device-resident eviction bitmask (1 bit per chunk)
        self.bitmask = jnp.zeros(((g * g * g + 31) // 32,), jnp.uint32)
        self._sel = jax.jit(
            lambda s, p, part: select_stream_out(
                s, p, part, cfg, scfg, out_cap))
        self._ins = jax.jit(
            lambda s, k, sd, w, c: insert_blocks(s, k, sd, w, c, cfg))
        self._del = jax.jit(
            lambda s, idx, m: blockmap.delete_blocks(s, idx, m, cfg))

    def _rebuild_bitmask(self):
        """Bitmask = exactly the chunks currently resident on the host
        (re-uploaded each frame in the reference, ChunkGrid.h:306-309)."""
        g = self.scfg.grid_dim
        words = np.zeros(((g * g * g + 31) // 32,), np.uint32)
        ids = self.store.chunk_ids(g)
        if len(ids):
            np.bitwise_or.at(words, ids // 32,
                             np.uint32(1) << (ids % 32).astype(np.uint32))
        self.bitmask = jnp.asarray(words)

    # -- per-frame halves -------------------------------------------------

    def stream_out(self, state: MapState, cam_pos) -> Tuple[MapState, int]:
        """Sweep one pool part; move outside-sphere blocks to host chunks
        (the GPU half of stream-out + integrateInChunkGrid filing,
        ChunkGrid.cpp:55-153; the filing runs in the native C++ store)."""
        out_idx, keys, count = self._sel(
            state, jnp.asarray(cam_pos, jnp.float32), self._part)
        self._part = (self._part + 1) % self.scfg.out_parts
        n = int(count)
        if n == 0:
            return state, 0
        sdf, w, c = extract_blocks(state, out_idx)
        self.store.file_blocks(np.asarray(keys)[:n], np.asarray(sdf)[:n],
                               np.asarray(w)[:n], np.asarray(c)[:n])
        self._rebuild_bitmask()
        mask = jnp.arange(self.out_cap) < count
        state = self._del(state, out_idx, mask)
        return state, n

    def _insert_batch(self, state: MapState, keys, sdf, w, c
                      ) -> Tuple[MapState, int]:
        """Mass-insert popped payloads; re-file what allocation failed to
        place (probe exhaustion / pool full): the pop already removed the
        chunk from the host store, so dropping these would lose map content
        permanently. Returns (state, n_placed)."""
        n = len(keys)
        pad = self.out_cap - n
        state, _, placed = self._ins(
            state,
            jnp.asarray(np.pad(keys, (0, pad),
                               constant_values=INVALID_KEY)),
            jnp.asarray(np.pad(sdf, ((0, pad), (0, 0)))),
            jnp.asarray(np.pad(w, ((0, pad), (0, 0)))),
            jnp.asarray(np.pad(c, ((0, pad), (0, 0)))))
        unplaced = ~np.asarray(placed)[:n]
        n_lost = int(unplaced.sum())
        if n_lost:
            self.store.file_blocks(keys[unplaced], sdf[unplaced],
                                   w[unplaced], c[unplaced])
        return state, n - n_lost

    def stream_in(self, state: MapState, cam_pos) -> Tuple[MapState, int]:
        """Upload up to in_chunks_per_frame whole chunks inside the sphere
        (conservative whole-chunk test, ChunkGrid.h:317-346)."""
        keys, sdf, w, c = self.store.pop_in_sphere(
            np.asarray(cam_pos, np.float32), self.scfg.radius,
            self.scfg.chunk_size, self.scfg.in_chunks_per_frame,
            cap=self.out_cap)
        if len(keys) == 0:
            return state, 0
        state, n_in = self._insert_batch(state, keys, sdf, w, c)
        self._rebuild_bitmask()
        return state, n_in

    def step(self, state: MapState, cam_pos) -> MapState:
        """One streaming epoch step (out then in, DepthSensing.cpp:881-900)."""
        state, _ = self.stream_out(state, cam_pos)
        state, _ = self.stream_in(state, cam_pos)
        return state

    def stream_out_all(self, state: MapState) -> MapState:
        """Evict the whole map (streamOutToCPUAll; used before checkpoint /
        whole-scene meshing, ChunkGrid.h:459-465)."""
        far = jnp.asarray([1e12, 1e12, 1e12], jnp.float32)
        for _ in range(self.scfg.out_parts):
            state, _ = self.stream_out(state, far)
        return state

    def stream_in_all(self, state: MapState) -> MapState:
        """Bring EVERY host-stored block back on device (the inverse of
        stream_out_all — the stream-back-in half of the reference's
        checkpoint sequence, ChunkGrid.h:456-548). The pool must hold the
        whole map; at true out-of-core scale use the composed whole-map
        operations (meshing.extract_mesh_streamed / save_map(manager=...))
        which never materialise the union."""
        stall = 0
        while self.store.block_count() > 0:
            before = self.store.block_count()
            keys, sdf, w, c = self.store.pop_in_sphere(
                np.zeros((3,), np.float32), 1e15, self.scfg.chunk_size,
                1 << 30, cap=self.out_cap)
            if len(keys):
                state, _ = self._insert_batch(state, keys, sdf, w, c)
            stall = stall + 1 if self.store.block_count() >= before else 0
            if stall >= 3:
                raise RuntimeError(
                    f"stream_in_all: device pool cannot hold the whole map "
                    f"({self.store.block_count()} blocks still hosted)")
        self._rebuild_bitmask()
        return state

    def host_block_count(self) -> int:
        return self.store.block_count()

    def alloc_mask_keys(self, keys, cfg: Optional[MapConfig] = None):
        """Filter allocation candidates against the eviction bitmask
        (isSDFBlockStreamedOut, CUDASceneRepHashSDF.cu:149-156)."""
        cfg = cfg or self.cfg
        lin = key_to_chunk_linear(keys, cfg, self.scfg)
        word = self.bitmask[lin // 32]
        bit = (word >> (lin % 32).astype(jnp.uint32)) & 1
        return jnp.where(bit == 1, INVALID_KEY, keys)


class AsyncStreamingManager(StreamingManager):
    """Overlapped streaming — the reference's producer/consumer streaming
    thread (CUDASceneRepChunkGrid.cpp:8-29, .h:661-673) re-expressed for an
    async-dispatch runtime:

    * the device halves (select / extract / delete, mass-insert, bitmask
      delta) are dispatched into the frame's async program stream and never
      block the host loop — no ``int(count)`` sync, no padded-array D2H;
    * the host halves (payload D2H, chunk-store filing, refiling of
      unplaced insertions) run on ONE worker thread (the streaming thread),
      overlapped with the next frame's compute;
    * the eviction bitmask is **delta-updated on device**: evicted keys'
      chunk bits are set by a sorted-unique scatter-add of disjoint bits
      (add == OR once each (word,bit) appears exactly once) + a full-word
      OR; fully-popped chunks clear their bits via a tiny uploaded id list
      — never a full host rebuild/re-upload (the reference re-uploads the
      whole bitmask every frame, ChunkGrid.h:306-309);
    * only the true row count crosses the PCIe link: the worker slices
      the padded arrays to the next power of two before the D2H (bounded
      set of compiled slice programs).

    One-frame-lag contract: blocks evicted at frame N become poppable at
    frame N+1 or later (after the worker files them), but their chunk bits
    are set at frame N *synchronously in dispatch order*, so the allocator
    can never re-allocate evicted space in the gap.
    """

    _SETQ_PAD = 256          # uploaded set/clear id list length per apply

    def __init__(self, cfg: MapConfig, scfg: StreamingConfig,
                 out_cap: int = 4096):
        super().__init__(cfg, scfg, out_cap)
        import queue as _queue
        import concurrent.futures as _fut
        self._pool = _fut.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="streaming")
        self._store_lock = __import__("threading").Lock()
        self._setq: "_queue.SimpleQueue[np.ndarray]" = _queue.SimpleQueue()
        self._pending = []
        self._err: Optional[BaseException] = None
        g = scfg.grid_dim
        self._nwords = (g * g * g + 31) // 32
        nb32 = self._nwords * 32

        def _extract(state, pool_idx):
            return extract_blocks(state, pool_idx)

        def _del_n(state, idx, count):
            mask = jnp.arange(out_cap) < count
            return blockmap.delete_blocks(state, idx, mask, cfg)

        def _bit_out(bitmask, keys):
            # chunk ids of evicted keys; INVALID -> out-of-range sentinel
            lin = key_to_chunk_linear(keys, cfg, scfg)
            lin = jnp.where(keys == INVALID_KEY, nb32, lin)
            # dedup so scatter-ADD of single bits is exactly OR
            lin_s = jnp.sort(lin)
            first = jnp.concatenate([jnp.ones((1,), bool),
                                     lin_s[1:] != lin_s[:-1]])
            ok = first & (lin_s < nb32)
            word = jnp.where(ok, lin_s // 32, self._nwords)
            bit = (jnp.uint32(1)
                   << (lin_s % 32).astype(jnp.uint32))
            delta = jnp.zeros((self._nwords,), jnp.uint32).at[word].add(
                jnp.where(ok, bit, 0), mode="drop")
            return bitmask | delta

        def _bit_lin(bitmask, set_lin, clear_lin):
            # ids are host-deduped; sentinel nb32 pads -> dropped
            def delta_of(lin):
                ok = lin < nb32
                word = jnp.where(ok, lin // 32, self._nwords)
                bit = jnp.uint32(1) << (lin % 32).astype(jnp.uint32)
                return jnp.zeros((self._nwords,), jnp.uint32).at[word].add(
                    jnp.where(ok, bit, 0), mode="drop")
            return (bitmask | delta_of(set_lin)) & ~delta_of(clear_lin)

        self._extract_j = jax.jit(_extract)
        self._del_n_j = jax.jit(_del_n)
        self._bit_out_j = jax.jit(_bit_out)
        self._bit_lin_j = jax.jit(_bit_lin)

    # -- host-side chunk linearisation (mirror of chunk_linear) ------------
    def _lin_of_chunks(self, coords: np.ndarray) -> np.ndarray:
        g = self.scfg.grid_dim
        half = g // 2
        c = np.clip(coords + half, 0, g - 1)
        return ((c[:, 2] * g + c[:, 1]) * g + c[:, 0]).astype(np.int32)

    def _lin_of_keys(self, keys: np.ndarray) -> np.ndarray:
        wb = self.cfg.world_blocks
        half = wb // 2
        k = keys.astype(np.int64)
        b = np.stack([k % wb - half, (k // wb) % wb - half,
                      k // (wb * wb) - half], axis=1)
        return self._lin_of_chunks(b // self._bpc)

    # -- worker halves -----------------------------------------------------
    def _worker_file(self, count, keys, sdf, w, c):
        try:
            n = int(count)                      # blocks on the device queue
            if n == 0:
                return
            m = 1
            while m < n:
                m *= 2
            m = min(m, self.out_cap)
            kh = np.asarray(keys[:m])[:n]       # bucketed static-shape D2H
            sh = np.asarray(sdf[:m])[:n]
            wh = np.asarray(w[:m])[:n]
            ch = np.asarray(c[:m])[:n]
            with self._store_lock:
                self.store.file_blocks(kh, sh, wh, ch)
        except BaseException as e:              # surfaced at next step/flush
            self._err = e

    def _worker_refile(self, n, placed, keys, sdf, w, c):
        try:
            pl = np.asarray(placed)[:n]
            un = ~pl
            if not un.any():
                return
            with self._store_lock:
                self.store.file_blocks(keys[un], sdf[un], w[un], c[un])
            # the refiled chunks must re-assert their eviction bits
            self._setq.put(np.unique(self._lin_of_keys(keys[un])))
        except BaseException as e:
            self._err = e

    def _drain_set_queue(self) -> np.ndarray:
        ids = []
        while True:
            try:
                ids.append(self._setq.get_nowait())
            except Exception:
                break
        return (np.unique(np.concatenate(ids)) if ids
                else np.zeros((0,), np.int32))

    # -- per-frame overlapped step ----------------------------------------
    def step(self, state: MapState, cam_pos) -> MapState:
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        self._pending = [f for f in self._pending if not f.done()]
        nb32 = self._nwords * 32

        # ---- stream-out: all device dispatch, host work to the worker ----
        out_idx, keys, count = self._sel(
            state, jnp.asarray(np.asarray(cam_pos), jnp.float32), self._part)
        self._part = (self._part + 1) % self.scfg.out_parts
        sdf, w, c = self._extract_j(state, out_idx)   # gathers pre-delete
        state = self._del_n_j(state, out_idx, count)
        self.bitmask = self._bit_out_j(self.bitmask, keys)
        self._pending.append(self._pool.submit(
            self._worker_file, count, keys, sdf, w, c))

        # ---- stream-in: host pop (cheap, native) + device insert ---------
        with self._store_lock:
            k_in, s_in, w_in, c_in, cleared = self.store.pop_in_sphere_tracked(
                np.asarray(cam_pos, np.float32), self.scfg.radius,
                self.scfg.chunk_size, self.scfg.in_chunks_per_frame,
                cap=self.out_cap)
        set_ids = self._drain_set_queue()
        clear_ids = (self._lin_of_chunks(cleared) if len(cleared)
                     else np.zeros((0,), np.int32))
        if len(set_ids) or len(clear_ids):
            P = self._SETQ_PAD
            for off in range(0, max(len(set_ids), len(clear_ids), 1), P):
                sl = set_ids[off:off + P]
                cl = clear_ids[off:off + P]
                self.bitmask = self._bit_lin_j(
                    self.bitmask,
                    jnp.asarray(np.pad(sl, (0, P - len(sl)),
                                       constant_values=nb32)),
                    jnp.asarray(np.pad(cl, (0, P - len(cl)),
                                       constant_values=nb32)))
        n = len(k_in)
        if n:
            pad = self.out_cap - n
            state, _, placed = self._ins(
                state,
                jnp.asarray(np.pad(k_in, (0, pad),
                                   constant_values=INVALID_KEY)),
                jnp.asarray(np.pad(s_in, ((0, pad), (0, 0)))),
                jnp.asarray(np.pad(w_in, ((0, pad), (0, 0)))),
                jnp.asarray(np.pad(c_in, ((0, pad), (0, 0)))))
            self._pending.append(self._pool.submit(
                self._worker_refile, n, placed, k_in, s_in, w_in, c_in))
        return state

    def flush(self):
        """Join the streaming thread (end of run / before whole-map ops)."""
        for f in list(self._pending):
            f.result()
        self._pending = []
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        set_ids = self._drain_set_queue()
        if len(set_ids):
            P = self._SETQ_PAD
            nb32 = self._nwords * 32
            for off in range(0, len(set_ids), P):
                sl = set_ids[off:off + P]
                self.bitmask = self._bit_lin_j(
                    self.bitmask,
                    jnp.asarray(np.pad(sl, (0, P - len(sl)),
                                       constant_values=nb32)),
                    jnp.full((P,), nb32, jnp.int32))

    def stream_out_all(self, state: MapState) -> MapState:
        self.flush()
        state = super().stream_out_all(state)
        self.flush()
        return state

    def stream_in_all(self, state: MapState) -> MapState:
        self.flush()
        return super().stream_in_all(state)

    def host_block_count(self) -> int:
        with self._store_lock:
            return self.store.block_count()


# ---------------------------------------------------------------------------
# Checkpoint: whole-map save / load (ChunkGrid.h:456-548)
# ---------------------------------------------------------------------------

CHECKPOINT_VERSION = 1


def resident_rows(state: MapState, cfg: MapConfig
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host copies of every device-resident block's (keys, sdf f32,
    weight f32, color u32) rows."""
    active_idx, n = blockmap.compactify_all(state, cfg)
    n = int(n)
    idx = active_idx[:max(n, 1)]
    keys = np.asarray(state.block_key[idx])[:n]
    sdf = np.asarray(state.sdf[idx], np.float32)[:n]
    weight = np.asarray(state.weight[idx], np.float32)[:n]
    color = np.asarray(state.color[idx])[:n]
    return keys, sdf, weight, color


def save_map(path: str, state: MapState, cfg: MapConfig,
             poses: Optional[np.ndarray] = None, manager=None) -> int:
    """Serialize every allocated block (+ optional trajectory) to ``path``.

    Versioned with geometry parameters, like the reference's hashgrid file
    ('N' key -> saveToFile, validated on load :526-536). Returns the block
    count written.

    With ``manager`` (a StreamingManager), the checkpoint COMPOSES the
    device-resident rows with the host chunk store, so a streamed run's
    checkpoint holds the whole map — the reference achieves the same by
    streaming everything out and serializing the host grid
    (CUDASceneRepChunkGrid.h:456-548); here residency is untouched.
    """
    keys, sdf, weight, color = resident_rows(state, cfg)
    if manager is not None:
        if hasattr(manager, "flush"):
            manager.flush()
        hk, hs, hw, hc = manager.store.peek_chunks(
            manager.store.chunk_coords())
        if len(hk):
            # the eviction bitmask guarantees a block is resident XOR
            # hosted; a violated invariant must fail loudly, not produce
            # a checkpoint with duplicate keys
            dup = np.intersect1d(keys, hk)
            if len(dup):
                raise RuntimeError(
                    f"save_map: {len(dup)} blocks both device-resident and "
                    f"host-stored (streaming invariant violated)")
            keys = np.concatenate([keys, hk])
            sdf = np.concatenate([sdf, hs])
            weight = np.concatenate([weight, hw])
            color = np.concatenate([color, hc])
    # checkpoints stay f32 on disk (np.savez has no bf16; also keeps the
    # format stable across POOL_DTYPE choices)
    np.savez_compressed(
        path, version=CHECKPOINT_VERSION,
        voxel_size=cfg.voxel_size, truncation=cfg.truncation,
        world_blocks=cfg.world_blocks,
        keys=keys, sdf=sdf, weight=weight, color=color,
        poses=poses if poses is not None else np.zeros((0, 4, 4)))
    return len(keys)


def load_map(path: str, cfg: MapConfig, manager=None
             ) -> Tuple[MapState, np.ndarray]:
    """Rebuild a map from a checkpoint; validates version + geometry
    (loadFromFile 'B', ChunkGrid.h:499-548 — unlike the reference, the
    loaded map remains fully trackable/integrable).

    With ``manager``, the checkpoint loads INTO THE HOST CHUNK STORE (the
    reference's load-then-stream-in sequence): the device map starts empty,
    the eviction bitmask covers every loaded chunk, and the per-frame
    stream-in sphere (or :meth:`StreamingManager.stream_in_all`) brings
    blocks on device — so checkpoints larger than the device pool load
    fine.
    """
    z = np.load(path)
    if int(z["version"]) != CHECKPOINT_VERSION:
        raise ValueError(f"checkpoint version {z['version']} unsupported")
    if (abs(float(z["voxel_size"]) - cfg.voxel_size) > 1e-9
            or int(z["world_blocks"]) != cfg.world_blocks):
        raise ValueError("checkpoint geometry parameters mismatch")
    state = blockmap.create(cfg)
    keys = z["keys"]
    n = len(keys)
    if manager is not None:
        if hasattr(manager, "flush"):
            manager.flush()
        if manager.store.block_count():
            raise ValueError("load_map(manager=...): host store not empty")
        if n:
            manager.store.file_blocks(keys, z["sdf"], z["weight"],
                                      z["color"])
        manager._rebuild_bitmask()
        return state, z["poses"]
    if n == 0:
        return state, z["poses"]
    if n > cfg.num_blocks:
        raise ValueError(f"checkpoint has {n} blocks > pool {cfg.num_blocks}")
    ins = jax.jit(lambda s, k, sd, w, c: insert_blocks(s, k, sd, w, c, cfg))
    state, _, placed = ins(state, jnp.asarray(keys), jnp.asarray(z["sdf"]),
                           jnp.asarray(z["weight"]), jnp.asarray(z["color"]))
    n_lost = n - int(np.asarray(placed).sum())
    if n_lost:
        raise ValueError(
            f"checkpoint load failed to place {n_lost} blocks "
            f"(pool/table too small for this checkpoint)")
    return state, z["poses"]
