"""Out-of-core streaming for the SHARDED engine: map parallelism × tiering.

Composes the two scaling axes the framework adds over the reference:
hash-partitioned map sharding over a device mesh (parallel/sharded.py)
and HBM↔host-DRAM chunk tiering (streaming.py — the re-derivation of
CUDASceneRepChunkGrid). Each device sweeps and evicts only the blocks it
OWNS (its hash partition), all devices in one shard_map program per half;
the host files every device's evictions into ONE global chunk store, and
stream-in routes each chunk's blocks back to their owner device by the
same partition hash the allocator uses (sharded._owned) — so a block's
owner is a pure function of its key and survives the round trip.

Semantics mirror :class:`voxelhashing_tpu.streaming.StreamingManager`
(fractional out-sweeps, ≤k whole chunks in per step, eviction bitmask
consulted by allocation, never-drop re-filing of unplaced payloads).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import MapConfig, StreamingConfig
from .. import blockmap
from ..geometry import INVALID_KEY
from ..streaming import (extract_blocks, insert_blocks, key_to_chunk_linear,
                         make_chunk_store, select_stream_out)
from .sharded import AXIS, ShardedState, local_map_config


def _owner_np(keys: np.ndarray, n_dev: int) -> np.ndarray:
    """Host twin of the device partition hash (blockmap._mix % D)."""
    x = keys.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x7FEB352D)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(0x846CA68B)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    return (x % np.uint32(n_dev)).astype(np.int64)


class ShardedStreamingManager:
    """Host orchestration of per-shard stream-out/in over a device mesh."""

    def __init__(self, cfg: MapConfig, scfg: StreamingConfig, mesh: Mesh,
                 out_cap: int = 1024):
        self.cfg = cfg
        self.scfg = scfg
        self.mesh = mesh
        self.n_dev = n_dev = mesh.devices.size
        self.lcfg = lcfg = local_map_config(cfg, n_dev)
        self.out_cap = out_cap
        bpc = max(1, round(scfg.chunk_size / cfg.block_size_world))
        self.store = make_chunk_store(bpc, cfg.world_blocks)
        self._part = 0
        g = scfg.grid_dim
        self.bitmask = jnp.zeros(((g * g * g + 31) // 32,), jnp.uint32)

        def local_out(mstate_b, cam_pos, part):
            m = jax.tree_util.tree_map(lambda x: x[0], mstate_b)
            idx, keys, count = select_stream_out(m, cam_pos, part, lcfg,
                                                 scfg, out_cap)
            sdf, w, c = extract_blocks(m, idx)
            mask = jnp.arange(out_cap) < count
            m = blockmap.delete_blocks(m, idx, mask, lcfg)
            stack = jax.tree_util.tree_map(lambda x: x[None], m)
            # payloads leave the device in POOL_DTYPE; host stores f32
            return (stack, keys[None], sdf.astype(jnp.float32)[None],
                    w.astype(jnp.float32)[None], c[None], count[None])

        self._out = jax.jit(jax.shard_map(
            local_out, mesh=mesh,
            in_specs=(P(AXIS), P(), P()),
            out_specs=(P(AXIS),) * 6, check_vma=False))

        def local_in(mstate_b, keys_b, sdf_b, w_b, c_b):
            m = jax.tree_util.tree_map(lambda x: x[0], mstate_b)
            m, _, placed = insert_blocks(m, keys_b[0], sdf_b[0], w_b[0],
                                         c_b[0], lcfg)
            return jax.tree_util.tree_map(lambda x: x[None], m), placed[None]

        self._in = jax.jit(jax.shard_map(
            local_in, mesh=mesh,
            in_specs=(P(AXIS),) * 5,
            out_specs=(P(AXIS), P(AXIS)), check_vma=False))

    # -- halves ------------------------------------------------------------

    def _rebuild_bitmask(self):
        g = self.scfg.grid_dim
        words = np.zeros(((g * g * g + 31) // 32,), np.uint32)
        ids = self.store.chunk_ids(g)
        if len(ids):
            np.bitwise_or.at(words, ids // 32,
                             np.uint32(1) << (ids % 32).astype(np.uint32))
        self.bitmask = jnp.asarray(words)

    def stream_out(self, smap, cam_pos) -> Tuple[object, int]:
        """One fractional sweep on EVERY device (each over its own shard);
        file all evictions into the global store."""
        smap, keys, sdf, w, c, counts = self._out(
            smap, jnp.asarray(cam_pos, jnp.float32),
            jnp.int32(self._part))
        self._part = (self._part + 1) % self.scfg.out_parts
        counts = np.asarray(counts)
        total = int(counts.sum())
        if total:
            keys, sdf = np.asarray(keys), np.asarray(sdf)
            w, c = np.asarray(w), np.asarray(c)
            for d in range(self.n_dev):
                n = int(counts[d])
                if n:
                    self.store.file_blocks(keys[d][:n], sdf[d][:n],
                                           w[d][:n], c[d][:n])
            self._rebuild_bitmask()
        return smap, total

    def stream_in(self, smap, cam_pos, radius=None,
                  max_chunks=None) -> Tuple[object, int]:
        """Pop ≤in_chunks_per_frame chunks inside the sphere, route every
        block to its owner device, mass-insert in one shard_map call."""
        keys, sdf, w, c = self.store.pop_in_sphere(
            np.asarray(cam_pos, np.float32),
            self.scfg.radius if radius is None else radius,
            self.scfg.chunk_size,
            self.scfg.in_chunks_per_frame if max_chunks is None
            else max_chunks,
            cap=self.out_cap)
        n = len(keys)
        if n == 0:
            return smap, 0
        owner = _owner_np(keys, self.n_dev)
        cap = self.out_cap
        kd = np.full((self.n_dev, cap), INVALID_KEY, np.int32)
        sd = np.zeros((self.n_dev, cap, sdf.shape[1]), np.float32)
        wd = np.zeros_like(sd)
        cd = np.zeros((self.n_dev, cap, sdf.shape[1]), np.uint32)
        spill = np.zeros(n, bool)     # per-device overflow -> re-file
        for d in range(self.n_dev):
            sel = np.flatnonzero(owner == d)
            if len(sel) > cap:
                spill[sel[cap:]] = True
                sel = sel[:cap]
            kd[d, :len(sel)] = keys[sel]
            sd[d, :len(sel)] = sdf[sel]
            wd[d, :len(sel)] = w[sel]
            cd[d, :len(sel)] = c[sel]
        smap, placed = self._in(smap, jnp.asarray(kd), jnp.asarray(sd),
                                jnp.asarray(wd), jnp.asarray(cd))
        placed = np.asarray(placed)
        # never drop a streamed-in payload: re-file per-device overflow
        # and any insert the allocator failed to place
        refile = spill.copy()
        for d in range(self.n_dev):
            sel = np.flatnonzero((owner == d) & ~spill)
            bad = sel[~placed[d][:len(sel)]]
            refile[bad] = True
        n_lost = int(refile.sum())
        if n_lost:
            self.store.file_blocks(keys[refile], sdf[refile], w[refile],
                                   c[refile])
        self._rebuild_bitmask()
        return smap, n - n_lost

    def step(self, state: ShardedState, cam_pos) -> ShardedState:
        """One streaming epoch (out then in) on the sharded engine state."""
        m, _ = self.stream_out(state.map, cam_pos)
        m, _ = self.stream_in(m, cam_pos)
        return state._replace(map=m)

    def stream_out_all(self, smap):
        """Evict every shard fully (streamOutToCPUAll analog)."""
        far = np.asarray([1e12, 1e12, 1e12], np.float32)
        for _ in range(self.scfg.out_parts):
            smap, _ = self.stream_out(smap, far)
        return smap

    def stream_in_all(self, smap):
        """Bring every host-stored block back to its owner shard (the
        inverse of stream_out_all; whole-map ops). The per-shard pools must
        hold the partitioned map."""
        origin = np.zeros((3,), np.float32)
        stall = 0
        while self.store.block_count() > 0:
            before = self.store.block_count()
            smap, _ = self.stream_in(smap, origin, radius=1e15,
                                     max_chunks=1 << 30)
            stall = stall + 1 if self.store.block_count() >= before else 0
            if stall >= 3:
                raise RuntimeError(
                    f"stream_in_all: shard pools cannot hold the map "
                    f"({self.store.block_count()} blocks still hosted)")
        self._rebuild_bitmask()
        return smap

    def host_block_count(self) -> int:
        return self.store.block_count()

    def alloc_mask_keys(self, keys):
        """Eviction-bitmask candidate filter (isSDFBlockStreamedOut)."""
        lin = key_to_chunk_linear(keys, self.cfg, self.scfg)
        word = self.bitmask[lin // 32]
        bit = (word >> (lin % 32).astype(jnp.uint32)) & 1
        return jnp.where(bit == 1, INVALID_KEY, keys)
