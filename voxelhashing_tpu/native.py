"""ctypes bindings for the native host runtime (native/voxelhash_host.cpp).

The reference's host-side machinery is C++ (chunk grid CPU half, mLib mesh
merge); this module binds this engine's native equivalents.  The library
is compiled on demand with g++ (no pybind11 in this environment); every
entry point has a pure-Python fallback so the package works without a
toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO_ROOT, "native", "voxelhash_host.cpp")
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "libvoxelhash_host.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             "-o", _LIB_PATH, _SRC],
            check=True, capture_output=True, timeout=300)
        return True
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH)):
            if not os.path.exists(_SRC) or not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.chunkstore_create.restype = ctypes.c_void_p
        lib.chunkstore_create.argtypes = [ctypes.c_int32, ctypes.c_int32]
        lib.chunkstore_destroy.argtypes = [ctypes.c_void_p]
        lib.chunkstore_file_blocks.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
        lib.chunkstore_block_count.restype = ctypes.c_int64
        lib.chunkstore_block_count.argtypes = [ctypes.c_void_p]
        lib.chunkstore_chunk_count.restype = ctypes.c_int32
        lib.chunkstore_chunk_count.argtypes = [ctypes.c_void_p]
        lib.chunkstore_pop_in_sphere.restype = ctypes.c_int32
        lib.chunkstore_pop_in_sphere.argtypes = [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.chunkstore_chunk_ids.restype = ctypes.c_int32
        lib.chunkstore_chunk_ids.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_int32]
        lib.chunkstore_chunk_coords.restype = ctypes.c_int32
        lib.chunkstore_chunk_coords.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
        lib.chunkstore_peek_count.restype = ctypes.c_int64
        lib.chunkstore_peek_count.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
        lib.chunkstore_peek_chunks.restype = ctypes.c_int32
        lib.chunkstore_peek_chunks.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32]
        lib.chunkstore_save.restype = ctypes.c_int32
        lib.chunkstore_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.chunkstore_load.restype = ctypes.c_int32
        lib.chunkstore_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mesh_weld_save_ply.restype = ctypes.c_int64
        lib.mesh_weld_save_ply.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_float]
        lib.occi_decode_u16.restype = ctypes.c_int32
        lib.occi_decode_u16.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64]
        lib.occi_encode_u16.restype = ctypes.c_int64
        lib.occi_encode_u16.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeChunkStore:
    """C++ chunk store (streaming host half). Raises if unavailable."""

    VOXELS = 512

    def __init__(self, blocks_per_chunk: int, world_blocks: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.chunkstore_create(blocks_per_chunk, world_blocks)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.chunkstore_destroy(self._h)
            self._h = None

    def file_blocks(self, keys: np.ndarray, sdf: np.ndarray,
                    weight: np.ndarray, color: np.ndarray):
        n = len(keys)
        if n == 0:
            return
        keys = np.ascontiguousarray(keys, np.int32)
        sdf = np.ascontiguousarray(sdf, np.float32)
        weight = np.ascontiguousarray(weight, np.float32)
        color = np.ascontiguousarray(color, np.uint32)
        self._lib.chunkstore_file_blocks(
            self._h, _ptr(keys), _ptr(sdf), _ptr(weight), _ptr(color), n)

    def block_count(self) -> int:
        return int(self._lib.chunkstore_block_count(self._h))

    def chunk_count(self) -> int:
        return int(self._lib.chunkstore_chunk_count(self._h))

    def pop_in_sphere(self, cam_pos, radius: float, chunk_size_world: float,
                      max_chunks: int, cap: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
        keys, sdf, weight, color, _ = self.pop_in_sphere_tracked(
            cam_pos, radius, chunk_size_world, max_chunks, cap)
        return keys, sdf, weight, color

    def pop_in_sphere_tracked(self, cam_pos, radius: float,
                              chunk_size_world: float, max_chunks: int,
                              cap: int):
        """Like pop_in_sphere, but also returns the chunk coords [m,3] of
        chunks removed entirely (bitmask delta-clear set)."""
        keys = np.zeros((cap,), np.int32)
        sdf = np.zeros((cap, self.VOXELS), np.float32)
        weight = np.zeros((cap, self.VOXELS), np.float32)
        color = np.zeros((cap, self.VOXELS), np.uint32)
        cleared = np.zeros((max(max_chunks, 1) * 3,), np.int32)
        n_cleared = np.zeros((1,), np.int32)
        n = self._lib.chunkstore_pop_in_sphere(
            self._h, float(cam_pos[0]), float(cam_pos[1]),
            float(cam_pos[2]), float(radius), float(chunk_size_world),
            max_chunks, cap, _ptr(keys), _ptr(sdf), _ptr(weight),
            _ptr(color), _ptr(cleared), _ptr(n_cleared))
        m = int(n_cleared[0])
        return (keys[:n], sdf[:n], weight[:n], color[:n],
                cleared[:3 * m].reshape(m, 3))

    def chunk_ids(self, grid_dim: int, cap: int = 1 << 20) -> np.ndarray:
        out = np.zeros((cap,), np.int32)
        n = self._lib.chunkstore_chunk_ids(self._h, grid_dim, _ptr(out), cap)
        return out[:n]

    def chunk_coords(self, cap: int = 1 << 20) -> np.ndarray:
        """Occupied chunk coords [m,3] (non-popping)."""
        out = np.zeros((cap * 3,), np.int32)
        n = self._lib.chunkstore_chunk_coords(self._h, _ptr(out), cap)
        return out[:3 * n].reshape(n, 3)

    def peek_count(self, coords: np.ndarray) -> int:
        """Total blocks held by the given chunks [m,3] (no copy)."""
        coords = np.ascontiguousarray(coords, np.int32).reshape(-1, 3)
        return int(self._lib.chunkstore_peek_count(self._h, _ptr(coords),
                                                   len(coords)))

    def peek_chunks(self, coords: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
        """Copy (without removing) every block of the given chunks [m,3]."""
        coords = np.ascontiguousarray(coords, np.int32).reshape(-1, 3)
        m = len(coords)
        cap = int(self._lib.chunkstore_peek_count(self._h, _ptr(coords), m))
        keys = np.zeros((cap,), np.int32)
        sdf = np.zeros((cap, self.VOXELS), np.float32)
        weight = np.zeros((cap, self.VOXELS), np.float32)
        color = np.zeros((cap, self.VOXELS), np.uint32)
        if cap:
            n = self._lib.chunkstore_peek_chunks(
                self._h, _ptr(coords), m, _ptr(keys), _ptr(sdf),
                _ptr(weight), _ptr(color), cap)
            assert n == cap, (n, cap)
        return keys, sdf, weight, color

    def save(self, path: str):
        if self._lib.chunkstore_save(self._h, path.encode()) != 0:
            raise IOError(f"chunkstore_save failed: {path}")

    def load_file(self, path: str):
        rc = self._lib.chunkstore_load(self._h, path.encode())
        if rc != 0:
            raise IOError(f"chunkstore_load failed ({rc}): {path}")


def weld_save_ply(path: str, triangles: np.ndarray,
                  colors: Optional[np.ndarray], eps: float) -> Optional[int]:
    """Native vertex-weld + PLY write; None if the library is unavailable
    (callers fall back to the Python path in meshing.save_ply)."""
    lib = load()
    if lib is None:
        return None
    tris = np.ascontiguousarray(triangles, np.float32)
    cols = None
    cptr = None
    if colors is not None:
        cols = np.ascontiguousarray(colors, np.float32)
        cptr = _ptr(cols)
    n = lib.mesh_weld_save_ply(path.encode(), _ptr(tris), cptr,
                               len(tris), float(eps))
    if n < 0:
        raise IOError(f"mesh_weld_save_ply failed: {path}")
    return int(n)


def occi_decode(buf: bytes, num_elements: int) -> Optional[np.ndarray]:
    """Native OCCI depth decode (the reference's default .sens codec);
    None if the library is unavailable (io/sensfile.py falls back to its
    bit-identical pure-Python path, ~500x slower)."""
    lib = load()
    if lib is None:
        return None
    out = np.empty(num_elements, np.uint16)
    src = np.frombuffer(buf, np.uint8)
    rc = lib.occi_decode_u16(_ptr(src), len(src), _ptr(out),
                             int(num_elements))
    if rc != 0:
        raise ValueError("occi bitstream truncated")
    return out


def occi_encode(values: np.ndarray) -> Optional[bytes]:
    """Native OCCI depth encode; None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, np.uint16).reshape(-1)
    cap = 2 * v.size + 16
    out = np.zeros(cap, np.uint8)
    n = lib.occi_encode_u16(_ptr(v), v.size, _ptr(out), cap)
    if n < 0:
        raise ValueError("occi encode overflow")
    return out[:n].tobytes()
