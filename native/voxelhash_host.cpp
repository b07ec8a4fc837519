// Native host runtime for voxelhashing_tpu.
//
// The reference keeps its host-side machinery in C++ (the chunk grid's CPU
// half, CUDASceneRepChunkGrid.h:152-753; mLib's mesh merge + MeshIO used by
// CUDAMarchingCubesHashSDF.cpp:88-143).  This library is this engine's
// native equivalent: a voxel-block chunk store for HBM<->host streaming and
// a vertex-welding PLY mesh writer, exposed through a C ABI consumed via
// ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -shared -fPIC -o libvoxelhash_host.so voxelhash_host.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kVoxelsPerBlock = 512;
constexpr uint32_t kStoreVersion = 1;

struct Block {
    int32_t key;
    float sdf[kVoxelsPerBlock];
    float weight[kVoxelsPerBlock];
    uint32_t color[kVoxelsPerBlock];
};

struct ChunkKey {
    int32_t x, y, z;
    bool operator==(const ChunkKey& o) const {
        return x == o.x && y == o.y && z == o.z;
    }
};

struct ChunkKeyHash {
    size_t operator()(const ChunkKey& k) const {
        // Teschner spatial hash (the reference's chunk dedup hash,
        // CUDASceneRepChunkGrid.h:53-65)
        return (size_t)((k.x * 73856093) ^ (k.y * 19349669) ^
                        (k.z * 83492791));
    }
};

struct ChunkStore {
    // geometry: blocks per chunk edge, world extent for key unpacking
    int32_t blocks_per_chunk;
    int32_t world_blocks;
    std::unordered_map<ChunkKey, std::vector<Block>, ChunkKeyHash> chunks;

    ChunkKey chunk_of_key(int32_t key) const {
        int32_t half = world_blocks / 2;
        int32_t gx = key % world_blocks;
        int32_t gy = (key / world_blocks) % world_blocks;
        int32_t gz = key / (world_blocks * world_blocks);
        int32_t bx = gx - half, by = gy - half, bz = gz - half;
        auto fdiv = [](int32_t a, int32_t b) {
            return (a >= 0) ? a / b : -((-a + b - 1) / b);
        };
        return ChunkKey{fdiv(bx, blocks_per_chunk),
                        fdiv(by, blocks_per_chunk),
                        fdiv(bz, blocks_per_chunk)};
    }
};

}  // namespace

extern "C" {

void* chunkstore_create(int32_t blocks_per_chunk, int32_t world_blocks) {
    auto* s = new ChunkStore();
    s->blocks_per_chunk = blocks_per_chunk;
    s->world_blocks = world_blocks;
    return s;
}

void chunkstore_destroy(void* h) { delete static_cast<ChunkStore*>(h); }

// File n evicted blocks into their chunks (integrateInChunkGrid,
// ChunkGrid.cpp:126-153).
void chunkstore_file_blocks(void* h, const int32_t* keys, const float* sdf,
                            const float* weight, const uint32_t* color,
                            int32_t n) {
    auto* s = static_cast<ChunkStore*>(h);
    for (int32_t i = 0; i < n; ++i) {
        Block b;
        b.key = keys[i];
        std::memcpy(b.sdf, sdf + (size_t)i * kVoxelsPerBlock,
                    sizeof(b.sdf));
        std::memcpy(b.weight, weight + (size_t)i * kVoxelsPerBlock,
                    sizeof(b.weight));
        std::memcpy(b.color, color + (size_t)i * kVoxelsPerBlock,
                    sizeof(b.color));
        s->chunks[s->chunk_of_key(b.key)].push_back(b);
    }
}

int64_t chunkstore_block_count(void* h) {
    auto* s = static_cast<ChunkStore*>(h);
    int64_t n = 0;
    for (auto& kv : s->chunks) n += (int64_t)kv.second.size();
    return n;
}

int32_t chunkstore_chunk_count(void* h) {
    return (int32_t)static_cast<ChunkStore*>(h)->chunks.size();
}

// Pop up to max_chunks whole chunks that pass the conservative
// whole-chunk-in-sphere test (isChunkInSphere, ChunkGrid.h:317-346).
// Returns the number of blocks written into the out arrays (capacity cap).
// ``cleared`` (optional, [3*max_chunks] int32): receives the chunk coords
// of chunks removed ENTIRELY (not split) — the host tells the device which
// eviction-bitmask bits to clear, instead of a full rebuild each frame.
int32_t chunkstore_pop_in_sphere(void* h, float cx, float cy, float cz,
                                 float radius, float chunk_size_world,
                                 int32_t max_chunks, int32_t cap,
                                 int32_t* keys, float* sdf, float* weight,
                                 uint32_t* color, int32_t* cleared,
                                 int32_t* n_cleared) {
    auto* s = static_cast<ChunkStore*>(h);
    const float half_diag = 0.866025404f * chunk_size_world;
    int32_t n_out = 0, popped = 0;
    std::vector<ChunkKey> to_erase;
    for (auto& kv : s->chunks) {
        if (popped >= max_chunks) break;
        const ChunkKey& ck = kv.first;
        float mx = (ck.x + 0.5f) * chunk_size_world;
        float my = (ck.y + 0.5f) * chunk_size_world;
        float mz = (ck.z + 0.5f) * chunk_size_world;
        float d = std::sqrt((mx - cx) * (mx - cx) + (my - cy) * (my - cy) +
                            (mz - cz) * (mz - cz));
        if (d + half_diag >= radius) continue;
        // A chunk that alone exceeds the transfer cap must SPLIT rather
        // than be skipped forever (starvation edge): take `cap - n_out`
        // blocks now, keep the remainder filed for later calls.
        int32_t take = (int32_t)kv.second.size();
        bool partial = false;
        if (n_out + take > cap) {
            take = cap - n_out;
            if (take <= 0) continue;
            partial = true;
        }
        for (int32_t i = 0; i < take; ++i) {
            const Block& b = kv.second[kv.second.size() - 1 - i];
            keys[n_out] = b.key;
            std::memcpy(sdf + (size_t)n_out * kVoxelsPerBlock, b.sdf,
                        sizeof(b.sdf));
            std::memcpy(weight + (size_t)n_out * kVoxelsPerBlock, b.weight,
                        sizeof(b.weight));
            std::memcpy(color + (size_t)n_out * kVoxelsPerBlock, b.color,
                        sizeof(b.color));
            ++n_out;
        }
        if (partial) {
            kv.second.resize(kv.second.size() - take);
        } else {
            to_erase.push_back(ck);
        }
        ++popped;
    }
    if (cleared && n_cleared) {
        int32_t m = 0;
        for (const auto& ck : to_erase) {
            cleared[3 * m] = ck.x;
            cleared[3 * m + 1] = ck.y;
            cleared[3 * m + 2] = ck.z;
            ++m;
        }
        *n_cleared = m;
    }
    for (const auto& ck : to_erase) s->chunks.erase(ck);
    return n_out;
}

// List occupied chunk COORDS [3*cap] (non-popping; for whole-map
// composition: meshing / checkpoint under streaming). Returns count.
int32_t chunkstore_chunk_coords(void* h, int32_t* out, int32_t cap) {
    auto* s = static_cast<ChunkStore*>(h);
    int32_t n = 0;
    for (auto& kv : s->chunks) {
        if (n >= cap) break;
        out[3 * n] = kv.first.x;
        out[3 * n + 1] = kv.first.y;
        out[3 * n + 2] = kv.first.z;
        ++n;
    }
    return n;
}

// Total number of blocks held by the given chunks (peek sizing).
int64_t chunkstore_peek_count(void* h, const int32_t* coords,
                              int32_t n_chunks) {
    auto* s = static_cast<ChunkStore*>(h);
    int64_t n = 0;
    for (int32_t i = 0; i < n_chunks; ++i) {
        auto it = s->chunks.find(ChunkKey{coords[3 * i], coords[3 * i + 1],
                                          coords[3 * i + 2]});
        if (it != s->chunks.end()) n += (int64_t)it->second.size();
    }
    return n;
}

// Copy (WITHOUT removing) every block of the given chunks — the read half
// of the reference's stream-in-chunk-neighborhood loop
// (CUDAMarchingCubesHashSDF.cpp:147-190) without mutating residency.
int32_t chunkstore_peek_chunks(void* h, const int32_t* coords,
                               int32_t n_chunks, int32_t* keys, float* sdf,
                               float* weight, uint32_t* color, int32_t cap) {
    auto* s = static_cast<ChunkStore*>(h);
    int32_t n = 0;
    for (int32_t i = 0; i < n_chunks; ++i) {
        auto it = s->chunks.find(ChunkKey{coords[3 * i], coords[3 * i + 1],
                                          coords[3 * i + 2]});
        if (it == s->chunks.end()) continue;
        for (const Block& b : it->second) {
            if (n >= cap) return n;
            keys[n] = b.key;
            std::memcpy(sdf + (size_t)n * kVoxelsPerBlock, b.sdf,
                        sizeof(b.sdf));
            std::memcpy(weight + (size_t)n * kVoxelsPerBlock, b.weight,
                        sizeof(b.weight));
            std::memcpy(color + (size_t)n * kVoxelsPerBlock, b.color,
                        sizeof(b.color));
            ++n;
        }
    }
    return n;
}

// List linear chunk ids currently held (for the device eviction bitmask).
int32_t chunkstore_chunk_ids(void* h, int32_t grid_dim, int32_t* out,
                             int32_t cap) {
    auto* s = static_cast<ChunkStore*>(h);
    int32_t half = grid_dim / 2, n = 0;
    for (auto& kv : s->chunks) {
        if (n >= cap) break;
        auto clampi = [&](int32_t v) {
            v += half;
            if (v < 0) v = 0;
            if (v >= grid_dim) v = grid_dim - 1;
            return v;
        };
        out[n++] = (clampi(kv.first.z) * grid_dim + clampi(kv.first.y)) *
                       grid_dim + clampi(kv.first.x);
    }
    return n;
}

// Versioned binary serialization (saveToFile/loadFromFile,
// ChunkGrid.h:456-548).
int32_t chunkstore_save(void* h, const char* path) {
    auto* s = static_cast<ChunkStore*>(h);
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    uint32_t version = kStoreVersion;
    std::fwrite(&version, 4, 1, f);
    std::fwrite(&s->blocks_per_chunk, 4, 1, f);
    std::fwrite(&s->world_blocks, 4, 1, f);
    uint32_t n_chunks = (uint32_t)s->chunks.size();
    std::fwrite(&n_chunks, 4, 1, f);
    for (auto& kv : s->chunks) {
        std::fwrite(&kv.first, sizeof(ChunkKey), 1, f);
        uint32_t n = (uint32_t)kv.second.size();
        std::fwrite(&n, 4, 1, f);
        std::fwrite(kv.second.data(), sizeof(Block), n, f);
    }
    std::fclose(f);
    return 0;
}

int32_t chunkstore_load(void* h, const char* path) {
    auto* s = static_cast<ChunkStore*>(h);
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    uint32_t version = 0;
    if (std::fread(&version, 4, 1, f) != 1 || version != kStoreVersion) {
        std::fclose(f);
        return -2;
    }
    std::fread(&s->blocks_per_chunk, 4, 1, f);
    std::fread(&s->world_blocks, 4, 1, f);
    uint32_t n_chunks = 0;
    std::fread(&n_chunks, 4, 1, f);
    s->chunks.clear();
    for (uint32_t c = 0; c < n_chunks; ++c) {
        ChunkKey ck;
        uint32_t n = 0;
        if (std::fread(&ck, sizeof(ChunkKey), 1, f) != 1) break;
        std::fread(&n, 4, 1, f);
        auto& vec = s->chunks[ck];
        vec.resize(n);
        if (std::fread(vec.data(), sizeof(Block), n, f) != n) break;
    }
    std::fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// Mesh: vertex weld + binary PLY writer (mLib merge + MeshIO analog)
// ---------------------------------------------------------------------------

// Welds duplicate vertices of a triangle soup (quantised by eps) and writes
// a binary little-endian PLY with optional uchar colors.
// tris: [n_tris*9] floats (xyz per corner); colors: [n_tris*9] floats in
// [0,1] or null. Returns the face count, or <0 on error.
int64_t mesh_weld_save_ply(const char* path, const float* tris,
                           const float* colors, int64_t n_tris, float eps) {
    struct QKey {
        int64_t x, y, z;
        bool operator==(const QKey& o) const {
            return x == o.x && y == o.y && z == o.z;
        }
    };
    struct QHash {
        size_t operator()(const QKey& k) const {
            return (size_t)((k.x * 73856093LL) ^ (k.y * 19349669LL) ^
                            (k.z * 83492791LL));
        }
    };
    std::unordered_map<QKey, uint32_t, QHash> index;
    index.reserve((size_t)n_tris * 2);
    std::vector<float> verts;
    std::vector<uint8_t> vcols;
    std::vector<uint32_t> faces;
    verts.reserve((size_t)n_tris * 3);
    faces.reserve((size_t)n_tris * 3);
    const bool has_color = colors != nullptr;

    for (int64_t t = 0; t < n_tris; ++t) {
        uint32_t idx[3];
        for (int c = 0; c < 3; ++c) {
            const float* p = tris + (size_t)t * 9 + c * 3;
            QKey k{(int64_t)std::llround(p[0] / eps),
                   (int64_t)std::llround(p[1] / eps),
                   (int64_t)std::llround(p[2] / eps)};
            auto it = index.find(k);
            if (it == index.end()) {
                uint32_t vi = (uint32_t)(verts.size() / 3);
                index.emplace(k, vi);
                verts.insert(verts.end(), p, p + 3);
                if (has_color) {
                    const float* col = colors + (size_t)t * 9 + c * 3;
                    for (int j = 0; j < 3; ++j) {
                        float v = col[j] * 255.0f;
                        v = v < 0 ? 0 : (v > 255 ? 255 : v);
                        vcols.push_back((uint8_t)v);
                    }
                }
                idx[c] = vi;
            } else {
                idx[c] = it->second;
            }
        }
        if (idx[0] != idx[1] && idx[1] != idx[2] && idx[0] != idx[2]) {
            faces.insert(faces.end(), idx, idx + 3);
        }
    }

    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    uint32_t n_verts = (uint32_t)(verts.size() / 3);
    uint32_t n_faces = (uint32_t)(faces.size() / 3);
    std::fprintf(f, "ply\nformat binary_little_endian 1.0\n");
    std::fprintf(f, "element vertex %u\n", n_verts);
    std::fprintf(f, "property float x\nproperty float y\nproperty float z\n");
    if (has_color) {
        std::fprintf(f,
                     "property uchar red\nproperty uchar green\n"
                     "property uchar blue\n");
    }
    std::fprintf(f, "element face %u\n", n_faces);
    std::fprintf(f, "property list uchar int vertex_indices\nend_header\n");
    for (uint32_t v = 0; v < n_verts; ++v) {
        std::fwrite(&verts[(size_t)v * 3], 4, 3, f);
        if (has_color) std::fwrite(&vcols[(size_t)v * 3], 1, 3, f);
    }
    for (uint32_t t = 0; t < n_faces; ++t) {
        uint8_t three = 3;
        std::fwrite(&three, 1, 1, f);
        int32_t tri[3] = {(int32_t)faces[(size_t)t * 3],
                          (int32_t)faces[(size_t)t * 3 + 1],
                          (int32_t)faces[(size_t)t * 3 + 2]};
        std::fwrite(tri, 4, 3, f);
    }
    std::fclose(f);
    return (int64_t)n_faces;
}

// ---------------------------------------------------------------------------
// OCCI depth codec (TYPE_OCCI_USHORT — the reference's default .sens depth
// codec, sensorData.h:1027-1028; bitstream grammar documented at
// uplinksimple_image-codecs.h:160-176).  Clean-room implementation of the
// documented grammar; the pure-Python version in io/sensfile.py is the
// portable reference (bit-identical, differential-tested) but runs at
// ~0.5 s per 640x480 frame — this is the real-time data-loader path.
//
//   00                 next value == last
//   11 / 10            next == last +1 / -1
//   010 bbbbb          next (N+5) values == last        (N in 5 bits)
//   01101 / 01100      next == last +2 / -2
//   0111 bbbbbbbbbbb   next == X                        (X in 11 bits)
//
// MSB-first bit order within bytes (matches the reference's bitstream_t).
// Encode masks literals to 11 bits AND tracks the masked value as `last`
// so encoder and decoder state never diverge (the reference's encoder
// tracks the unmasked value and silently desyncs above 2047 — see the
// sensfile.py module docstring; values >2047 are out of the codec's band
// either way).

extern "C" int occi_decode_u16(const uint8_t* buf, int64_t buf_len,
                               uint16_t* out, int64_t n) {
    int64_t bitpos = 0;
    const int64_t nbits = buf_len * 8;
    auto take = [&](int k) -> uint32_t {
        uint32_t v = 0;
        for (int i = 0; i < k; ++i) {
            if (bitpos >= nbits) return v << (k - i);
            v = (v << 1) | ((buf[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
            ++bitpos;
        }
        return v;
    };
    uint16_t last = 0;
    int64_t i = 0;
    while (i < n && bitpos < nbits) {
        if (take(1)) {                       // 1x: +/-1
            last = take(1) ? (uint16_t)(last + 1) : (uint16_t)(last - 1);
            out[i++] = last;
        } else if (!take(1)) {               // 00: repeat one
            out[i++] = last;
        } else if (!take(1)) {               // 010: run of repeats
            int64_t run = (int64_t)take(5) + 5;
            if (run > n - i) run = n - i;
            for (int64_t r = 0; r < run; ++r) out[i + r] = last;
            i += run;
        } else if (!take(1)) {               // 0110x: +/-2
            last = take(1) ? (uint16_t)(last + 2) : (uint16_t)(last - 2);
            out[i++] = last;
        } else {                             // 0111: 11-bit literal
            last = (uint16_t)take(11);
            out[i++] = last;
        }
    }
    return i == n ? 0 : -1;
}

namespace {
struct BitWriter {
    uint8_t* buf;
    int64_t cap;
    int64_t bitpos = 0;
    bool overflow = false;
    void put(uint32_t v, int k) {
        if (((bitpos + k + 7) >> 3) > cap) { overflow = true; return; }
        for (int i = k - 1; i >= 0; --i) {
            uint8_t bit = (v >> i) & 1;
            int64_t byte = bitpos >> 3;
            int off = 7 - (int)(bitpos & 7);
            if (bit) buf[byte] |= (uint8_t)(1u << off);
            ++bitpos;
        }
    }
};
}  // namespace

extern "C" int64_t occi_encode_u16(const uint16_t* in, int64_t n,
                                   uint8_t* out, int64_t out_cap) {
    std::memset(out, 0, (size_t)out_cap);
    BitWriter bw{out, out_cap};
    uint16_t last = 0;
    int64_t zeros = 0;
    auto burn = [&]() {
        while (zeros > 0) {
            if (zeros <= 4) {
                for (int64_t z = 0; z < zeros; ++z) bw.put(0, 2);
                zeros = 0;
            } else {
                int64_t enc = zeros - 5;
                if (enc > 31) enc = 31;
                bw.put(0x2, 3);              // 010
                bw.put((uint32_t)enc, 5);
                zeros -= enc + 5;
            }
        }
    };
    for (int64_t i = 0; i < n; ++i) {
        uint16_t cur = in[i];
        int delta = (int)cur - (int)last;
        if (delta == 0) {
            ++zeros;
        } else {
            burn();
            if (delta == 1) bw.put(0x3, 2);          // 11
            else if (delta == -1) bw.put(0x2, 2);    // 10
            else if (delta == 2) bw.put(0xD, 5);     // 01101
            else if (delta == -2) bw.put(0xC, 5);    // 01100
            else {
                bw.put(0x7, 4);                      // 0111
                cur = (uint16_t)(cur & 0x7FF);
                bw.put(cur, 11);
            }
        }
        last = cur;
    }
    burn();
    if (bw.overflow) return -1;
    return (bw.bitpos + 7) >> 3;
}

}  // extern "C"
