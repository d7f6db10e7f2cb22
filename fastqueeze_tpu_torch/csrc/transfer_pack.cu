// The transfer packs: a (T, L) u8 symbol grid <-> 2/4/6-bit packed bytes
// and the sentinel packs, so that grids cross the host<->device link
// packed (they never reach the bitstream).
//
// K15 unpack_grid replaces fastqueeze_tpu/ops/engine.py _unpack2_dev,
//     _unpack4_dev, _unpack6_dev, _unpack15_dev, _unpack23_dev and
//     _unpack_sent_dev: every fused encode and train unpacks its uploaded
//     grid with it.
// K16 pack_grid replaces _pack2_dev, _pack4_dev and _pack6_dev: every
//     fused decode packs its symbols with it before the copy to the host.
// K17 pack15 replaces _pack15_dev: the mode-15 pack of a decoded 6-bit
//     grid (the 15 most frequent valid symbols as nibbles, the rest in an
//     exception list).
//
// Flat slot s = t * L + l of the grid (row-major, L % 4 == 0); the packed
// layouts are the reference's: mode 2 (and 23) byte s/4 holds slot s in
// bits 2(s%4); mode 4 (and 15) byte s/2 in bits 4(s%2); mode 6 the 24-bit
// group s/4 (bytes 3g..3g+2, little end first) in bits 6(s%4).  Modes 15
// and 23 code symbol side[c] as c < sent and, at the sentinel (15 or 3),
// the next value of the exception list side[16:] in grid scan order.
//
// Bounds: all three move a few bytes a slot (K15 0.25-0.75 B in, 1 B out;
// K16 1 B in, 0.25-0.75 B out; K17 1 B in twice, 0.5 B out), so they are
// bound by device memory.  K15 works in groups of 16 slots, a thread a
// group: one 4-byte (modes 2, 23), 8-byte (4, 15) or three 4-byte (6)
// load of the packed bytes, the codes spread into bytes by shifts and
// masks, one 16-byte store of the grid; where a pointer is not aligned
// for those, or the group passes the grid's end, the same kernel loads
// and stores bytes.  Dense modes keep kDenseGroups groups a thread in
// flight.  The sentinel modes need each sentinel's rank in scan order:
// one launch after a memset of a tile ticket and per-tile descriptors;
// a block takes a tile of 8,192 slots (two groups a thread) by atomic
// ticket, counts its sentinels with bit operations on the loaded words
// (a nibble is 15 where all four bits are set, a 2-bit code 3 where both
// are), ranks them by a block scan, takes the tile's offset by the decoupled look-back of
// lookback.cuh (K3's and K17's), stages the tile's run of exceptions
// (clipped as the reference clips a short sidecar's index) and the
// 16-entry top table in shared memory with coalesced loads, and maps its
// slots there.  Tiles of 4,096 slots (a group a thread) took 0.051-0.056
// ms on an H100 at 25.2 M slots, tiles of 8,192 0.040-0.044 (a tile's
// ticket, scan, look-back and staged run are its fixed cost).  The first
// K15 (a thread per 4-slot group, a byte load a
// slot; the sentinel modes in three launches: tile counts, one block
// scanning them, the tiles rescanned and written a byte at a time) took
// 0.04-0.09 ms in mode 2 and 0.17-0.19 ms in modes 15 and 23 on an H100
// at 25.2 M slots.  K16 is one thread per 4-slot group (one 4-byte load
// of the grid, one to three byte stores): on an H100 at 25.2 M slots it
// takes 0.018 / 0.020 / 0.023 ms in modes 2 / 4 / 6, 1.8-1.9x its bytes
// bound (K15's dense shape turned round, 16 slots a thread with word
// stores, took 0.009 / 0.010 / 0.014).  K17 reads the grid twice: a
// histogram pass (pack15_hist), then one write pass (pack15_write) whose
// prologue ranks
// the 64 symbols and whose tiles take their exception offsets from the
// same look-back, so no pass counts the exceptions first.  Its validity
// comes from the lanes' lengths (lane_walk.cuh) beside each slot's wave
// and lane, which the passes step without a division a slot, never from
// a (T, L) mask.  The first K17 (seven launches: the grid read three
// times, the top 15 on one thread, validity by a 64-bit division and
// modulo a slot, 16 bytes a thread read one at a time) took 0.39-0.40 ms
// on an H100 at 25.2 M slots.

#include <cstdint>

#include <cuda_runtime.h>

#include "check.cuh"
#include "lane_walk.cuh"
#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAlpha = 64;                       // 6-bit symbols

// --- K15 ------------------------------------------------------------------

constexpr int kGroup = 16;                       // slots a group
constexpr int kDenseGroups = 4;                  // groups a thread, dense
constexpr int64_t kDenseBlock = int64_t(kThreads) * kDenseGroups * kGroup;
constexpr int kSentGroups = 2;                   // groups a thread, sentinel
constexpr int64_t kSentTile = int64_t(kThreads) * kSentGroups * kGroup;
constexpr int64_t kSentHead = 16;                // the ticket, padded

// Packed bytes of a 16-slot group.
template <int kMode>
__host__ __device__ constexpr int group_bytes() {
    return kMode == 6 ? 12 : (kMode == 4 || kMode == 15) ? 8 : 4;
}

// Group q's packed bytes as little-endian words w[0..2] (0 past them):
// where ``whole`` one 8-byte or one to three 4-byte loads, else byte loads
// of the bytes below n_packed (none past the grid's end).
template <int kMode>
__device__ __forceinline__ void load_group(const uint8_t* __restrict__ packed,
                                           int64_t q, bool whole,
                                           int64_t n_packed, uint32_t w[3]) {
    constexpr int kB = group_bytes<kMode>();
    const int64_t b0 = q * kB;
    w[0] = w[1] = w[2] = 0;
    if (whole) {
        FQK_BOUND("unpack_grid", "packed", b0 + kB - 1, n_packed);
        if (kB == 8) {
            const uint2 v = *reinterpret_cast<const uint2*>(packed + b0);
            w[0] = v.x;
            w[1] = v.y;
        } else {
            const uint32_t* p = reinterpret_cast<const uint32_t*>(packed + b0);
#pragma unroll
            for (int i = 0; i < kB / 4; ++i) w[i] = p[i];
        }
        return;
    }
#pragma unroll
    for (int i = 0; i < kB; ++i)
        if (b0 + i < n_packed)
            w[i / 4] |= uint32_t(packed[b0 + i]) << (8 * (i % 4));
}

// Four 2-bit codes (a byte) -> four bytes.
__device__ __forceinline__ uint32_t spread2(uint32_t b) {
    return (b & 3u) | ((b & 0xCu) << 6) | ((b & 0x30u) << 12)
           | ((b & 0xC0u) << 18);
}

// Four nibbles (16 bits) -> four bytes.
__device__ __forceinline__ uint32_t spread4(uint32_t h) {
    return (h & 0xFu) | ((h & 0xF0u) << 4) | ((h & 0xF00u) << 8)
           | ((h & 0xF000u) << 12);
}

// Four 6-bit symbols (the low 24 bits) -> four bytes.
__device__ __forceinline__ uint32_t spread6(uint32_t v) {
    return (v & 63u) | ((v >> 6) & 63u) << 8 | ((v >> 12) & 63u) << 16
           | ((v >> 18) & 63u) << 24;
}

// A group's 16 codes, one a byte, slot k in byte k % 4 of word k / 4.
template <int kMode>
__device__ __forceinline__ void decode_group(const uint32_t w[3],
                                             uint32_t o[4]) {
    if (kMode == 2 || kMode == 23) {
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = spread2((w[0] >> (8 * j)) & 0xFFu);
    } else if (kMode == 4 || kMode == 15) {
        o[0] = spread4(w[0] & 0xFFFFu);
        o[1] = spread4(w[0] >> 16);
        o[2] = spread4(w[1] & 0xFFFFu);
        o[3] = spread4(w[1] >> 16);
    } else {
        o[0] = spread6(w[0]);
        o[1] = spread6((w[0] >> 24) | (w[1] << 8));
        o[2] = spread6((w[1] >> 16) | (w[2] << 16));
        o[3] = spread6(w[2] >> 8);
    }
}

// A group's 16 bytes at grid[s0 ..): one 16-byte store where ``whole``,
// else the bytes below n.
__device__ __forceinline__ void store_group(uint8_t* __restrict__ grid,
                                            int64_t s0, int64_t n, bool whole,
                                            const uint32_t o[4]) {
    if (whole) {
        FQK_BOUND("unpack_grid", "grid", s0 + kGroup - 1, n);
        *reinterpret_cast<uint4*>(grid + s0) = make_uint4(o[0], o[1], o[2],
                                                          o[3]);
        return;
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
        if (s0 + k < n)
            grid[s0 + k] = static_cast<uint8_t>(o[k / 4] >> (8 * (k % 4)));
}

// K15, modes 2, 4, 6: a thread takes kDenseGroups groups kThreads apart
// (consecutive threads, consecutive groups), all loads before any store.
// vec: the packed and grid pointers are aligned for the wide accesses.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
unpack_dense(const uint8_t* __restrict__ packed, int64_t n, int64_t n_packed,
             bool vec, uint8_t* __restrict__ grid) {
    const int64_t q0 = int64_t(blockIdx.x) * (kThreads * kDenseGroups)
                       + threadIdx.x;
    uint32_t w[kDenseGroups][3];
#pragma unroll
    for (int j = 0; j < kDenseGroups; ++j) {
        const int64_t q = q0 + int64_t(j) * kThreads;
        load_group<kMode>(packed, q, vec && (q + 1) * kGroup <= n, n_packed,
                          w[j]);
    }
#pragma unroll
    for (int j = 0; j < kDenseGroups; ++j) {
        const int64_t q = q0 + int64_t(j) * kThreads;
        if (q * kGroup >= n) break;
        uint32_t o[4];
        decode_group<kMode>(w[j], o);
        store_group(grid, q * kGroup, n, vec && (q + 1) * kGroup <= n, o);
    }
}

// K15, modes 15 and 23: a tile of kSentTile slots a block, by atomic
// ticket; a thread kSentGroups consecutive groups.  Codes below the
// sentinel map through side[0:16], the k-th sentinel of the grid in scan
// order to side[16 + clip(k, 0, n_side - 17)].
template <int kMode>
__global__ void __launch_bounds__(kThreads)
unpack_sent(const uint8_t* __restrict__ packed, int64_t n, int64_t n_packed,
            bool vec, const uint8_t* __restrict__ side, int64_t n_side,
            unsigned* __restrict__ ticket,
            unsigned long long* __restrict__ desc, int64_t tiles,
            uint8_t* __restrict__ grid) {
    __shared__ uint8_t top[16];
    __shared__ uint8_t stage[kSentTile];
    __shared__ int64_t tile_sh, excl_sh;
    if (threadIdx.x == 0) tile_sh = atomicAdd(ticket, 1u);
    if (threadIdx.x < 16) top[threadIdx.x] = side[threadIdx.x];
    __syncthreads();
    const int64_t tile = tile_sh;
    FQK_BOUND("unpack_grid", "tile", tile, tiles);
    const int64_t q0 = (tile * kThreads + threadIdx.x) * kSentGroups;
    uint32_t w[kSentGroups][3];
    // bit 4k (nibbles) or 2k (2-bit codes) of e[j] set where slot k of
    // group j holds the sentinel; bytes past the grid's end load as 0, no
    // sentinel
    uint64_t e[kSentGroups];
    int32_t c = 0;
#pragma unroll
    for (int j = 0; j < kSentGroups; ++j) {
        const int64_t q = q0 + j;
        load_group<kMode>(packed, q, vec && (q + 1) * kGroup <= n, n_packed,
                          w[j]);
        if (kMode == 15) {
            const uint64_t v = uint64_t(w[j][0]) | uint64_t(w[j][1]) << 32;
            e[j] = v & (v >> 1) & (v >> 2) & (v >> 3) & 0x1111111111111111ull;
        } else {
            e[j] = w[j][0] & (w[j][0] >> 1) & 0x55555555u;
        }
        c += __popcll(e[j]);
    }
    // the tile's count, published before its look-back so that later
    // tiles wait least
    int32_t agg;
    int32_t r = fqk::block_exclusive_scan<kThreads>(c, &agg);
    if (threadIdx.x == 0)
        fqk::desc_store(desc + tile, fqk::desc_aggregate(tile, agg));
    if (threadIdx.x < 32) {
        const int64_t before = tile ? fqk::look_back(desc, tile, tiles) : 0;
        if (threadIdx.x == 0) {
            if (tile)
                fqk::desc_store(desc + tile, fqk::desc_inclusive(agg, before));
            excl_sh = before;
        }
    }
    __syncthreads();
    // the tile's run of exceptions, consecutive threads on consecutive
    // bytes; an index past the sidecar takes its last byte
    const int64_t excl = excl_sh, last = n_side - 17;
    for (int32_t i = threadIdx.x; i < agg; i += kThreads) {
        const int64_t k = min(excl + i, last);
        FQK_BOUND("unpack_grid", "side", 16 + k, n_side);
        stage[i] = side[16 + k];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSentGroups; ++j) {
        const int64_t q = q0 + j;
        if (q * kGroup >= n) break;
        uint32_t code4[4], o[4] = {0, 0, 0, 0};
        decode_group<kMode>(w[j], code4);
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
            const uint32_t code = (code4[k / 4] >> (8 * (k % 4))) & 0xFFu;
            uint32_t v = top[code];
            if ((e[j] >> (kMode == 15 ? 4 * k : 2 * k)) & 1u) v = stage[r++];
            o[k / 4] |= v << (8 * (k % 4));
        }
        store_group(grid, q * kGroup, n, vec && (q + 1) * kGroup <= n, o);
    }
}

int64_t sent_tiles(int64_t n) {
    return n > 0 ? (n + kSentTile - 1) / kSentTile : 1;
}

// K16: one thread per 4-slot group.
__global__ void pack_dense(const uint32_t* __restrict__ grid4, int32_t mode,
                           int64_t n_groups, uint8_t* __restrict__ out) {
    const int64_t g = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (g >= n_groups) return;
    const uint32_t w = grid4[g];
    const uint32_t a = w & 0xFF, b = (w >> 8) & 0xFF, c = (w >> 16) & 0xFF,
                   d = w >> 24;
    if (mode == 2) {
        out[g] = static_cast<uint8_t>(a | (b << 2) | (c << 4) | (d << 6));
    } else if (mode == 4) {
        out[2 * g] = static_cast<uint8_t>(a | (b << 4));
        out[2 * g + 1] = static_cast<uint8_t>(c | (d << 4));
    } else {
        const uint32_t v = a | (b << 6) | (c << 12) | (d << 18);
        out[3 * g] = static_cast<uint8_t>(v);
        out[3 * g + 1] = static_cast<uint8_t>(v >> 8);
        out[3 * g + 2] = static_cast<uint8_t>(v >> 16);
    }
}

// K17: lane lengths (validity: slot (t, l) is valid iff t < len[l]), and
// the largest T - len[l] of any lane (gap, zeroed by the caller): every
// slot of a wave t < T - gap is valid.
__global__ void lane_lengths(const int32_t* __restrict__ cgrid, int32_t J,
                             int32_t T, int32_t L, int32_t* __restrict__ lens,
                             int32_t* __restrict__ gap) {
    const int32_t l = blockIdx.x * blockDim.x + threadIdx.x;
    int32_t g = 0;
    if (l < L) {
        const int32_t n = fqk::lane_length(cgrid, J, L, l);
        lens[l] = n;
        g = T - n;
    }
    g = __reduce_max_sync(0xFFFFFFFFu, g);
    if ((threadIdx.x & 31) == 0 && g > 0) atomicMax(gap, g);
}

// K17's histogram pass: a block takes a tile of kHistWaves waves x 32
// lane quads (4 lanes, one 32-bit word of a wave); warp w walks waves
// t0 + w, t0 + w + 8, ..., lane i the quad q = 32 blockIdx.x + i, whose
// four lengths it loads once, so a slot's validity is t < len and needs
// no division; its 16 loads are all in flight before it counts.  Each
// warp counts into its own sub-histogram in shared memory with shared
// atomic increments, which the card aggregates over a warp's lanes that
// hit one bin, so a grid whose symbols crowd a few bins does not
// serialize; the block sums its 8 sub-histograms and adds each bin to the
// global count with one atomic.
constexpr int kHistThreads = 256;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistWaves = 128;                  // waves a histogram tile
constexpr int kHistPer = kHistWaves / kHistWarps;   // words a thread

__global__ void __launch_bounds__(kHistThreads)
pack15_hist(const uint32_t* __restrict__ syms4, int32_t T, int32_t L4,
            const int4* __restrict__ lens4, int32_t* __restrict__ hist) {
    __shared__ int32_t h[kHistWarps][kAlpha];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int32_t q = blockIdx.x * 32 + lane;
    const int32_t t0 = blockIdx.y * kHistWaves + warp;
    const int32_t t1 = min(T, int32_t(blockIdx.y + 1) * kHistWaves);
    uint32_t w[kHistPer];
    int4 n = make_int4(0, 0, 0, 0);
    if (q < L4) {
        n = lens4[q];
#pragma unroll
        for (int u = 0; u < kHistPer; ++u) {
            const int32_t t = t0 + kHistWarps * u;
            w[u] = t < t1 ? syms4[int64_t(t) * L4 + q] : 0u;
        }
    }
    for (int i = threadIdx.x; i < kHistWarps * kAlpha; i += kHistThreads)
        (&h[0][0])[i] = 0;
    __syncthreads();
    if (q < L4) {
        const int32_t len[4] = {n.x, n.y, n.z, n.w};
#pragma unroll
        for (int u = 0; u < kHistPer; ++u) {
            const int32_t t = t0 + kHistWarps * u;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const uint32_t sym = (w[u] >> (8 * b)) & 0xFFu;
                if (t < len[b] && sym < kAlpha) atomicAdd(&h[warp][sym], 1);
            }
        }
    }
    __syncthreads();
    if (threadIdx.x < kAlpha) {
        int32_t sum = 0;
#pragma unroll
        for (int wv = 0; wv < kHistWarps; ++wv) sum += h[wv][threadIdx.x];
        if (sum) atomicAdd(hist + threadIdx.x, sum);
    }
}

// K17's write pass: kPackThreads threads a tile, each kPackGroups
// consecutive 4-slot groups (64 slots, four 16-byte loads, two 16-byte
// stores of nibbles), so a thread's slots are in scan order and a block
// scan ranks its exceptions inside the tile.
constexpr int kPackThreads = 256;
constexpr int kPackGroups = 16;
constexpr int64_t kPackTileGroups = int64_t(kPackThreads) * kPackGroups;
constexpr int64_t kPackTile = 4 * kPackTileGroups;          // slots a tile

// Tiles in the order their blocks start (an atomic ticket, not
// blockIdx), so a tile looks back only at tiles whose blocks run.
// Prologue: the block ranks the 64 symbols from the histogram, rank(a) =
// #{b : h[b] > h[a] or (h[b] = h[a] and b < a)} (lax.top_k's order:
// count descending, ties to the lower symbol), so lut[a] is a's nibble
// (15 = exception from rank 15 on) and tile 0 writes side[0:16].  Each
// slot ships lut[filled], filled its symbol where valid, else top[0]; a
// slot of a wave below T - gap is valid without a lookup, and only later
// waves read the lanes' lengths (a thread's 64-slot run reads 64 of
// them, so a warp's load touches 32 lines); exceptions (always valid
// slots) are staged in shared memory in scan
// order and, once the look-back gives the tile's offset, stored to
// side[16 + rank] below cap by consecutive threads; the last tile writes
// n_exc, every exception included.
__global__ void __launch_bounds__(kPackThreads)
pack15_write(const uint8_t* __restrict__ syms, int64_t n, int32_t T,
             int32_t L4, const int4* __restrict__ lens4,
             const int32_t* __restrict__ gap,
             const int32_t* __restrict__ hist,
             unsigned* __restrict__ ticket,
             unsigned long long* __restrict__ desc, int64_t tiles,
             uint8_t* __restrict__ nib, uint8_t* __restrict__ side,
             int64_t cap, int32_t* __restrict__ n_exc) {
    __shared__ int32_t hs[kAlpha];
    __shared__ uint8_t lut[kAlpha];
    __shared__ uint32_t top0;
    __shared__ int64_t tile_sh, excl_sh;
    __shared__ uint8_t stage[kPackTile];
    if (threadIdx.x < kAlpha) hs[threadIdx.x] = hist[threadIdx.x];
    if (threadIdx.x == 0) tile_sh = atomicAdd(ticket, 1u);
    __syncthreads();
    const int64_t tile = tile_sh;
    FQK_BOUND("pack15", "tile", tile, tiles);
    // the tile's loads first, so they are in flight while the block
    // ranks the symbols
    const int64_t n4 = n >> 2;
    const int64_t q0 = tile * kPackTileGroups
                       + int64_t(threadIdx.x) * kPackGroups;
    uint32_t w[kPackGroups];
    const bool full = q0 + kPackGroups <= n4;
    if (full) {
        const uint4* p = reinterpret_cast<const uint4*>(syms) + q0 / 4;
#pragma unroll
        for (int i = 0; i < kPackGroups / 4; ++i) {
            const uint4 v = p[i];
            w[4 * i] = v.x;
            w[4 * i + 1] = v.y;
            w[4 * i + 2] = v.z;
            w[4 * i + 3] = v.w;
        }
    } else {
        const uint32_t* p = reinterpret_cast<const uint32_t*>(syms);
#pragma unroll
        for (int k = 0; k < kPackGroups; ++k)
            w[k] = q0 + k < n4 ? p[q0 + k] : 0u;
    }
    if (threadIdx.x < kAlpha) {
        const int32_t a = threadIdx.x, ha = hs[a];
        int32_t r = 0;
        for (int32_t b = 0; b < kAlpha; ++b)
            r += hs[b] > ha || (hs[b] == ha && b < a);
        lut[a] = static_cast<uint8_t>(r < 15 ? r : 15);
        if (r == 0) top0 = a;
        if (tile == 0 && r < 15) side[r] = static_cast<uint8_t>(a);
        if (tile == 0 && a == 0) side[15] = 0;
    }
    __syncthreads();
    // the first group's wave and quad, then a step of one quad a group
    int32_t t = 0, q = 0;
    if (q0 < n4) {
        t = static_cast<int32_t>(q0 / L4);
        q = static_cast<int32_t>(q0 - int64_t(t) * L4);
    }
    // a group's four slots at once: the valid bytes' mask, the filled
    // bytes clamped to 63, four lut reads, the nibbles equal to 15
    uint32_t code[kPackGroups / 2];
    uint64_t exc = 0;                      // bit 4k + b: group k, slot b
    const uint32_t fill4 = top0 * 0x01010101u;
    const int32_t all_valid = T - *gap;    // waves below it: every slot valid
#pragma unroll
    for (int k = 0; k < kPackGroups; ++k) {
        uint32_t c4 = 0;
        if (q0 + k < n4) {
            uint32_t vm = 0xFFFFFFFFu;
            if (t >= all_valid) {
                const int4 ln = __ldg(lens4 + q);
                vm = (t < ln.x ? 0xFFu : 0u) | (t < ln.y ? 0xFF00u : 0u)
                     | (t < ln.z ? 0xFF0000u : 0u)
                     | (t < ln.w ? 0xFF000000u : 0u);
            }
            const uint32_t f = __vminu4((w[k] & vm) | (fill4 & ~vm),
                                        0x3F3F3F3Fu);
            c4 = uint32_t(lut[f & 0xFFu])
                 | uint32_t(lut[(f >> 8) & 0xFFu]) << 4
                 | uint32_t(lut[(f >> 16) & 0xFFu]) << 8
                 | uint32_t(lut[f >> 24]) << 12;
            uint32_t e = c4 & (c4 >> 1) & (c4 >> 2) & (c4 >> 3) & 0x1111u;
            e = (e | (e >> 3) | (e >> 6) | (e >> 9)) & 0xFu;
            exc |= uint64_t(e) << (4 * k);
            if (++q == L4) {
                q = 0;
                ++t;
            }
        }
        if (k & 1) code[k / 2] |= c4 << 16;
        else code[k / 2] = c4;
    }
    if (full) {
        uint4* o = reinterpret_cast<uint4*>(nib) + q0 / 8;
        o[0] = make_uint4(code[0], code[1], code[2], code[3]);
        o[1] = make_uint4(code[4], code[5], code[6], code[7]);
    } else {
        uint16_t* o = reinterpret_cast<uint16_t*>(nib);
#pragma unroll
        for (int k = 0; k < kPackGroups; ++k)
            if (q0 + k < n4)
                o[q0 + k] = static_cast<uint16_t>(code[k / 2]
                                                  >> (16 * (k & 1)));
    }
    // the tile's count, published before anything else so that later
    // tiles' look-backs wait least; then its exceptions in scan order,
    // staged for coalesced stores, while warp 0 looks back
    int32_t agg;
    int32_t r = fqk::block_exclusive_scan<kPackThreads>(__popcll(exc), &agg);
    if (threadIdx.x == 0)
        fqk::desc_store(desc + tile, fqk::desc_aggregate(tile, agg));
    if (exc) {
#pragma unroll
        for (int k = 0; k < kPackGroups; ++k)
            for (uint32_t m = (exc >> (4 * k)) & 15u; m; m &= m - 1)
                stage[r++] = static_cast<uint8_t>(
                    w[k] >> (8 * (__ffs(m) - 1)));
    }
    if (threadIdx.x < 32) {
        const int64_t before = tile ? fqk::look_back(desc, tile, tiles) : 0;
        if (threadIdx.x == 0) {
            if (tile)
                fqk::desc_store(desc + tile, fqk::desc_inclusive(agg, before));
            if (tile == tiles - 1)
                *n_exc = static_cast<int32_t>(before + agg);
            excl_sh = before;
        }
    }
    __syncthreads();
    const int64_t excl = excl_sh;
    const int64_t lim = min(int64_t(agg), max(int64_t(0), cap - excl));
    for (int64_t i = threadIdx.x; i < lim; i += kPackThreads) {
        FQK_BOUND("pack15", "side", 16 + excl + i, 16 + cap);
        side[16 + excl + i] = stage[i];
    }
}

unsigned blocks_of(int64_t n) {
    return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// K17's scratch: the lanes' lengths, then the histogram (64 int32), the
// tile ticket and the lanes' largest gap below T, then a descriptor a
// tile.
constexpr int64_t kPackHead = 4 * kAlpha + 16;

int64_t pack15_tiles(int64_t n) {
    return n > 0 ? (n + kPackTile - 1) / kPackTile : 1;
}

int64_t align16(int64_t n) { return (n + 15) & ~int64_t(15); }

}  // namespace

extern "C" int64_t fq_unpack_grid_scratch_bytes(int32_t mode, int64_t n) {
    return mode == 15 || mode == 23 ? kSentHead + 8 * sent_tiles(n) : 0;
}

// K15: mode 2/4/6 (side unused) or 15/23; T * L slots, L % 4 == 0 (the
// sentinel modes: T * L < 2^31, the look-back's prefixes are 32-bit;
// n_side >= 17).  scratch: fq_unpack_grid_scratch_bytes(mode, T * L)
// bytes, 8-byte aligned (none for the dense modes).  Dense modes: one
// launch; sentinel modes: a memset of the ticket and descriptors, then
// one launch.
extern "C" int fq_unpack_grid(const uint8_t* packed, int32_t mode, int32_t T,
                              int32_t L, const uint8_t* side, int64_t n_side,
                              void* scratch, int64_t n_packed, uint8_t* grid,
                              void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T < 0 || L < 0 || L % 4) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n = int64_t(T) * L;
    const uintptr_t align = mode == 4 || mode == 15 ? 8 : 4;
    const bool vec = (reinterpret_cast<uintptr_t>(grid) & 15) == 0
                     && (reinterpret_cast<uintptr_t>(packed) % align) == 0;
    if (mode == 2 || mode == 4 || mode == 6) {
        if (n == 0) return 0;
        const unsigned blocks =
            static_cast<unsigned>((n + kDenseBlock - 1) / kDenseBlock);
        if (mode == 2)
            unpack_dense<2><<<blocks, kThreads, 0, st>>>(packed, n, n_packed,
                                                         vec, grid);
        else if (mode == 4)
            unpack_dense<4><<<blocks, kThreads, 0, st>>>(packed, n, n_packed,
                                                         vec, grid);
        else
            unpack_dense<6><<<blocks, kThreads, 0, st>>>(packed, n, n_packed,
                                                         vec, grid);
        return static_cast<int>(cudaGetLastError());
    }
    if ((mode != 15 && mode != 23) || n >= (int64_t(1) << 31) || n_side < 17)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    const int64_t tiles = sent_tiles(n);
    cudaError_t rc = cudaMemsetAsync(
        scratch, 0, fq_unpack_grid_scratch_bytes(mode, n), st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    auto* ticket = static_cast<unsigned*>(scratch);
    auto* desc = reinterpret_cast<unsigned long long*>(
        static_cast<char*>(scratch) + kSentHead);
    if (mode == 15)
        unpack_sent<15><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
            packed, n, n_packed, vec, side, n_side, ticket, desc, tiles, grid);
    else
        unpack_sent<23><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
            packed, n, n_packed, vec, side, n_side, ticket, desc, tiles, grid);
    return static_cast<int>(cudaGetLastError());
}

// K16: mode 2, 4 or 6.
extern "C" int fq_pack_grid(const uint8_t* grid, int32_t mode, int32_t T,
                            int32_t L, uint8_t* out, void* stream) {
    if (mode != 2 && mode != 4 && mode != 6)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t groups = int64_t(T) * L / 4;
    if (groups == 0) return 0;
    pack_dense<<<blocks_of(groups), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint32_t*>(grid), mode, groups, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int64_t fq_pack15_scratch_bytes(int32_t T, int32_t L) {
    return align16(4 * int64_t(L)) + kPackHead
           + 8 * pack15_tiles(int64_t(T) * L);
}

// K17: syms (T, L) u8 (16-byte aligned), cgrid (J, L) int32 read
// lengths, L % 4 == 0.  scratch: fq_pack15_scratch_bytes(T, L) bytes.
// Outputs: nib (T*L/2 u8), side (16 + cap u8, zeroed by the caller),
// n_exc (one int32: every exception, also those past cap).  Three
// launches and a memset: lane_lengths, pack15_hist (the grid's first
// read), pack15_write (its second; the top 15, nibbles and exceptions).
extern "C" int fq_pack15(const uint8_t* syms, const int32_t* cgrid, int32_t J,
                         int32_t T, int32_t L, void* scratch, uint8_t* nib,
                         uint8_t* side, int32_t* n_exc, int64_t cap,
                         void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (L <= 0 || L % 4 || T < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n = int64_t(T) * L;
    const int64_t tiles = pack15_tiles(n);
    char* p = static_cast<char*>(scratch);
    int32_t* lens = reinterpret_cast<int32_t*>(p);
    p += align16(4 * int64_t(L));
    int32_t* hist = reinterpret_cast<int32_t*>(p);
    unsigned* ticket = reinterpret_cast<unsigned*>(p + 4 * kAlpha);
    auto* desc = reinterpret_cast<unsigned long long*>(p + kPackHead);
    cudaError_t rc = cudaMemsetAsync(hist, 0, kPackHead + 8 * tiles, st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    int32_t* gap = reinterpret_cast<int32_t*>(p + 4 * kAlpha + 4);
    lane_lengths<<<blocks_of(L), kThreads, 0, st>>>(cgrid, J, T, L, lens,
                                                    gap);
    const int32_t L4 = L / 4;
    const auto* lens4 = reinterpret_cast<const int4*>(lens);
    if (n) {
        const dim3 grid((L4 + 31) / 32, (T + kHistWaves - 1) / kHistWaves);
        pack15_hist<<<grid, kHistThreads, 0, st>>>(
            reinterpret_cast<const uint32_t*>(syms), T, L4, lens4, hist);
    }
    pack15_write<<<static_cast<unsigned>(tiles), kPackThreads, 0, st>>>(
        syms, n, T, L4, lens4, gap, hist, ticket, desc, tiles, nib, side,
        cap, n_exc);
    return static_cast<int>(cudaGetLastError());
}
