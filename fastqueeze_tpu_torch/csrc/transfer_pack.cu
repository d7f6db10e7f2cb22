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
// bound by device memory.  Dense modes are one thread per 4-slot group
// (one 4-byte load or store of the grid).  The sentinel passes need each
// sentinel's rank in scan order: tiles of kTile slots count their
// sentinels, one block scans the tile counts, then every tile rescans its
// own slots (a block scan) and writes; the grid is read twice, which keeps
// the scan simple and deterministic.  K17's histogram counts in shared
// memory per block, then 64 global atomics a block; validity comes from
// the lanes' lengths (lane_walk.cuh), never a (T, L) mask.

#include <cstdint>

#include <cuda_runtime.h>

#include "check.cuh"
#include "lane_walk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                         // slots a thread (even)
constexpr int64_t kTile = int64_t(kThreads) * kPer;
constexpr int kScanThreads = 1024;
constexpr int kAlpha = 64;                       // 6-bit symbols

// Code of slot s in a packed grid of `mode` (2/23, 4/15 or 6).
__device__ __forceinline__ uint32_t code_at(const uint8_t* __restrict__ p,
                                            int32_t mode, int64_t s,
                                            int64_t n_packed) {
    if (mode == 2 || mode == 23) {
        FQK_BOUND("unpack_grid", "packed", s >> 2, n_packed);
        return (p[s >> 2] >> (2 * (s & 3))) & 3u;
    }
    if (mode == 4 || mode == 15) {
        FQK_BOUND("unpack_grid", "packed", s >> 1, n_packed);
        return (p[s >> 1] >> (4 * (s & 1))) & 15u;
    }
    const int64_t b = 3 * (s >> 2);
    FQK_BOUND("unpack_grid", "packed", b + 2, n_packed);
    const uint32_t v = uint32_t(p[b]) | (uint32_t(p[b + 1]) << 8)
                       | (uint32_t(p[b + 2]) << 16);
    return (v >> (6 * (s & 3))) & 63u;
}

// K15, modes 2, 4, 6: one thread per 4-slot group.
__global__ void unpack_dense(const uint8_t* __restrict__ packed,
                             int32_t mode, int64_t n_groups,
                             int64_t n_packed, uint32_t* __restrict__ grid4) {
    const int64_t g = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (g >= n_groups) return;
    uint32_t out = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        out |= code_at(packed, mode, 4 * g + k, n_packed) << (8 * k);
    grid4[g] = out;
}

// Sentinel count of each tile (K15 modes 15/23: the packed code equals
// sent; K17: the nibble of the filled symbol is 15).
__global__ void unpack_count(const uint8_t* __restrict__ packed,
                             int32_t mode, uint32_t sent, int64_t n,
                             int64_t n_packed,
                             int32_t* __restrict__ tile_counts) {
    const int64_t s0 = blockIdx.x * kTile + int64_t(threadIdx.x) * kPer;
    int32_t c = 0;
    for (int k = 0; k < kPer; ++k)
        if (s0 + k < n) c += code_at(packed, mode, s0 + k, n_packed) == sent;
    int32_t total;
    fqk::block_exclusive_scan<kThreads>(c, &total);
    if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// Exclusive scan of the tile counts (one block); *total = their sum.
__global__ void scan_tiles(const int32_t* __restrict__ tile_counts,
                           int64_t n_tiles, int32_t* __restrict__ tile_off,
                           int32_t* __restrict__ total) {
    int32_t carry = 0;
    for (int64_t b0 = 0; b0 < n_tiles; b0 += kScanThreads) {
        const int64_t b = b0 + threadIdx.x;
        const int32_t v = b < n_tiles ? tile_counts[b] : 0;
        int32_t sum;
        const int32_t ex = fqk::block_exclusive_scan<kScanThreads>(v, &sum);
        if (b < n_tiles) tile_off[b] = carry + ex;
        carry += sum;
    }
    if (threadIdx.x == 0) *total = carry;
}

// K15, modes 15/23: codes below sent map through side[0:16], the k-th
// sentinel in scan order to side[16 + clip(k, 0, n_side - 17)].
__global__ void unpack_sent(const uint8_t* __restrict__ packed, int32_t mode,
                            uint32_t sent, int64_t n, int64_t n_packed,
                            const int32_t* __restrict__ tile_off,
                            const uint8_t* __restrict__ side, int64_t n_side,
                            uint8_t* __restrict__ grid) {
    const int64_t s0 = blockIdx.x * kTile + int64_t(threadIdx.x) * kPer;
    uint32_t code[kPer];
    int32_t c = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        code[k] = s0 + k < n ? code_at(packed, mode, s0 + k, n_packed) : 0;
        c += s0 + k < n && code[k] == sent;
    }
    int32_t total;
    int64_t rank = tile_off[blockIdx.x]
                   + fqk::block_exclusive_scan<kThreads>(c, &total);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        if (s0 + k >= n) break;
        int64_t at = code[k];
        if (code[k] == sent) {
            const int64_t hi = n_side - 17;
            at = 16 + (rank < 0 ? 0 : (rank > hi ? hi : rank));
            ++rank;
        }
        FQK_BOUND("unpack_grid", "side", at, n_side);
        grid[s0 + k] = side[at];
    }
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

// K17 step 1: lane lengths (validity: slot (t, l) is valid iff t < len[l]).
__global__ void lane_lengths(const int32_t* __restrict__ cgrid, int32_t J,
                             int32_t L, int32_t* __restrict__ lens) {
    const int32_t l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l < L) lens[l] = fqk::lane_length(cgrid, J, L, l);
}

__device__ __forceinline__ bool slot_valid(const int32_t* __restrict__ lens,
                                           int64_t s, int32_t L) {
    return s / L < lens[s % L];
}

// K17 step 2: 64-bin histogram of the valid slots' symbols.
__global__ void hist64(const uint8_t* __restrict__ syms, int64_t n,
                       int32_t L, const int32_t* __restrict__ lens,
                       int32_t* __restrict__ hist) {
    __shared__ int32_t h[kAlpha];
    if (threadIdx.x < kAlpha) h[threadIdx.x] = 0;
    __syncthreads();
    for (int64_t s = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; s < n;
         s += int64_t(gridDim.x) * blockDim.x)
        if (slot_valid(lens, s, L) && syms[s] < kAlpha)
            atomicAdd(&h[syms[s]], 1);
    __syncthreads();
    if (threadIdx.x < kAlpha && h[threadIdx.x])
        atomicAdd(hist + threadIdx.x, h[threadIdx.x]);
}

// K17 step 3 (one thread): the top 15 in lax.top_k order (count
// descending, ties to the lower symbol) into side[0:15] (side[15] = 0) and
// the symbol -> nibble table lut (15 = exception).
__global__ void top15(const int32_t* __restrict__ hist,
                      uint8_t* __restrict__ side, uint8_t* __restrict__ lut) {
    bool used[kAlpha];
    for (int a = 0; a < kAlpha; ++a) {
        used[a] = false;
        lut[a] = 15;
    }
    for (int k = 0; k < 15; ++k) {
        int best = -1;
        for (int a = 0; a < kAlpha; ++a)
            if (!used[a] && (best < 0 || hist[a] > hist[best])) best = a;
        used[best] = true;
        side[k] = static_cast<uint8_t>(best);
        lut[best] = static_cast<uint8_t>(k);
    }
    side[15] = 0;
}

// The nibble and the value a K17 slot ships: invalid slots are filled
// with top[0] (side[0]); the lut gather clamps as the reference's does.
__device__ __forceinline__ uint32_t nib_of(const uint8_t* __restrict__ syms,
                                           const int32_t* __restrict__ lens,
                                           const uint8_t* __restrict__ lut,
                                           const uint8_t* __restrict__ side,
                                           int64_t s, int32_t L,
                                           uint8_t* filled) {
    *filled = slot_valid(lens, s, L) ? syms[s] : side[0];
    return lut[*filled < kAlpha ? *filled : kAlpha - 1];
}

__global__ void pack15_count(const uint8_t* __restrict__ syms, int64_t n,
                             int32_t L, const int32_t* __restrict__ lens,
                             const uint8_t* __restrict__ lut,
                             const uint8_t* __restrict__ side,
                             int32_t* __restrict__ tile_counts) {
    const int64_t s0 = blockIdx.x * kTile + int64_t(threadIdx.x) * kPer;
    int32_t c = 0;
    uint8_t f;
    for (int k = 0; k < kPer; ++k)
        if (s0 + k < n) c += nib_of(syms, lens, lut, side, s0 + k, L, &f) == 15;
    int32_t total;
    fqk::block_exclusive_scan<kThreads>(c, &total);
    if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// K17 step 5: the nibbles, two a byte, and the exceptions below cap at
// side[16 + rank] (side arrives zeroed; later ones are dropped).
__global__ void pack15_write(const uint8_t* __restrict__ syms, int64_t n,
                             int32_t L, const int32_t* __restrict__ lens,
                             const uint8_t* __restrict__ lut,
                             const int32_t* __restrict__ tile_off,
                             uint8_t* __restrict__ side, int64_t cap,
                             uint8_t* __restrict__ nib) {
    const int64_t s0 = blockIdx.x * kTile + int64_t(threadIdx.x) * kPer;
    uint8_t code[kPer], fill[kPer];
    int32_t c = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        code[k] = 0;
        fill[k] = 0;
        if (s0 + k < n) {
            code[k] = nib_of(syms, lens, lut, side, s0 + k, L, &fill[k]);
            c += code[k] == 15;
        }
    }
    int32_t total;
    int64_t rank = tile_off[blockIdx.x]
                   + fqk::block_exclusive_scan<kThreads>(c, &total);
#pragma unroll
    for (int k = 0; k < kPer; k += 2) {
        if (s0 + k >= n) break;
        nib[(s0 + k) >> 1] = static_cast<uint8_t>(code[k] | (code[k + 1] << 4));
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        if (s0 + k < n && code[k] == 15) {
            if (rank < cap) {
                FQK_BOUND("pack15", "side", 16 + rank, 16 + cap);
                side[16 + rank] = fill[k];
            }
            ++rank;
        }
    }
}

unsigned tiles_of(int64_t n) {
    return static_cast<unsigned>((n + kTile - 1) / kTile);
}

unsigned blocks_of(int64_t n) {
    return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// K15: mode 2/4/6 (side unused) or 15/23; T * L slots, L % 4 == 0.
// Scratch: tile_counts and tile_off, tiles_of(T * L) int32 each, and
// total (one int32).
extern "C" int fq_unpack_grid(const uint8_t* packed, int32_t mode, int32_t T,
                              int32_t L, const uint8_t* side, int64_t n_side,
                              int32_t* tile_scratch, int64_t n_packed,
                              uint8_t* grid, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t n = int64_t(T) * L;
    if (n == 0) return 0;
    if (mode == 2 || mode == 4 || mode == 6) {
        const int64_t groups = n / 4;
        unpack_dense<<<blocks_of(groups), kThreads, 0, st>>>(
            packed, mode, groups, n_packed, reinterpret_cast<uint32_t*>(grid));
        return static_cast<int>(cudaGetLastError());
    }
    if (mode != 15 && mode != 23) return static_cast<int>(cudaErrorInvalidValue);
    const uint32_t sent = mode == 15 ? 15u : 3u;
    const unsigned tiles = tiles_of(n);
    int32_t* counts = tile_scratch;
    int32_t* off = tile_scratch + tiles;
    int32_t* total = tile_scratch + 2 * tiles;
    unpack_count<<<tiles, kThreads, 0, st>>>(packed, mode, sent, n, n_packed,
                                             counts);
    scan_tiles<<<1, kScanThreads, 0, st>>>(counts, tiles, off, total);
    unpack_sent<<<tiles, kThreads, 0, st>>>(packed, mode, sent, n, n_packed,
                                            off, side, n_side, grid);
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

// K17: syms (T, L) u8, cgrid (J, L) int32 read lengths.  Scratch: lens
// (L int32), hist (64 int32), lut (64 u8), tile_scratch (2 tiles_of(T*L)
// int32).  Outputs: nib (T*L/2 u8), side (16 + cap u8, zeroed by the
// caller), n_exc (one int32: every exception, also those past cap).
extern "C" int fq_pack15(const uint8_t* syms, const int32_t* cgrid, int32_t J,
                         int32_t T, int32_t L, int32_t* lens, int32_t* hist,
                         uint8_t* lut, int32_t* tile_scratch, uint8_t* nib,
                         uint8_t* side, int32_t* n_exc, int64_t cap,
                         void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t n = int64_t(T) * L;
    const unsigned tiles = tiles_of(n);
    if (L > 0)
        lane_lengths<<<blocks_of(L), kThreads, 0, st>>>(cgrid, J, L, lens);
    cudaMemsetAsync(hist, 0, kAlpha * sizeof(int32_t), st);
    if (n) {
        const unsigned want = blocks_of(n);
        hist64<<<want < 4096u ? want : 4096u, kThreads, 0, st>>>(
            syms, n, L, lens, hist);
    }
    top15<<<1, 1, 0, st>>>(hist, side, lut);
    if (n == 0) {
        cudaMemsetAsync(n_exc, 0, sizeof(int32_t), st);
        return static_cast<int>(cudaGetLastError());
    }
    pack15_count<<<tiles, kThreads, 0, st>>>(syms, n, L, lens, lut, side,
                                             tile_scratch);
    scan_tiles<<<1, kScanThreads, 0, st>>>(tile_scratch, tiles,
                                           tile_scratch + tiles, n_exc);
    pack15_write<<<tiles, kThreads, 0, st>>>(syms, n, L, lens, lut,
                                             tile_scratch + tiles, side, cap,
                                             nib);
    return static_cast<int>(cudaGetLastError());
}
