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
// (one 4-byte load or store of the grid).  K15's sentinel modes need each
// sentinel's rank in scan order: tiles of kTile slots count their
// sentinels, one block scans the tile counts, then every tile rescans its
// own slots (a block scan) and writes.  K17 reads the grid twice: a
// histogram pass (pack15_hist), then one write pass (pack15_write) whose
// prologue ranks the 64 symbols and whose tiles take their exception
// offsets from a decoupled look-back over per-tile descriptors
// (lookback.cuh, shared with K3), so no pass counts the exceptions
// first.  Its validity comes from the lanes'
// lengths (lane_walk.cuh) beside each slot's wave and lane, which the
// passes step without a division a slot, never from a (T, L) mask.  The
// first K17 (seven launches: the grid read three times, the top 15 on
// one thread, validity by a 64-bit division and modulo a slot, 16
// bytes a thread read one at a time) took 0.39-0.40 ms on an H100 at 25.2
// M slots.

#include <cstdint>

#include <cuda_runtime.h>

#include "check.cuh"
#include "lane_walk.cuh"
#include "lookback.cuh"

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

unsigned tiles_of(int64_t n) {
    return static_cast<unsigned>((n + kTile - 1) / kTile);
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
