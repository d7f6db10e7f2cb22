// Decoupled look-back over tiles taken by atomic ticket (K3
// compact_words, K15 unpack_sent, K17 pack15_write): a one-pass exclusive
// scan of per-tile counts across the blocks of one launch.
//
// A block takes its tile from an atomic ticket (not blockIdx), so every
// tile before it belongs to a block that has started.  It publishes its
// count as soon as it has it, looks back over its predecessors'
// descriptors for its exclusive prefix, then publishes its inclusive
// prefix; tile 0 publishes its prefix at once.  The descriptors and the
// ticket are zeroed (cudaMemsetAsync) before the launch.
#pragma once

#include <cstdint>

#include "check.cuh"

namespace fqk {

// A tile's descriptor in one 64-bit word: the flag (bits 62-63), the
// tile's count (bits 32-61) and, once the flag is kPrefix, its inclusive
// prefix (bits 0-31).  Zero = not published yet.  So a tile counts below
// 2^30 and the whole scan stays below 2^32.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;

__device__ __forceinline__ void desc_store(unsigned long long* p,
                                           unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)
                 : "memory");
}

__device__ __forceinline__ unsigned long long desc_load(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
    return v;
}

// Tile `id`'s descriptor before its look-back: its count, or for tile 0
// its count as its prefix.
__device__ __forceinline__ unsigned long long desc_aggregate(int64_t id,
                                                             uint32_t count) {
    return id ? kAggregate | (uint64_t(count) << 32)
              : kPrefix | (uint64_t(count) << 32) | count;
}

// Tile `id`'s descriptor once its exclusive prefix is known.
__device__ __forceinline__ unsigned long long desc_inclusive(uint32_t count,
                                                             int64_t before) {
    return kPrefix | (uint64_t(count) << 32) | uint32_t(before + count);
}

// Decoupled look-back, one warp: the counts of every tile before tile
// `id` (id >= 1).  Lane i reads the descriptor of tile id - 1 - i
// (waiting while it is unpublished; a tile publishes its count before it
// looks back, and tiles before `id` took their tickets first, so they are
// running); the nearest tile with its prefix ends the walk, the tiles
// between add their counts; else the warp steps 32 tiles back.  A wider
// window (8 descriptors a lane) was slower on an H100 in K17: a tile then
// waits for the slowest of 256 predecessors to publish its count.
__device__ __forceinline__ int64_t look_back(
        const unsigned long long* __restrict__ desc, int64_t id,
        int64_t tiles) {
    const int lane = threadIdx.x & 31;
    int64_t excl = 0;
    for (int64_t base = id - 1;; base -= 32) {
        const int64_t j = base - lane;
        unsigned long long d = kPrefix;            // before tile 0: prefix 0
        if (j >= 0) {
            FQK_BOUND("look_back", "descriptor", j, tiles);
            do {
                d = desc_load(desc + j);
            } while ((d >> 62) == 0);
        }
        const unsigned pre = __ballot_sync(0xFFFFFFFFu, (d >> 62) == 2);
        const int stop = pre ? __ffs(pre) - 1 : 32;
        long long v = 0;        // counts before the stop, then its prefix
        if (lane < stop) v = (d >> 32) & 0x3FFFFFFFull;
        else if (lane == stop) v = d & 0xFFFFFFFFull;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
        excl += v;
        if (pre) return excl;
    }
}

}  // namespace fqk
