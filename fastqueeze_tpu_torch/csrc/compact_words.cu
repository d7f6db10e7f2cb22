// K3 compact_words: stream compaction of the emitted rANS words into a
// dense prefix in canonical (wave, lane) order, plus the word count.
//
// Replaces fastqueeze_tpu/ops/engine.py _compact_words (B5: an exclusive
// cumsum of the emit flags, then a scatter).  One launch after a memset
// of the tile descriptors and the ticket: each block takes a tile of
// kTile slots by atomic ticket; each thread reads its kPer consecutive
// flags with one 16-byte load and their words with two, counts the
// nonzero flag bytes with a few bit operations and __popc a 32-bit word,
// and a block scan ranks the emitted words inside the tile; the tile
// publishes its count, warp 0 takes the tile's offset by a decoupled
// look-back (lookback.cuh, shared with K17) while the block stages its
// words in shared memory in scan order, and consecutive threads store
// them to out[offset + rank]; the last tile writes the count.  So the
// flags are read once and the words once, and the stores are coalesced.
// Bound by device memory: 3 B read a slot, 2 B written an emitted word.
// The first K3 (three launches: the tiles' counts, one block scanning
// them, the tiles rescanned for a scatter of 2-byte stores a thread)
// took 0.103 ms on an H100 at 25.2 M slots.

#include <cstdint>

#include <cuda_runtime.h>

#include "check.cuh"
#include "lane_walk.cuh"
#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                        // slots a thread
constexpr int64_t kTile = int64_t(kThreads) * kPer;
constexpr int64_t kHead = 16;                   // the ticket, padded

// Bit 7 of each byte of v set where that byte is nonzero, the rest 0.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t v) {
    return (((v & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | v) & 0x80808080u;
}

__global__ void __launch_bounds__(kThreads)
compact_tile(const uint16_t* __restrict__ words,
             const uint8_t* __restrict__ emit, int64_t n, bool vec,
             unsigned* __restrict__ ticket,
             unsigned long long* __restrict__ desc, int64_t tiles,
             uint16_t* __restrict__ out, int32_t* __restrict__ count) {
    __shared__ uint16_t stage[kTile];
    __shared__ int64_t tile_sh, excl_sh;
    if (threadIdx.x == 0) tile_sh = atomicAdd(ticket, 1u);
    __syncthreads();
    const int64_t tile = tile_sh;
    FQK_BOUND("compact_words", "tile", tile, tiles);
    const int64_t s0 = tile * kTile + int64_t(threadIdx.x) * kPer;
    uint32_t f[kPer / 4], w[kPer / 2];     // 4 flags, 2 words a word
    if (vec && s0 + kPer <= n) {
        const uint4 e = *reinterpret_cast<const uint4*>(emit + s0);
        const uint4* p = reinterpret_cast<const uint4*>(words + s0);
        const uint4 a = p[0], b = p[1];
        f[0] = e.x, f[1] = e.y, f[2] = e.z, f[3] = e.w;
        w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
        w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
    } else {
#pragma unroll
        for (int k = 0; k < kPer / 4; ++k) f[k] = 0;
#pragma unroll
        for (int k = 0; k < kPer / 2; ++k) w[k] = 0;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            if (s0 + k < n) {
                f[k / 4] |= uint32_t(emit[s0 + k]) << (8 * (k % 4));
                w[k / 2] |= uint32_t(words[s0 + k]) << (16 * (k % 2));
            }
        }
    }
    int32_t c = 0;
#pragma unroll
    for (int k = 0; k < kPer / 4; ++k) {
        f[k] = nonzero_bytes(f[k]);
        c += __popc(f[k]);
    }
    // the tile's count, published first so that later tiles' look-backs
    // wait least; then its words staged in scan order while warp 0 looks
    // back
    int32_t agg;
    int32_t r = fqk::block_exclusive_scan<kThreads>(c, &agg);
    if (threadIdx.x == 0)
        fqk::desc_store(desc + tile, fqk::desc_aggregate(tile, agg));
#pragma unroll
    for (int k = 0; k < kPer / 4; ++k)
        for (uint32_t m = f[k]; m; m &= m - 1) {
            const int s = 4 * k + (__ffs(m) - 1) / 8;   // slot in the run
            stage[r++] = static_cast<uint16_t>(w[s / 2] >> (16 * (s % 2)));
        }
    if (threadIdx.x < 32) {
        const int64_t before = tile ? fqk::look_back(desc, tile, tiles) : 0;
        if (threadIdx.x == 0) {
            if (tile)
                fqk::desc_store(desc + tile, fqk::desc_inclusive(agg, before));
            if (tile == tiles - 1) *count = static_cast<int32_t>(before + agg);
            excl_sh = before;
        }
    }
    __syncthreads();
    const int64_t excl = excl_sh;
    for (int32_t i = threadIdx.x; i < agg; i += kThreads) {
        FQK_BOUND("compact_words", "out", excl + i, n);
        out[excl + i] = stage[i];
    }
}

int64_t tiles_of(int64_t n) { return n > 0 ? (n + kTile - 1) / kTile : 1; }

}  // namespace

extern "C" int64_t fq_compact_words_scratch_bytes(int64_t n) {
    return kHead + 8 * tiles_of(n);
}

// n slots (n < 2^31: the descriptors' prefixes are 32-bit); scratch:
// fq_compact_words_scratch_bytes(n) bytes, 8-byte aligned; out: n u16
// (the dense prefix is out[:count]).
extern "C" int fq_compact_words(const uint16_t* words, const uint8_t* emit,
                                int64_t n, void* scratch, uint16_t* out,
                                int32_t* count, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n < 0 || n >= (int64_t(1) << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t tiles = tiles_of(n);
    cudaError_t rc = cudaMemsetAsync(scratch, 0,
                                     fq_compact_words_scratch_bytes(n), st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    auto* ticket = static_cast<unsigned*>(scratch);
    auto* desc = reinterpret_cast<unsigned long long*>(
        static_cast<char*>(scratch) + kHead);
    const bool vec = ((reinterpret_cast<uintptr_t>(words)
                       | reinterpret_cast<uintptr_t>(emit)) & 15) == 0;
    compact_tile<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        words, emit, n, vec, ticket, desc, tiles, out, count);
    return static_cast<int>(cudaGetLastError());
}
