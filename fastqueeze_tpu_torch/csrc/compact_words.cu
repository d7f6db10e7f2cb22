// K3 compact_words: stream compaction of the emitted rANS words into a
// dense prefix in canonical (wave, lane) order, plus the word count.
//
// Replaces fastqueeze_tpu/ops/engine.py _compact_words (B5: an exclusive
// cumsum of the emit flags, then a scatter).  Three launches:
//   A. each block counts the flags of its tile of kTile slots;
//   B. one block scans the tile counts (exclusive) and writes the total;
//   C. each block rescans its tile and scatters its words to
//      out[tile offset + rank].
// Bound by device-memory traffic: 3 B read per slot in A and C, 2 B
// written per emitted word; the scans are block-local in shared memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 8;                  // consecutive slots per thread
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

// Exclusive block-wide scan of one int per thread; *total gets the sum.
__device__ __forceinline__ int64_t block_exclusive_scan(int64_t v,
                                                        int64_t* total) {
    __shared__ int64_t warp_sums[kWarps];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int64_t inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int64_t y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
        if (lane >= d) inc += y;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int64_t w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int64_t y = __shfl_up_sync(0xFFFFFFFFu, w, d);
            if (lane >= d) w += y;
        }
        if (lane < kWarps) warp_sums[lane] = w;   // inclusive warp prefix
    }
    __syncthreads();
    const int64_t before = warp > 0 ? warp_sums[warp - 1] : 0;
    *total = warp_sums[kWarps - 1];
    __syncthreads();                            // warp_sums is reused
    return before + inc - v;
}

__global__ void tile_counts(const uint8_t* __restrict__ emit, int64_t n,
                            int64_t* __restrict__ tile_sum) {
    const int64_t base = int64_t(blockIdx.x) * kTile
                         + int64_t(threadIdx.x) * kItems;
    int64_t c = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i)
        if (base + i < n) c += emit[base + i] != 0;
    int64_t total;
    block_exclusive_scan(c, &total);
    if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
}

__global__ void scan_tiles(int64_t* __restrict__ tile_sum, int64_t n_tiles,
                           int32_t* __restrict__ count) {
    int64_t carry = 0;
    for (int64_t s = 0; s < n_tiles; s += kThreads) {
        const int64_t i = s + threadIdx.x;
        const int64_t v = i < n_tiles ? tile_sum[i] : 0;
        int64_t total;
        const int64_t ex = block_exclusive_scan(v, &total);
        if (i < n_tiles) tile_sum[i] = carry + ex;
        carry += total;
    }
    if (threadIdx.x == 0) *count = static_cast<int32_t>(carry);
}

__global__ void tile_scatter(const uint16_t* __restrict__ words,
                             const uint8_t* __restrict__ emit, int64_t n,
                             const int64_t* __restrict__ tile_off,
                             uint16_t* __restrict__ out) {
    const int64_t base = int64_t(blockIdx.x) * kTile
                         + int64_t(threadIdx.x) * kItems;
    uint8_t e[kItems];
    int64_t c = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
        e[i] = base + i < n ? emit[base + i] : 0;
        c += e[i] != 0;
    }
    int64_t total;
    int64_t o = tile_off[blockIdx.x] + block_exclusive_scan(c, &total);
#pragma unroll
    for (int i = 0; i < kItems; ++i)
        if (e[i]) out[o++] = words[base + i];
}

}  // namespace

// tile_sum: scratch of ceil(n / 8192) int64.  out: n u16 (the dense
// prefix is out[:count]).
extern "C" int fq_compact_words(const uint16_t* words, const uint8_t* emit,
                                int64_t n, int64_t* tile_sum,
                                uint16_t* out, int32_t* count,
                                void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t n_tiles = (n + kTile - 1) / kTile;
    if (n_tiles > 0) {
        tile_counts<<<n_tiles, kThreads, 0, st>>>(emit, n, tile_sum);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    scan_tiles<<<1, kThreads, 0, st>>>(tile_sum, n_tiles, count);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_tiles == 0) return static_cast<int>(err);
    tile_scatter<<<n_tiles, kThreads, 0, st>>>(words, emit, n, tile_sum,
                                               out);
    return static_cast<int>(cudaGetLastError());
}
