// K1 quant_pack: frozen count table -> quantized cumulative frequencies.
//
// Replaces fastqueeze_tpu/ops/engine.py _quant / _quant_full and the
// table half of _pass1_frozen (B3), and _widen_i32 (counts0_dev): the
// count table is read in the type it travels in, u8, u16 or i32 (frozen
// tables are narrow: the seq cap is under 2^8, the qual caps under 2^16),
// so the upload moves the narrow table and no widened copy is made.  Per
// context row: F[0] = 0, F[i] = floor(cum_i * 2^14 / C) (equal to the
// reference's two 7-bit division digits, which exist only because JAX
// runs without int64).  Writes the (n_ctx, A+1) u16 table the decoder
// searches and the (n_ctx * A) u32 words F[s] | F[s+1] << 16 the encoder
// gathers once per symbol.  Runs once per table and device (the result
// is cached).
//
// Bound by device memory: 1-4 B read and 6 B written per entry.  One
// launch.  A block takes a tile of rows and moves its counts into shared
// memory and its cum and packed entries out (contiguous runs of the
// three arrays) with coalesced 16-byte loads and stores.  A <= 8 (the seq
// table, A = 4): a thread a row, a tile of 256 rows.  Above (the quality
// tables have A = 40-64): a row goes to a group of G = 8, 16 or 32 lanes,
// lane i on k = ceil(A / G) consecutive counts: the lanes' sums, an
// inclusive __shfl_up_sync scan over the group (its last lane's is the
// total), then each lane quantizes its run from the scan's exclusive
// prefix; a tile of up to 256 rows and 40 KB, and a row too wide for one
// is read and written where it lies.  No division a symbol: a row takes
// one fp32 reciprocal of its total, a symbol an estimate of its quotient
// from it (within one of the true quotient) and one exact integer
// correction from the remainder (32-bit words for narrow tables, whose
// rows total under 2^30; 64-bit for i32, exact for every total below
// 2^49).  The first K1 (a thread a row, reads and writes strided by the
// row, a 64-bit division a symbol) took 0.095 ms on the i32 seq table
// and 0.129-0.144 ms on the u16 qual table A = 48 on an H100; a warp a
// row (two passes over the row, 32 lanes whatever A) took 0.237 ms on a
// 2^20 x 41 u16 table, the lane groups 0.179.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmallA = 8;                      // widest row of a thread
constexpr int kMaxRows = 256;                   // rows a group tile
constexpr int kTileBytes = 40960;               // a group tile's runs

// floor(c * 2^14 / tot) for 0 <= c <= tot, 1 <= tot, with
// rf = __fdividef(2^14, float(tot)).  float(c), float(tot), rf (2 ulp)
// and the product (toward zero) each err by under 2^-22 relative, so the
// estimate of a quotient of at most 2^14 is off by under 2^-7 and its
// floor by at most one; the remainder c * 2^14 - q * tot, in [-tot,
// 2 tot), says which way.  It is exact modulo the word: 32 bits for
// tot < 2^30 (narrow tables), 64 for tot < 2^49 (any row of positive
// int32 counts whose cum * 2^14 fits the accumulator).
__device__ __forceinline__ uint32_t quant(uint32_t c, uint32_t tot,
                                          float rf) {
    const int32_t q = __float2int_rz(__fmul_rz(static_cast<float>(c), rf));
    const int32_t rem = static_cast<int32_t>((c << 14) - uint32_t(q) * tot);
    return static_cast<uint32_t>(q + (rem >= static_cast<int32_t>(tot))
                                 - (rem < 0));
}

__device__ __forceinline__ uint32_t quant(int64_t c, int64_t tot, float rf) {
    const int32_t q = __float2int_rz(__fmul_rz(static_cast<float>(c), rf));
    const int64_t rem = static_cast<int64_t>(
        (uint64_t(c) << 14) - uint64_t(q) * uint64_t(tot));
    return static_cast<uint32_t>(q + (rem >= tot) - (rem < 0));
}

// nb bytes src -> dst, the block's threads on consecutive 16-byte words
// where vec (both 16-byte aligned), then on the bytes left.
__device__ __forceinline__ void copy_tile(uint8_t* __restrict__ dst,
                                          const uint8_t* __restrict__ src,
                                          int64_t nb, bool vec) {
    int64_t done = 0;
    if (vec) {
        const int64_t n16 = nb / 16;
        for (int64_t i = threadIdx.x; i < n16; i += kThreads)
            reinterpret_cast<uint4*>(dst)[i] =
                reinterpret_cast<const uint4*>(src)[i];
        done = 16 * n16;
    }
    for (int64_t i = done + threadIdx.x; i < nb; i += kThreads)
        dst[i] = src[i];
}

__device__ __forceinline__ int64_t align16(int64_t n) {
    return (n + 15) & ~int64_t(15);
}

// A <= kSmallA: a block a tile of kThreads rows, a thread a row in shared
// memory.  The tile's counts, cum and packed entries start at multiples
// of 16 bytes (kThreads * A * width, kThreads * (A + 1) * 2 and
// kThreads * A * 4 are), so vec holds for every tile where it holds for
// the arrays.  S: the accumulator (32 bits for narrow counts).
template <typename C, typename S>
__global__ void __launch_bounds__(kThreads)
quant_rows_small(const C* __restrict__ counts, int64_t n_ctx, int32_t A,
                 bool vec, uint16_t* __restrict__ cum,
                 uint32_t* __restrict__ packed) {
    __shared__ __align__(16) uint8_t in_sh[kThreads * kSmallA * 4];
    __shared__ __align__(16) uint8_t cum_sh[kThreads * (kSmallA + 1) * 2];
    __shared__ __align__(16) uint8_t pk_sh[kThreads * kSmallA * 4];
    const int64_t r0 = int64_t(blockIdx.x) * kThreads;
    const int32_t rows = static_cast<int32_t>(min(int64_t(kThreads),
                                                  n_ctx - r0));
    copy_tile(in_sh, reinterpret_cast<const uint8_t*>(counts + r0 * A),
              int64_t(rows) * A * sizeof(C), vec);
    __syncthreads();
    if (static_cast<int32_t>(threadIdx.x) < rows) {
        const C* row = reinterpret_cast<const C*>(in_sh) + threadIdx.x * A;
        S tot = 0;
        for (int32_t a = 0; a < A; ++a) tot += static_cast<S>(row[a]);
        if (tot < 1) tot = 1;   // unreachable: trained tables have init >= 1
        const float rf = __fdividef(16384.0f, static_cast<float>(tot));
        uint16_t* out = reinterpret_cast<uint16_t*>(cum_sh)
                        + threadIdx.x * (A + 1);
        uint32_t* pk = reinterpret_cast<uint32_t*>(pk_sh) + threadIdx.x * A;
        S acc = 0;
        uint32_t prev = 0;
        out[0] = 0;
        for (int32_t a = 0; a < A; ++a) {
            acc += static_cast<S>(row[a]);
            const uint32_t F = quant(acc, tot, rf);
            out[a + 1] = static_cast<uint16_t>(F);
            pk[a] = prev | (F << 16);
            prev = F;
        }
    }
    __syncthreads();
    copy_tile(reinterpret_cast<uint8_t*>(cum + r0 * (A + 1)), cum_sh,
              int64_t(rows) * (A + 1) * 2, vec);
    copy_tile(reinterpret_cast<uint8_t*>(packed + r0 * A), pk_sh,
              int64_t(rows) * A * 4, vec);
}

// One row, one group of G lanes (lane g of it, the group's lanes under
// ``mask``): lane g sums counts [g k, g k + k), the group scans the sums
// (the last lane's inclusive sum is the total), and lane g quantizes its
// run from its exclusive prefix, F[g k] first (F[0] = 0 for lane 0).
// live: the group has a row (a group without one still takes part in the
// shuffles).  S: the accumulator (32 bits for narrow counts).
template <typename C, typename S>
__device__ __forceinline__ void group_row(const C* row, int32_t A, int32_t G,
                                          int32_t k, int g, unsigned mask,
                                          bool live,
                                          uint16_t* __restrict__ out,
                                          uint32_t* __restrict__ pk) {
    const int32_t a0 = min(g * k, A), a1 = live ? min(a0 + k, A) : a0;
    S part = 0;
    for (int32_t a = a0; a < a1; ++a) part += static_cast<S>(row[a]);
    S inc = part;
    for (int d = 1; d < G; d <<= 1) {
        const S y = __shfl_up_sync(mask, inc, d, G);
        if (g >= d) inc += y;
    }
    S tot = __shfl_sync(mask, inc, G - 1, G);
    if (tot < 1) tot = 1;       // unreachable: trained tables have init >= 1
    const float rf = __fdividef(16384.0f, static_cast<float>(tot));
    S acc = inc - part;
    uint32_t prev = quant(acc, tot, rf);
    if (live && g == 0) out[0] = 0;
    for (int32_t a = a0; a < a1; ++a) {
        acc += static_cast<S>(row[a]);
        const uint32_t F = quant(acc, tot, rf);
        out[a + 1] = static_cast<uint16_t>(F);
        pk[a] = prev | (F << 16);
        prev = F;
    }
}

// A > kSmallA: a block a tile of ``rows`` rows, its kThreads / G groups
// (G = 2^lg) on rows g, g + kThreads / G, ...  kStage: the tile's counts
// move into shared memory and its cum and packed entries out of it, each
// a contiguous run copied with 16-byte words where vec (every run starts
// 16-byte aligned); else (rows too wide for kTileBytes, a block
// kThreads / G rows) the groups read and write device memory.
template <typename C, typename S, bool kStage>
__global__ void __launch_bounds__(kThreads)
quant_rows_group(const C* __restrict__ counts, int64_t n_ctx, int32_t A,
                 int32_t lg, int32_t rows, bool vec,
                 uint16_t* __restrict__ cum, uint32_t* __restrict__ packed) {
    __shared__ __align__(16) uint8_t sh[kStage ? kTileBytes : 16];
    const int64_t r0 = int64_t(blockIdx.x) * rows;
    const int32_t n = static_cast<int32_t>(min(int64_t(rows), n_ctx - r0));
    const int64_t in_bytes = int64_t(n) * A * sizeof(C);
    const int64_t cum_off = align16(int64_t(rows) * A * sizeof(C));
    const int64_t pk_off = cum_off + align16(int64_t(rows) * (A + 1) * 2);
    const C* in = counts + r0 * A;
    uint16_t* cum_t = cum + r0 * (A + 1);
    uint32_t* pk_t = packed + r0 * A;
    if (kStage) {
        copy_tile(sh, reinterpret_cast<const uint8_t*>(in), in_bytes, vec);
        __syncthreads();
        in = reinterpret_cast<const C*>(sh);
        cum_t = reinterpret_cast<uint16_t*>(sh + cum_off);
        pk_t = reinterpret_cast<uint32_t*>(sh + pk_off);
    }
    const int32_t G = 1 << lg, groups = kThreads >> lg;
    const int32_t k = (A + G - 1) >> lg;
    const int g = threadIdx.x & (G - 1);
    const int lane0 = (threadIdx.x & 31) - g;
    const unsigned mask = (G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u))
                          << lane0;
    for (int32_t i0 = 0; i0 < n; i0 += groups) {
        const int32_t i = i0 + static_cast<int32_t>(threadIdx.x >> lg);
        const bool live = i < n;
        const int64_t ir = live ? i : 0;
        group_row<C, S>(in + ir * A, A, G, k, g, mask, live,
                        cum_t + ir * (A + 1), pk_t + ir * A);
    }
    if (kStage) {
        __syncthreads();
        copy_tile(reinterpret_cast<uint8_t*>(cum + r0 * (A + 1)),
                  sh + cum_off, int64_t(n) * (A + 1) * 2, vec);
        copy_tile(reinterpret_cast<uint8_t*>(packed + r0 * A), sh + pk_off,
                  int64_t(n) * A * 4, vec);
    }
}

template <typename C>
int launch(const void* counts, int64_t n_ctx, int32_t A, uint16_t* cum,
           uint32_t* packed, cudaStream_t st) {
    // narrow counts: a row that fits a tile totals under 2^30
    using S = typename std::conditional<sizeof(C) < 4, uint32_t,
                                        int64_t>::type;
    const C* c = static_cast<const C*>(counts);
    const bool aligned = ((reinterpret_cast<uintptr_t>(counts)
                           | reinterpret_cast<uintptr_t>(cum)
                           | reinterpret_cast<uintptr_t>(packed)) & 15) == 0;
    if (A <= kSmallA) {
        quant_rows_small<C, S><<<static_cast<unsigned>(
                                     (n_ctx + kThreads - 1) / kThreads),
                                 kThreads, 0, st>>>(c, n_ctx, A, aligned, cum,
                                                    packed);
        return static_cast<int>(cudaGetLastError());
    }
    const int32_t lg = A <= 32 ? 3 : A <= 64 ? 4 : 5;    // G = 2^lg lanes
    // a row's shared memory in a tile: counts, cum and packed entries
    const int64_t row_bytes = int64_t(A) * (sizeof(C) + 6) + 2;
    int64_t rows = std::min(int64_t(kMaxRows),
                            (kTileBytes - 32) / row_bytes);
    if (rows >= 16) rows &= ~int64_t(15);       // runs start 16-aligned
    else if (rows >= 8) rows &= ~int64_t(7);
    if (rows >= 1) {
        const bool vec = aligned && (rows * A * int64_t(sizeof(C))) % 16 == 0
                         && (rows * (A + 1) * 2) % 16 == 0
                         && (rows * A * 4) % 16 == 0;
        quant_rows_group<C, S, true><<<static_cast<unsigned>(
                                           (n_ctx + rows - 1) / rows),
                                       kThreads, 0, st>>>(
            c, n_ctx, A, lg, static_cast<int32_t>(rows), vec, cum, packed);
    } else {
        const int32_t per_block = kThreads >> lg;
        quant_rows_group<C, int64_t, false><<<static_cast<unsigned>(
                                                  (n_ctx + per_block - 1)
                                                  / per_block),
                                              kThreads, 0, st>>>(
            c, n_ctx, A, lg, per_block, false, cum, packed);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// width: bytes a count, 1 (u8), 2 (u16) or 4 (i32).  One launch.
extern "C" int fq_quant_pack(const void* counts, int64_t n_ctx, int32_t A,
                             int32_t width, uint16_t* cum, uint32_t* packed,
                             void* stream) {
    if (A < 0 || n_ctx < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (n_ctx == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (width == 1) return launch<uint8_t>(counts, n_ctx, A, cum, packed, st);
    if (width == 2) return launch<uint16_t>(counts, n_ctx, A, cum, packed, st);
    if (width == 4) return launch<int32_t>(counts, n_ctx, A, cum, packed, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
