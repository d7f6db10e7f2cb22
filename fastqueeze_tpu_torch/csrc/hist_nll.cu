// K20 hist_nll: the static code length of an evaluation histogram under
// a trained count table, as the frozen trainer's cost model scores each
// quality-context candidate (pipeline/frozen.py _hist_nll_bits), and
// narrow_rows, the table narrowed to the type it ships in
// (frozen._narrow_np).
//
// The cost of a table c (n_rows, A) over a histogram h of the same shape
// is the sum, over the cells with h > 0 in row-major order, of
// h * (log2 tot - log2 c), with tot the row's total, all in float64.
// The frozen trainer compares these costs between candidates with `<`,
// so the card has to give numpy's float64 bit for bit:
//   - log2 is read from a table the host fills with np.log2, indexed by
//     the count (counts and row totals are integers);
//   - the difference and the product are separate IEEE operations
//     (__dsub_rn, __dmul_rn: no FMA contraction);
//   - the terms are written in numpy's order (the cells' row-major
//     order), compacted, and the host sums them with np.sum, whose
//     pairwise order the card does not reproduce.
// mbits > 0 scores the table mantissa-bucketed to mbits significant bits
// (frozen._mant_bucket: each count rounded down, at least 1), which the
// bucket choice of the shipped tables weighs (frozen._bucket_ship).
//
// Two launches after a memset: nll_rows, a thread a row, sums the row's
// (bucketed) counts into an int64 total and keeps the largest total
// (the host's log2 table must reach it; where it does not, the wrapper
// fills a longer table and runs again); nll_tile, tiles of 4,096 cells
// by atomic ticket as K3: a thread's 16 cells by four 16-byte loads of
// the histogram, the tile's nonzero cells ranked by a block scan, the
// tile's offset by the decoupled look-back of lookback.cuh, the terms
// staged in shared memory in rank order and stored coalesced.  Bound by
// device memory; the bound counts the function's least traffic, the
// table and the histogram read once and 8 B a term written, over which
// the kernel reads the row totals and the table's counts at the nonzero
// cells again.

#include <cstdint>

#include <cuda_runtime.h>

#include "check.cuh"
#include "lane_walk.cuh"
#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                        // cells a thread
constexpr int64_t kTile = int64_t(kThreads) * kPer;
constexpr int64_t kHead = 16;                   // the ticket, padded
constexpr int kRowBlock = 256;

// A count of the table as an int64: u8, u16 (in int16, same bits) or
// int32, mantissa-bucketed where mbits > 0.
template <int W>
__device__ __forceinline__ int64_t count_at(const void* c, int64_t i,
                                            int32_t mbits) {
    int64_t v;
    if constexpr (W == 1)
        v = static_cast<const uint8_t*>(c)[i];
    else if constexpr (W == 2)
        v = static_cast<const uint16_t*>(c)[i];
    else
        v = static_cast<const int32_t*>(c)[i];
    if (mbits > 0) {
        // bit_length, as _mant_bucket's table and its int64 path give it
        // (0 for 0 and below)
        const int32_t bl = v > 0 ? 64 - __clzll(v) : 0;
        const int32_t sh = bl > mbits ? bl - mbits : 0;
        v = (v >> sh) << sh;
        if (v < 1) v = 1;
    }
    return v;
}

template <int W>
__global__ void __launch_bounds__(kRowBlock)
nll_rows(const void* __restrict__ counts, int64_t n_rows, int32_t A,
         int32_t mbits, int64_t* __restrict__ tot,
         unsigned long long* __restrict__ top) {
    const int64_t r = int64_t(blockIdx.x) * kRowBlock + threadIdx.x;
    int64_t t = 0;
    if (r < n_rows) {
        for (int32_t a = 0; a < A; ++a) t += count_at<W>(counts, r * A + a,
                                                         mbits);
        tot[r] = t;
    }
    // the block's largest total, then one atomic a block
    __shared__ int64_t warp_top[kRowBlock / 32];
    int64_t m = t;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const int64_t y = __shfl_xor_sync(0xFFFFFFFFu, m, o);
        m = y > m ? y : m;
    }
    if ((threadIdx.x & 31) == 0) warp_top[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
        int64_t b = 0;
#pragma unroll
        for (int w = 0; w < kRowBlock / 32; ++w)
            b = warp_top[w] > b ? warp_top[w] : b;
        if (b > 0) atomicMax(top, static_cast<unsigned long long>(b));
    }
}

__device__ __forceinline__ double log2_of(const double* __restrict__ tab,
                                          int64_t tab_len, int64_t v) {
    // a value past the table (the wrapper runs again with a longer one)
    // or below 0 reads its last or first entry
    v = v < 0 ? 0 : (v >= tab_len ? tab_len - 1 : v);
    return tab[v];
}

template <int W>
__global__ void __launch_bounds__(kThreads)
nll_tile(const void* __restrict__ counts, const int32_t* __restrict__ hist,
         const int64_t* __restrict__ tot, int64_t n, int32_t A,
         int32_t mbits, bool vec, const double* __restrict__ tab,
         int64_t tab_len, unsigned* __restrict__ ticket,
         unsigned long long* __restrict__ desc, int64_t tiles,
         double* __restrict__ out, int64_t cap_out,
         unsigned long long* __restrict__ count) {
    __shared__ double stage[kTile];
    __shared__ int64_t tile_sh, excl_sh;
    if (threadIdx.x == 0) tile_sh = atomicAdd(ticket, 1u);
    __syncthreads();
    const int64_t tile = tile_sh;
    FQK_BOUND("hist_nll", "tile", tile, tiles);
    const int64_t s0 = tile * kTile + int64_t(threadIdx.x) * kPer;
    int32_t h[kPer];
    if (vec && s0 + kPer <= n) {
        const int4* p = reinterpret_cast<const int4*>(hist + s0);
#pragma unroll
        for (int k = 0; k < kPer / 4; ++k) {
            const int4 x = p[k];
            h[4 * k] = x.x, h[4 * k + 1] = x.y, h[4 * k + 2] = x.z,
            h[4 * k + 3] = x.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k) h[k] = s0 + k < n ? hist[s0 + k] : 0;
    }
    int32_t c = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) c += h[k] > 0;
    int32_t agg;
    int32_t rank = fqk::block_exclusive_scan<kThreads>(c, &agg);
    if (threadIdx.x == 0)
        fqk::desc_store(desc + tile, fqk::desc_aggregate(tile, agg));
    // the terms, staged in rank order while warp 0 looks back
    if (c) {
        int64_t row = s0 / A;
        int32_t col = static_cast<int32_t>(s0 - row * A);
        double lt = log2_of(tab, tab_len, tot[row]);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            if (h[k] > 0) {
                const double lc = log2_of(
                    tab, tab_len, count_at<W>(counts, s0 + k, mbits));
                stage[rank++] = __dmul_rn(static_cast<double>(h[k]),
                                          __dsub_rn(lt, lc));
            }
            if (++col == A && k + 1 < kPer && s0 + k + 1 < n) {
                col = 0;
                lt = log2_of(tab, tab_len, tot[++row]);
            }
        }
    }
    if (threadIdx.x < 32) {
        const int64_t before = tile ? fqk::look_back(desc, tile, tiles) : 0;
        if (threadIdx.x == 0) {
            if (tile)
                fqk::desc_store(desc + tile, fqk::desc_inclusive(agg, before));
            if (tile == tiles - 1)
                *count = static_cast<unsigned long long>(before + agg);
            excl_sh = before;
        }
    }
    __syncthreads();
    const int64_t excl = excl_sh;
    for (int32_t i = threadIdx.x; i < agg; i += kThreads)
        if (excl + i < cap_out) out[excl + i] = stage[i];
}

int64_t tiles_of(int64_t n) { return n > 0 ? (n + kTile - 1) / kTile : 1; }

template <int W>
int launch_nll(const void* counts, const int32_t* hist, int64_t n_rows,
               int32_t A, int32_t mbits, const double* tab, int64_t tab_len,
               double* terms, int64_t cap_terms, unsigned long long* stat,
               void* scratch, cudaStream_t st) {
    const int64_t n = n_rows * A;
    const int64_t tiles = tiles_of(n);
    auto* ticket = static_cast<unsigned*>(scratch);
    auto* desc = reinterpret_cast<unsigned long long*>(
        static_cast<char*>(scratch) + kHead);
    auto* tot = reinterpret_cast<int64_t*>(desc + tiles);
    const unsigned row_blocks = static_cast<unsigned>(
        n_rows > 0 ? (n_rows + kRowBlock - 1) / kRowBlock : 1);
    nll_rows<W><<<row_blocks, kRowBlock, 0, st>>>(counts, n_rows, A, mbits,
                                                  tot, stat + 1);
    const bool vec = (reinterpret_cast<uintptr_t>(hist) & 15) == 0;
    nll_tile<W><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        counts, hist, tot, n, A, mbits, vec, tab, tab_len, ticket, desc,
        tiles, terms, cap_terms, stat);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void narrow_kernel(const int32_t* __restrict__ in, int64_t n_out,
                              int32_t A, int32_t step, T* __restrict__ out) {
    for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
         i < n_out; i += int64_t(gridDim.x) * blockDim.x) {
        const int64_t r = i / A;
        const int64_t a = i - r * A;
        // the low bits, as numpy's astype to a narrower unsigned type
        out[i] = static_cast<T>(static_cast<uint32_t>(
            in[r * step * A + a]));
    }
}

}  // namespace

// Bytes of hist_nll's scratch for a table of n_rows x A cells: the
// ticket, a descriptor a tile, an int64 total a row.
extern "C" int64_t fq_hist_nll_scratch_bytes(int64_t n_rows, int32_t A) {
    return kHead + 8 * tiles_of(n_rows * A) + 8 * (n_rows > 0 ? n_rows : 1);
}

// counts: (n_rows, A) table of `width` bytes a count (1: u8, 2: u16,
// 4: int32); hist: (n_rows, A) int32; tab: tab_len float64, tab[v] =
// log2(v); terms: cap_terms float64; stat: 2 x u64, stat[0] = the terms'
// count (terms[:stat[0]] is written where it is at most cap_terms),
// stat[1] = the largest row total (the terms are exact where it is below
// tab_len).  n_rows * A < 2^31 (the descriptors' prefixes are 32-bit).
extern "C" int fq_hist_nll(const void* counts, int32_t width,
                           const int32_t* hist, int64_t n_rows, int32_t A,
                           int32_t mbits, const double* tab, int64_t tab_len,
                           double* terms, int64_t cap_terms,
                           unsigned long long* stat, void* scratch,
                           void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (A < 1 || n_rows < 0 || n_rows * A >= (int64_t(1) << 31)
            || tab_len < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t rc = cudaMemsetAsync(
        scratch, 0, kHead + 8 * tiles_of(n_rows * A), st);
    if (rc == cudaSuccess)
        rc = cudaMemsetAsync(stat, 0, 2 * sizeof(unsigned long long), st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    switch (width) {
        case 1:
            return launch_nll<1>(counts, hist, n_rows, A, mbits, tab,
                                 tab_len, terms, cap_terms, stat, scratch,
                                 st);
        case 2:
            return launch_nll<2>(counts, hist, n_rows, A, mbits, tab,
                                 tab_len, terms, cap_terms, stat, scratch,
                                 st);
        case 4:
            return launch_nll<4>(counts, hist, n_rows, A, mbits, tab,
                                 tab_len, terms, cap_terms, stat, scratch,
                                 st);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// out (ceil(n_rows / step), A) = rows 0, step, 2 step, ... of the int32
// table `in` (n_rows, A), each count's low 8 (width 1) or 16 (width 2)
// bits or the count itself (width 4).
extern "C" int fq_narrow_rows(const int32_t* in, int64_t n_rows, int32_t A,
                              int32_t step, int32_t width, void* out,
                              void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (A < 1 || step < 1 || n_rows < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n_out = (n_rows + step - 1) / step * A;
    if (n_out == 0) return 0;
    const int threads = 256;
    const int64_t want = (n_out + threads - 1) / threads;
    const unsigned blocks = static_cast<unsigned>(want < 65536 ? want
                                                               : 65536);
    switch (width) {
        case 1:
            narrow_kernel<uint8_t><<<blocks, threads, 0, st>>>(
                in, n_out, A, step, static_cast<uint8_t*>(out));
            break;
        case 2:
            narrow_kernel<uint16_t><<<blocks, threads, 0, st>>>(
                in, n_out, A, step, static_cast<uint16_t*>(out));
            break;
        case 4:
            narrow_kernel<int32_t><<<blocks, threads, 0, st>>>(
                in, n_out, A, step, static_cast<int32_t*>(out));
            break;
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
