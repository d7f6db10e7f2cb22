// K4 frozen_decode: frozen-table rANS decode of one stream, one CTA.
//
// Replaces fastqueeze_tpu/ops/engine.py _device_aux (B1) and
// _decode_frozen (B6).  Every wave needs an exclusive scan across all
// lanes (a lane that renormalizes reads the word at off + its rank among
// the lanes that renormalize), so one CTA owns the whole stream and each
// thread owns ceil(L / blockDim) consecutive lanes: lane order is thread
// order, then order within the thread.  Per wave the CTA
//   1. steps each lane's read cursor and model state and computes its
//      context,
//   2. binary-searches the u16 cumulative row for the largest s with
//      F[s] <= low (rows are strictly increasing, so any search variant
//      gives the reference's symbol),
//   3. runs the rANS decode and a block-wide exclusive scan of `need`,
//   4. reads words[min(off + rank, W - 1)] into the lanes that need one
//      (the clamp keeps a corrupt payload inside the padded buffer, as
//      the reference's clamp does), and advances off.
// Lane state lives in a global scratch array (L2-resident: 64 B a lane),
// so any L up to the 2^16 lanes the format allows fits.  One CTA per
// stream leaves all other SMs idle: the wave loop is latency-bound on
// the dependent table fetches and the two barriers of each wave's scan.

#include <cstdint>

#include <cuda_runtime.h>

#include "lane_walk.cuh"

namespace {

using fqk::ModelSpec;
using fqk::ModelState;
using fqk::ReadCursor;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct Lane {
    ModelState s;
    ReadCursor cur;
    uint32_t x;       // rANS state
    uint32_t xn;      // this wave's state before renormalization
    int32_t n;        // symbols in the lane
    int32_t sym;      // this wave's symbol
};

// Exclusive block-wide scan of one int per thread; *total gets the sum.
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v,
                                                        int32_t* total) {
    __shared__ int32_t warp_sums[kWarps];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int32_t inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
        if (lane >= d) inc += y;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int32_t w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int32_t y = __shfl_up_sync(0xFFFFFFFFu, w, d);
            if (lane >= d) w += y;
        }
        if (lane < kWarps) warp_sums[lane] = w;
    }
    __syncthreads();
    const int32_t before = warp > 0 ? warp_sums[warp - 1] : 0;
    *total = warp_sums[kWarps - 1];
    __syncthreads();
    return before + inc - v;
}

template <bool QUAL>
__global__ void __launch_bounds__(kThreads)
frozen_decode(const uint32_t* __restrict__ states0,
              const uint16_t* __restrict__ words, int64_t W,
              const int32_t* __restrict__ cgrid, int32_t J, int32_t T,
              int32_t L, const uint16_t* __restrict__ cum, int32_t A,
              ModelSpec m, Lane* __restrict__ lanes,
              uint8_t* __restrict__ out) {
    const int32_t per = (L + kThreads - 1) / kThreads;
    const int32_t l0 = threadIdx.x * per;
    const int32_t l1 = min(l0 + per, L);
    for (int32_t l = l0; l < l1; ++l) {
        Lane& ln = lanes[l];
        fqk::model_reset<QUAL>(m, ln.s);
        ln.cur = ReadCursor{-1, 0, 0};
        ln.x = states0[l];
        ln.n = fqk::lane_length(cgrid, J, L, l);
    }
    int64_t off = 0;
    for (int32_t t = 0; t < T; ++t) {
        int32_t need = 0;
        for (int32_t l = l0; l < l1; ++l) {
            Lane& ln = lanes[l];
            if (t >= ln.n) continue;
            if (fqk::cursor_next(ln.cur, cgrid, J, L, l))
                fqk::model_reset<QUAL>(m, ln.s);
            const int64_t ctx = fqk::model_ctx<QUAL>(m, ln.s, ln.cur.pos);
            const uint16_t* row = cum + ctx * (A + 1);
            const uint32_t low = ln.x & fqk::kMaskM;
            int32_t lo = 0, hi = A - 1;
            while (lo < hi) {
                const int32_t mid = (lo + hi + 1) >> 1;
                if (row[mid] <= low) lo = mid;
                else hi = mid - 1;
            }
            const uint32_t start = row[lo];
            const uint32_t f = row[lo + 1] - start;
            ln.xn = f * (ln.x >> fqk::kProbBits) + low - start;
            ln.sym = lo;
            need += ln.xn < fqk::kRansL;
        }
        int32_t total;
        int64_t w = off + block_exclusive_scan(need, &total);
        for (int32_t l = l0; l < l1; ++l) {
            Lane& ln = lanes[l];
            const int64_t idx = int64_t(t) * L + l;
            if (t >= ln.n) {
                out[idx] = 0;
                continue;
            }
            uint32_t xn = ln.xn;
            if (xn < fqk::kRansL) {
                xn = (xn << 16) | words[w < W ? w : W - 1];
                ++w;
            }
            ln.x = xn;
            out[idx] = static_cast<uint8_t>(ln.sym);
            fqk::model_update<QUAL>(m, ln.s, ln.sym);
            --ln.cur.rem;
            ++ln.cur.pos;
        }
        off += total;
    }
}

}  // namespace

// lanes: scratch of L * sizeof(Lane) bytes (fq_decode_lane_bytes()).
extern "C" int64_t fq_decode_lane_bytes() { return sizeof(Lane); }

extern "C" int fq_frozen_decode(
        const uint32_t* states0, const uint16_t* words, int64_t W,
        const int32_t* cgrid, int32_t J, int32_t T, int32_t L,
        const uint16_t* cum, int32_t A, int32_t kind, int64_t a, int64_t b,
        int64_t c, int64_t d, int64_t e, int64_t f, int64_t g, void* lanes,
        uint8_t* out, void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    Lane* ls = static_cast<Lane*>(lanes);
    if (kind == 0)
        frozen_decode<false><<<1, kThreads, 0, st>>>(
            states0, words, W, cgrid, J, T, L, cum, A, m, ls, out);
    else if (kind == 1)
        frozen_decode<true><<<1, kThreads, 0, st>>>(
            states0, words, W, cgrid, J, T, L, cum, A, m, ls, out);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}
