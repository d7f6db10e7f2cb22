// K6 adapt_decode: adaptive rANS decode of one stream, one CTA.
//
// Replaces fastqueeze_tpu/ops/engine.py _device_aux (B1), the models'
// lane walk (B2, B2'), _quant per row (B3) and _decode with
// _wave_update_tot (B8).  Every wave needs a scan across all lanes (the
// renorm word of a lane is at off + its rank among the lanes that
// renormalize) and reads the table the previous wave updated, so one CTA
// owns the stream; each thread owns ceil(L / 1024) consecutive lanes, so
// lane order is thread order.  Per wave:
//   1. each valid lane steps its cursor and model and takes its context;
//      from the PRE-update row (total C) the symbol is the number of
//      s in 1..A-1 with F[s] = floor(cum_s * 2^14 / C) <= low, i.e. with
//      cum_s <= ((low + 1) * C - 1) >> 14 (a linear scan over the row);
//      start = F[sym], freq = F[sym + 1] - start from the same row;
//   2. rANS decode and a block-wide exclusive scan of `need` (its
//      barriers also separate step 1's row reads from step 3's adds);
//   3. renorm reads words[min(off + rank, W - 1)], then the table update:
//      atomicAdd at (ctx, sym) and tot[ctx]; one lane per touched row is
//      elected by stamp[ctx];
//   -- barrier --
//   4. the elected lane halves its row while over cap, at most n_halve
//      times;
//   -- barrier: the next wave must not read half-halved rows --
// Padding lanes are skipped (every row stays at or under cap; the
// wrapper checks init * A <= cap).  Bound: one SM, dependent L2 reads of
// the table rows, and five barriers per wave.

#include <cstdint>

#include <cuda_runtime.h>

#include "lane_walk.cuh"

namespace {

using fqk::ModelSpec;
using fqk::ModelState;
using fqk::ReadCursor;

constexpr int kThreads = 1024;

struct Lane {
    ModelState s;
    ReadCursor cur;
    int64_t ctx;      // this wave's context
    uint32_t x;       // rANS state
    uint32_t xn;      // this wave's state before renormalization
    int32_t n;        // symbols in the lane
    int32_t sym;      // this wave's symbol
    int32_t fix;      // rescales row ctx after this wave
};

template <int KIND>
__global__ void __launch_bounds__(kThreads)
adapt_decode(const uint32_t* __restrict__ states0,
             const uint16_t* __restrict__ words, int64_t W,
             const int32_t* __restrict__ cgrid, int32_t J, int32_t T,
             int32_t L, const int32_t* __restrict__ ctxg, int32_t A,
             ModelSpec m, int32_t inc, int32_t cap, int32_t n_halve,
             int32_t* counts, int32_t* tot, int32_t* stamp,
             Lane* __restrict__ lanes, uint8_t* __restrict__ out) {
    const int32_t per = (L + kThreads - 1) / kThreads;
    const int32_t l0 = threadIdx.x * per;
    const int32_t l1 = min(l0 + per, L);
    for (int32_t l = l0; l < l1; ++l) {
        Lane& ln = lanes[l];
        fqk::model_reset<KIND>(m, ln.s);
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
                fqk::model_reset<KIND>(m, ln.s);
            const int64_t ctx = fqk::lane_ctx<KIND>(
                m, ln.s, ln.cur.pos, ctxg, int64_t(t) * L + l);
            const int32_t* row = counts + ctx * A;
            const int64_t C = __ldcg(tot + ctx);
            const uint32_t low = ln.x & fqk::kMaskM;
            const int64_t th = ((int64_t(low) + 1) * C - 1) >> fqk::kProbBits;
            int32_t sym = 0;
            int64_t cum = 0;                    // cum_sym
            int64_t nxt = __ldcg(row);          // cum_{sym+1}
            while (sym < A - 1 && nxt <= th) {
                cum = nxt;
                ++sym;
                nxt += __ldcg(row + sym);
            }
            const uint32_t start =
                static_cast<uint32_t>((cum << fqk::kProbBits) / C);
            const uint32_t f =
                static_cast<uint32_t>((nxt << fqk::kProbBits) / C) - start;
            ln.xn = f * (ln.x >> fqk::kProbBits) + low - start;
            ln.sym = sym;
            ln.ctx = ctx;
            need += ln.xn < fqk::kRansL;
        }
        int32_t total;
        int64_t w = off + fqk::block_exclusive_scan<kThreads>(need, &total);
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
            ln.fix = fqk::table_add(counts, tot, stamp, ln.ctx, A, ln.sym,
                                    inc, t);
            fqk::model_update<KIND>(m, ln.s, ln.sym);
            --ln.cur.rem;
            ++ln.cur.pos;
        }
        off += total;
        __syncthreads();
        for (int32_t l = l0; l < l1; ++l) {
            const Lane& ln = lanes[l];
            if (t < ln.n && ln.fix)
                fqk::table_rescale(counts, tot, ln.ctx, A, cap, n_halve);
        }
        __syncthreads();
    }
}

template <int KIND>
int launch(const uint32_t* states0, const uint16_t* words, int64_t W,
           const int32_t* cgrid, int32_t J, int32_t T, int32_t L,
           const int32_t* ctxg, int32_t A, const ModelSpec& m, int32_t inc,
           int32_t cap, int32_t n_halve, int32_t* counts, int32_t* tot,
           int32_t* stamp, void* lanes, uint8_t* out, cudaStream_t st) {
    adapt_decode<KIND><<<1, kThreads, 0, st>>>(
        states0, words, W, cgrid, J, T, L, ctxg, A, m, inc, cap, n_halve,
        counts, tot, stamp, static_cast<Lane*>(lanes), out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lanes: scratch of L * fq_adapt_decode_lane_bytes() bytes; counts, tot
// and stamp as for fq_adapt_encode_walk.
extern "C" int64_t fq_adapt_decode_lane_bytes() { return sizeof(Lane); }

extern "C" int fq_adapt_decode(
        const uint32_t* states0, const uint16_t* words, int64_t W,
        const int32_t* cgrid, int32_t J, int32_t T, int32_t L,
        const int32_t* ctxg, int32_t A, int32_t kind, int64_t a, int64_t b,
        int64_t c, int64_t d, int64_t e, int64_t f, int64_t g, int32_t inc,
        int32_t cap, int32_t n_halve, int32_t* counts, int32_t* tot,
        int32_t* stamp, void* lanes, uint8_t* out, void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (kind) {
        case 0: return launch<0>(states0, words, W, cgrid, J, T, L, ctxg, A,
                                 m, inc, cap, n_halve, counts, tot, stamp,
                                 lanes, out, st);
        case 1: return launch<1>(states0, words, W, cgrid, J, T, L, ctxg, A,
                                 m, inc, cap, n_halve, counts, tot, stamp,
                                 lanes, out, st);
        case 2: return launch<2>(states0, words, W, cgrid, J, T, L, ctxg, A,
                                 m, inc, cap, n_halve, counts, tot, stamp,
                                 lanes, out, st);
        case 3: return launch<3>(states0, words, W, cgrid, J, T, L, ctxg, A,
                                 m, inc, cap, n_halve, counts, tot, stamp,
                                 lanes, out, st);
        case 4: return launch<4>(states0, words, W, cgrid, J, T, L, ctxg, A,
                                 m, inc, cap, n_halve, counts, tot, stamp,
                                 lanes, out, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
