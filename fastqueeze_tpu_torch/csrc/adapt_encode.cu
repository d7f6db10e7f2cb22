// K5 adapt_encode_walk: the adaptive coder's forward model walk over one
// stream, one CTA.
//
// Replaces fastqueeze_tpu/ops/engine.py _device_aux (B1), the models'
// context_grids (B2, B2'), _quant per row (B3) and _pass1 with
// _wave_update_tot (B7).  The count table (n_ctx, A) is shared by all
// lanes and changes after every wave, so one CTA owns the stream and the
// waves run in order inside it; each thread owns ceil(L / 1024)
// consecutive lanes.  Per wave:
//   1. each valid lane steps its read cursor and model, takes its context
//      and symbol, and quantizes its symbol from the PRE-update row:
//      sf[t, l] = start | end << 16 (the layout K2 stores; K7 consumes it);
//   -- barrier: no lane may read a row another lane has added to --
//   2. atomicAdd(counts[ctx, sym], inc) and atomicAdd(tot[ctx], inc) (adds
//      commute, so duplicate contexts are exact); the lane whose
//      atomicExch on stamp[ctx] returns another wave is the one lane that
//      rescales the row;
//   -- barrier --
//   3. that lane halves the row while its total is over cap, at most
//      n_halve times (the result is a function of the post-add row only);
//   -- barrier: the next wave must not read half-halved rows --
// Padding lanes are skipped: with every row at or under cap (init * A <=
// cap, checked by the wrapper) the reference's halving of their rows is a
// no-op.  Bound: one SM, and per wave the dependent row reads (L2, the
// table is up to 168 MB for qlevel-3 quality) and three barriers.
// Padding slots of sf are written 0.

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
    int32_t n;        // symbols in the lane
    int32_t sym;      // this wave's symbol
    int32_t fix;      // rescales row ctx after this wave
};

template <int KIND>
__global__ void __launch_bounds__(kThreads)
adapt_encode_walk(const uint8_t* __restrict__ syms,
                  const int32_t* __restrict__ cgrid, int32_t J, int32_t T,
                  int32_t L, const int32_t* __restrict__ ctxg, int32_t A,
                  ModelSpec m, int32_t inc, int32_t cap, int32_t n_halve,
                  int32_t* counts, int32_t* tot, int32_t* stamp,
                  Lane* __restrict__ lanes, uint32_t* __restrict__ sf) {
    const int32_t per = (L + kThreads - 1) / kThreads;
    const int32_t l0 = threadIdx.x * per;
    const int32_t l1 = min(l0 + per, L);
    for (int32_t l = l0; l < l1; ++l) {
        Lane& ln = lanes[l];
        fqk::model_reset<KIND>(m, ln.s);
        ln.cur = ReadCursor{-1, 0, 0};
        ln.n = fqk::lane_length(cgrid, J, L, l);
    }
    for (int32_t t = 0; t < T; ++t) {
        for (int32_t l = l0; l < l1; ++l) {
            Lane& ln = lanes[l];
            const int64_t idx = int64_t(t) * L + l;
            if (t >= ln.n) {
                sf[idx] = 0;
                continue;
            }
            if (fqk::cursor_next(ln.cur, cgrid, J, L, l))
                fqk::model_reset<KIND>(m, ln.s);
            const int32_t sym = syms[idx];
            const int64_t ctx = fqk::lane_ctx<KIND>(m, ln.s, ln.cur.pos,
                                                    ctxg, idx);
            sf[idx] = fqk::quant_sf(counts + ctx * A, __ldcg(tot + ctx),
                                    sym);
            ln.ctx = ctx;
            ln.sym = sym;
            fqk::model_update<KIND>(m, ln.s, sym);
            --ln.cur.rem;
            ++ln.cur.pos;
        }
        __syncthreads();
        for (int32_t l = l0; l < l1; ++l) {
            Lane& ln = lanes[l];
            if (t < ln.n)
                ln.fix = fqk::table_add(counts, tot, stamp, ln.ctx, A,
                                        ln.sym, inc, t);
        }
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
int launch(const uint8_t* syms, const int32_t* cgrid, int32_t J, int32_t T,
           int32_t L, const int32_t* ctxg, int32_t A, const ModelSpec& m,
           int32_t inc, int32_t cap, int32_t n_halve, int32_t* counts,
           int32_t* tot, int32_t* stamp, void* lanes, uint32_t* sf,
           cudaStream_t st) {
    adapt_encode_walk<KIND><<<1, kThreads, 0, st>>>(
        syms, cgrid, J, T, L, ctxg, A, m, inc, cap, n_halve, counts, tot,
        stamp, static_cast<Lane*>(lanes), sf);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lanes: scratch of L * fq_adapt_encode_lane_bytes() bytes.  counts,
// tot and stamp are the wrapper's fresh table (init, init * A, -1); the
// kernel updates them in place.  ctxg is read for kind 4 only.
extern "C" int64_t fq_adapt_encode_lane_bytes() { return sizeof(Lane); }

extern "C" int fq_adapt_encode_walk(
        const uint8_t* syms, const int32_t* cgrid, int32_t J, int32_t T,
        int32_t L, const int32_t* ctxg, int32_t A, int32_t kind, int64_t a,
        int64_t b, int64_t c, int64_t d, int64_t e, int64_t f, int64_t g,
        int32_t inc, int32_t cap, int32_t n_halve, int32_t* counts,
        int32_t* tot, int32_t* stamp, void* lanes, uint32_t* sf,
        void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (kind) {
        case 0: return launch<0>(syms, cgrid, J, T, L, ctxg, A, m, inc, cap,
                                 n_halve, counts, tot, stamp, lanes, sf, st);
        case 1: return launch<1>(syms, cgrid, J, T, L, ctxg, A, m, inc, cap,
                                 n_halve, counts, tot, stamp, lanes, sf, st);
        case 2: return launch<2>(syms, cgrid, J, T, L, ctxg, A, m, inc, cap,
                                 n_halve, counts, tot, stamp, lanes, sf, st);
        case 3: return launch<3>(syms, cgrid, J, T, L, ctxg, A, m, inc, cap,
                                 n_halve, counts, tot, stamp, lanes, sf, st);
        case 4: return launch<4>(syms, cgrid, J, T, L, ctxg, A, m, inc, cap,
                                 n_halve, counts, tot, stamp, lanes, sf, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
