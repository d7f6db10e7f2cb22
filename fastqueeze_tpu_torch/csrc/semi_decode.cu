// K12 semi_decode: semi-adaptive rANS decode of one stream.
//
// Replaces fastqueeze_tpu/ops/engine.py _decode_semi (B9, decode half)
// with _snapshot_sf and _rescale_full, plus _device_aux (B1) and the
// models' lane walk (B2, B2').  Per chunk of `chunk` waves, two launches:
//   1. semi_table_pass, one thread per row (semi_table.cuh): halve while
//      over cap (not before the first chunk), write the packed snapshot;
//   2. semi_decode_chunk, one CTA for the chunk's waves, as K6 works, but
//      against the snapshot, which no lane writes during the chunk.  Per
//      wave, each valid lane steps its cursor and model, takes its
//      context, finds its symbol by _decode_semi's binary search over the
//      snapshot's low halves (F[s], step for step: ceil(log2 A) steps of
//      "largest s with F[s] <= low"), decodes, and after the block-wide
//      exclusive scan of `need` reads its renormalization word at
//      words[min(off + rank, W - 1)]; then atomicAdd(counts[ctx, sym],
//      inc) and the model update.  The counts are read by nobody until
//      the next table pass, so the scan's barriers are the only ones.
// Lane state, rANS state and the word offset carry from one chunk's
// launch to the next in global scratch (the carry of _decode_semi's outer
// scan).  A last table pass only halves, so the final counts are
// _decode_semi's.  F is nondecreasing, so every search for the largest s
// with F[s] <= low finds the same symbol; while every count is >= 1 and
// the row total is <= cap <= 2^14 no frequency is 0 either, and a linear
// scan would agree too.  A table with zero counts (a counts0 of the
// caller's) gives zero frequencies; the binary search copied from the
// reference decodes such a table as the reference does.  Bound: the
// table passes' device-memory traffic, and one SM's serial wave chain.

#include <cstdint>

#include <cuda_runtime.h>

#include "lane_walk.cuh"
#include "semi_table.cuh"

namespace {

using fqk::ModelSpec;
using fqk::ModelState;
using fqk::ReadCursor;

constexpr int kThreads = 1024;

struct Lane {
    ModelState s;
    ReadCursor cur;
    int64_t base;     // this wave's row offset, ctx * A
    uint32_t x;       // rANS state
    uint32_t xn;      // this wave's state before renormalization
    int32_t n;        // symbols in the lane
    int32_t sym;      // this wave's symbol
};

template <int KIND>
__global__ void __launch_bounds__(kThreads)
semi_decode_chunk(const uint32_t* __restrict__ states0,
                  const uint16_t* __restrict__ words, int64_t W,
                  const int32_t* __restrict__ cgrid, int32_t J, int32_t L,
                  int32_t t0, int32_t t1, int32_t A, int32_t steps,
                  ModelSpec m, int32_t inc,
                  const uint32_t* __restrict__ snap, int32_t* counts,
                  Lane* __restrict__ lanes, int64_t* off_io,
                  uint8_t* __restrict__ out) {
    const int32_t per = (L + kThreads - 1) / kThreads;
    const int32_t l0 = threadIdx.x * per;
    const int32_t l1 = min(l0 + per, L);
    if (t0 == 0) {
        for (int32_t l = l0; l < l1; ++l) {
            Lane& ln = lanes[l];
            fqk::model_reset<KIND>(m, ln.s);
            ln.cur = ReadCursor{-1, 0, 0};
            ln.x = states0[l];
            ln.n = fqk::lane_length(cgrid, J, L, l);
        }
    }
    int64_t off = t0 == 0 ? 0 : *off_io;
    for (int32_t t = t0; t < t1; ++t) {
        int32_t need = 0;
        for (int32_t l = l0; l < l1; ++l) {
            Lane& ln = lanes[l];
            if (t >= ln.n) continue;
            if (fqk::cursor_next(ln.cur, cgrid, J, L, l))
                fqk::model_reset<KIND>(m, ln.s);
            const int64_t base =
                fqk::model_ctx<KIND>(m, ln.s, ln.cur.pos) * A;
            const uint32_t low = ln.x & fqk::kMaskM;
            int32_t lo = 0, hi = A - 1;
            for (int32_t k = 0; k < steps; ++k) {
                const int32_t mid = (lo + hi + 1) >> 1;
                if ((snap[base + mid] & 0xFFFFu) <= low) lo = mid;
                else hi = mid - 1;
            }
            const uint32_t v = snap[base + lo];
            const uint32_t start = v & 0xFFFFu;
            const uint32_t f = (v >> 16) - start;
            ln.xn = f * (ln.x >> fqk::kProbBits) + low - start;
            ln.sym = lo;
            ln.base = base;
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
            atomicAdd(counts + ln.base + ln.sym, inc);
            fqk::model_update<KIND>(m, ln.s, ln.sym);
            --ln.cur.rem;
            ++ln.cur.pos;
        }
        off += total;
    }
    if (threadIdx.x == 0) *off_io = off;
}

template <int KIND>
int run(const uint32_t* states0, const uint16_t* words, int64_t W,
        const int32_t* cgrid, int32_t J, int32_t T, int32_t L, int32_t A,
        int32_t steps, const ModelSpec& m, int64_t n_ctx, int32_t inc,
        int32_t cap, int32_t n_halve, int32_t chunk, int32_t* counts,
        uint32_t* snap, void* lanes, int64_t* off, uint8_t* out,
        cudaStream_t st) {
    int rc = 0;
    for (int32_t t0 = 0; t0 < T && rc == 0; t0 += chunk) {
        rc = table_pass(counts, n_ctx, A, cap, t0 ? n_halve : 0, snap, st);
        if (rc) break;
        semi_decode_chunk<KIND><<<1, kThreads, 0, st>>>(
            states0, words, W, cgrid, J, L, t0, t0 + chunk, A, steps, m, inc,
            snap, counts, static_cast<Lane*>(lanes), off, out);
        rc = static_cast<int>(cudaGetLastError());
    }
    if (rc == 0) rc = table_pass(counts, n_ctx, A, cap, n_halve, nullptr, st);
    return rc;
}

}  // namespace

// lanes: scratch of L * fq_semi_decode_lane_bytes() bytes; off: one int64
// of scratch; counts, snap as for fq_semi_encode_walk; out: (T, L) u8.
extern "C" int64_t fq_semi_decode_lane_bytes() { return sizeof(Lane); }

extern "C" int fq_semi_decode(
        const uint32_t* states0, const uint16_t* words, int64_t W,
        const int32_t* cgrid, int32_t J, int32_t T, int32_t L, int32_t A,
        int32_t steps, int32_t kind, int64_t a, int64_t b, int64_t c,
        int64_t d, int64_t e, int64_t f, int64_t g, int64_t n_ctx,
        int32_t inc, int32_t cap, int32_t n_halve, int32_t chunk,
        int32_t* counts, uint32_t* snap, void* lanes, int64_t* off,
        uint8_t* out, void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (chunk <= 0 || T % chunk != 0 || L <= 0 || W <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    switch (kind) {
        case 0: return run<0>(states0, words, W, cgrid, J, T, L, A, steps, m,
                              n_ctx, inc, cap, n_halve, chunk, counts, snap,
                              lanes, off, out, st);
        case 1: return run<1>(states0, words, W, cgrid, J, T, L, A, steps, m,
                              n_ctx, inc, cap, n_halve, chunk, counts, snap,
                              lanes, off, out, st);
        case 2: return run<2>(states0, words, W, cgrid, J, T, L, A, steps, m,
                              n_ctx, inc, cap, n_halve, chunk, counts, snap,
                              lanes, off, out, st);
        case 3: return run<3>(states0, words, W, cgrid, J, T, L, A, steps, m,
                              n_ctx, inc, cap, n_halve, chunk, counts, snap,
                              lanes, off, out, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
