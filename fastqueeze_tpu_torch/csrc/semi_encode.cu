// K11 semi_encode_walk: the semi-adaptive forward walk of one stream.
//
// Replaces fastqueeze_tpu/ops/engine.py _pass1_semi with _snapshot_sf,
// _rescale_full and _n_halve_chunk (B9, encode half), plus _device_aux
// (B1) and the models' context_grids (B2, B2').  Inside a chunk of waves
// no symbol's (start, freq) depends on another's, so the walk is not one
// CTA per stream as K5 is:
//   1. lane_ctx_grid, one thread per lane: the lane walk writes every
//      slot's context into a (T, L) int32 grid (-1 at padding);
//   then per chunk of `chunk` waves, two launches:
//   2. semi_table_pass, one thread per row (semi_table.cuh): halve the
//      row while over cap, at most n_halve times (not before the first
//      chunk), then write its packed snapshot F[s] | F[s+1] << 16;
//   3. semi_slots over the chunk's chunk x L slots: sf = the snapshot word
//      of (ctx, sym), then atomicAdd(counts[ctx, sym], inc) for the valid
//      slots.  Integer adds commute, so the table is the same whatever
//      order the atomics land in.
//   and a last semi_table_pass that only halves, so the final counts are
//   _pass1_semi's.
// sf is K7's input (start | end << 16, 0 at padding); K7 and K3 follow as
// on the adaptive path.  Bound: device memory, the table pass reads the
// counts and writes the counts and the snapshot once per chunk (16.8 MB
// each for the order-10 seq table), which dwarfs the slots' grid traffic.

#include <cstdint>

#include <cuda_runtime.h>

#include "lane_walk.cuh"
#include "semi_table.cuh"

namespace {

template <int KIND>
__global__ void lane_ctx_grid(const uint8_t* __restrict__ syms,
                              const int32_t* __restrict__ cgrid, int32_t J,
                              int32_t T, int32_t L, fqk::ModelSpec m,
                              int32_t* __restrict__ ctxg) {
    const int32_t l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    const int32_t n = walk_lane<KIND>(
        syms, cgrid, J, L, l, m, nullptr,
        [&](int64_t idx, int64_t ctx, int32_t) {
            ctxg[idx] = static_cast<int32_t>(ctx);
        });
    for (int32_t t = n; t < T; ++t) ctxg[int64_t(t) * L + l] = -1;
}

__global__ void semi_slots(const int32_t* __restrict__ ctxg,
                           const uint8_t* __restrict__ syms, int64_t begin,
                           int64_t n, int32_t A, int32_t inc,
                           const uint32_t* __restrict__ snap,
                           int32_t* __restrict__ counts,
                           uint32_t* __restrict__ sf) {
    const int64_t i = begin + int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= begin + n) return;
    const int32_t ctx = ctxg[i];
    if (ctx < 0) {
        sf[i] = 0;
        return;
    }
    const int64_t e = int64_t(ctx) * A + syms[i];
    sf[i] = snap[e];
    atomicAdd(counts + e, inc);
}

template <int KIND>
int run(const uint8_t* syms, const int32_t* cgrid, int32_t J, int32_t T,
        int32_t L, int32_t A, const fqk::ModelSpec& m, int64_t n_ctx,
        int32_t inc, int32_t cap, int32_t n_halve, int32_t chunk,
        int32_t* counts, uint32_t* snap, int32_t* ctxg, uint32_t* sf,
        cudaStream_t st) {
    const int lane_threads = 64;
    lane_ctx_grid<KIND><<<(L + lane_threads - 1) / lane_threads,
                          lane_threads, 0, st>>>(syms, cgrid, J, T, L, m,
                                                  ctxg);
    int rc = static_cast<int>(cudaGetLastError());
    const int slot_threads = 256;
    const int64_t per = int64_t(chunk) * L;
    for (int32_t t0 = 0; t0 < T && rc == 0; t0 += chunk) {
        rc = table_pass(counts, n_ctx, A, cap, t0 ? n_halve : 0, snap, st);
        if (rc) break;
        semi_slots<<<(per + slot_threads - 1) / slot_threads, slot_threads,
                     0, st>>>(ctxg, syms, int64_t(t0) * L, per, A, inc, snap,
                              counts, sf);
        rc = static_cast<int>(cudaGetLastError());
    }
    if (rc == 0) rc = table_pass(counts, n_ctx, A, cap, n_halve, nullptr, st);
    return rc;
}

}  // namespace

// counts: (n_ctx, A) int32, the starting table, updated in place to the
// walk's final table; snap: (n_ctx * A) u32 scratch; ctxg: (T, L) int32
// scratch; sf: (T, L) u32 out.  T % chunk == 0.  Kinds 0-3 (B9 runs only
// on streams whose contexts the model computes).
extern "C" int fq_semi_encode_walk(
        const uint8_t* syms, const int32_t* cgrid, int32_t J, int32_t T,
        int32_t L, int32_t A, int32_t kind, int64_t a, int64_t b, int64_t c,
        int64_t d, int64_t e, int64_t f, int64_t g, int64_t n_ctx,
        int32_t inc, int32_t cap, int32_t n_halve, int32_t chunk,
        int32_t* counts, uint32_t* snap, int32_t* ctxg, uint32_t* sf,
        void* stream) {
    const fqk::ModelSpec m{kind, a, b, c, d, e, f, g};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (chunk <= 0 || T % chunk != 0 || L <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    switch (kind) {
        case 0: return run<0>(syms, cgrid, J, T, L, A, m, n_ctx, inc, cap,
                              n_halve, chunk, counts, snap, ctxg, sf, st);
        case 1: return run<1>(syms, cgrid, J, T, L, A, m, n_ctx, inc, cap,
                              n_halve, chunk, counts, snap, ctxg, sf, st);
        case 2: return run<2>(syms, cgrid, J, T, L, A, m, n_ctx, inc, cap,
                              n_halve, chunk, counts, snap, ctxg, sf, st);
        case 3: return run<3>(syms, cgrid, J, T, L, A, m, n_ctx, inc, cap,
                              n_halve, chunk, counts, snap, ctxg, sf, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
