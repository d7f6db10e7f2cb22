// K13 train_counts: the frozen-model trainer's histogram and cap rescale.
//
// Replaces fastqueeze_tpu/ops/engine.py _train_counts / _train_fused
// (B10), plus _device_aux (B1) and the models' context_grids (B2, B2').
// Two launches:
//   1. train_hist, one thread per lane: the lane walk (semi_table.cuh
//      walk_lane) gives every valid slot's context, and the slot adds
//      inc at (ctx, sym) of the zeroed (n_ctx, A) int32 histogram with
//      atomicAdd; padding slots go to no cell (the reference's spill
//      slot).  Integer adds commute, so the histogram is exact.
//   2. train_rows, one thread per row: add init, then halve ((c + 1) >> 1)
//      while the row total is over cap, at most 24 times, in place.
// Bound: device memory, per slot one symbol byte read and one int32
// atomicAdd (4 bytes read and 4 written; the atomics resolve in L2), then
// the table read and written once.

#include <cstdint>

#include <cuda_runtime.h>

#include "lane_walk.cuh"
#include "semi_table.cuh"

namespace {

template <int KIND>
__global__ void train_hist(const uint8_t* __restrict__ syms,
                           const int32_t* __restrict__ cgrid, int32_t J,
                           int32_t L, const int32_t* __restrict__ ctxg,
                           int32_t A, fqk::ModelSpec m, int32_t inc,
                           int32_t* __restrict__ hist) {
    const int32_t l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    walk_lane<KIND>(syms, cgrid, J, L, l, m, ctxg,
                    [&](int64_t, int64_t ctx, int32_t sym) {
                        atomicAdd(hist + ctx * A + sym, inc);
                    });
}

__global__ void train_rows(int32_t* __restrict__ counts, int64_t n_ctx,
                           int32_t A, int32_t init, int32_t cap) {
    const int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (r >= n_ctx) return;
    int32_t* row = counts + r * A;
    int64_t C = 0;
    for (int32_t a = 0; a < A; ++a) {
        row[a] += init;
        C += row[a];
    }
    for (int32_t k = 0; k < 24 && C > cap; ++k) {
        C = 0;
        for (int32_t a = 0; a < A; ++a) {
            const int32_t c = (row[a] + 1) >> 1;
            row[a] = c;
            C += c;
        }
    }
}

template <int KIND>
int run(const uint8_t* syms, const int32_t* cgrid, int32_t J, int32_t L,
        const int32_t* ctxg, int32_t A, const fqk::ModelSpec& m,
        int64_t n_ctx, int32_t inc, int32_t init, int32_t cap,
        int32_t* counts, cudaStream_t st) {
    const int lane_threads = 64;
    train_hist<KIND><<<(L + lane_threads - 1) / lane_threads, lane_threads,
                       0, st>>>(syms, cgrid, J, L, ctxg, A, m, inc, counts);
    int rc = static_cast<int>(cudaGetLastError());
    const int64_t blocks = (n_ctx + kRowThreads - 1) / kRowThreads;
    if (rc == 0 && blocks > 0) {
        train_rows<<<blocks, kRowThreads, 0, st>>>(counts, n_ctx, A, init,
                                                   cap);
        rc = static_cast<int>(cudaGetLastError());
    }
    return rc;
}

}  // namespace

// counts: (n_ctx, A) int32, zeroed by the caller; becomes the trained
// table.  ctxg: (T, L) int32 contexts, read for kind 4 only.
extern "C" int fq_train_counts(
        const uint8_t* syms, const int32_t* cgrid, int32_t J, int32_t L,
        const int32_t* ctxg, int32_t A, int32_t kind, int64_t a, int64_t b,
        int64_t c, int64_t d, int64_t e, int64_t f, int64_t g,
        int64_t n_ctx, int32_t inc, int32_t init, int32_t cap,
        int32_t* counts, void* stream) {
    const fqk::ModelSpec m{kind, a, b, c, d, e, f, g};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (kind) {
        case 0: return run<0>(syms, cgrid, J, L, ctxg, A, m, n_ctx, inc, init,
                              cap, counts, st);
        case 1: return run<1>(syms, cgrid, J, L, ctxg, A, m, n_ctx, inc, init,
                              cap, counts, st);
        case 2: return run<2>(syms, cgrid, J, L, ctxg, A, m, n_ctx, inc, init,
                              cap, counts, st);
        case 3: return run<3>(syms, cgrid, J, L, ctxg, A, m, n_ctx, inc, init,
                              cap, counts, st);
        case 4: return run<4>(syms, cgrid, J, L, ctxg, A, m, n_ctx, inc, init,
                              cap, counts, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
