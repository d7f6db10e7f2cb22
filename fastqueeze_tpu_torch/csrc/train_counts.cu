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
//
// The mesh trainer (parallel/mesh.py train_counts_sharded, replacing
// fastqueeze_tpu/parallel/mesh.py train_counts_sharded, B15) launches the
// two halves on their own: fq_train_hist on every 'block' shard (adding
// into that shard's raw table), a psum over 'block', then fq_train_rows
// on each 'ctx' shard's rows.  fq_train_counts is their composition.

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
int run_hist(const uint8_t* syms, const int32_t* cgrid, int32_t J,
             int32_t L, const int32_t* ctxg, int32_t A,
             const fqk::ModelSpec& m, int32_t inc, int32_t* counts,
             cudaStream_t st) {
    const int lane_threads = 64;
    train_hist<KIND><<<(L + lane_threads - 1) / lane_threads, lane_threads,
                       0, st>>>(syms, cgrid, J, L, ctxg, A, m, inc, counts);
    return static_cast<int>(cudaGetLastError());
}

int run_rows(int32_t* counts, int64_t n_ctx, int32_t A, int32_t init,
             int32_t cap, cudaStream_t st) {
    const int64_t blocks = (n_ctx + kRowThreads - 1) / kRowThreads;
    if (blocks <= 0) return 0;
    train_rows<<<blocks, kRowThreads, 0, st>>>(counts, n_ctx, A, init, cap);
    return static_cast<int>(cudaGetLastError());
}

int hist_dispatch(const uint8_t* syms, const int32_t* cgrid, int32_t J,
                  int32_t L, const int32_t* ctxg, int32_t A,
                  const fqk::ModelSpec& m, int32_t inc, int32_t* counts,
                  cudaStream_t st) {
    switch (m.kind) {
        case 0: return run_hist<0>(syms, cgrid, J, L, ctxg, A, m, inc,
                                   counts, st);
        case 1: return run_hist<1>(syms, cgrid, J, L, ctxg, A, m, inc,
                                   counts, st);
        case 2: return run_hist<2>(syms, cgrid, J, L, ctxg, A, m, inc,
                                   counts, st);
        case 3: return run_hist<3>(syms, cgrid, J, L, ctxg, A, m, inc,
                                   counts, st);
        case 4: return run_hist<4>(syms, cgrid, J, L, ctxg, A, m, inc,
                                   counts, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
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
    const int rc = hist_dispatch(syms, cgrid, J, L, ctxg, A, m, inc, counts,
                                 st);
    return rc ? rc : run_rows(counts, n_ctx, A, init, cap, st);
}

// The histogram half: adds inc at (ctx, sym) of every valid slot into
// counts ((n_ctx, A) int32, not zeroed here, so a shard adds its blocks
// one after another).
extern "C" int fq_train_hist(
        const uint8_t* syms, const int32_t* cgrid, int32_t J, int32_t L,
        const int32_t* ctxg, int32_t A, int32_t kind, int64_t a, int64_t b,
        int64_t c, int64_t d, int64_t e, int64_t f, int64_t g, int32_t inc,
        int32_t* counts, void* stream) {
    const fqk::ModelSpec m{kind, a, b, c, d, e, f, g};
    return hist_dispatch(syms, cgrid, J, L, ctxg, A, m, inc, counts,
                         static_cast<cudaStream_t>(stream));
}

// The row finalize half, in place on n_rows rows of A counts: + init, then
// up to 24 halvings while the row total is over cap.
extern "C" int fq_train_rows(int32_t* counts, int64_t n_rows, int32_t A,
                             int32_t init, int32_t cap, void* stream) {
    return run_rows(counts, n_rows, A, init, cap,
                    static_cast<cudaStream_t>(stream));
}
