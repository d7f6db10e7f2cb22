// K13 train_counts: the frozen-model trainer's histogram and cap rescale.
//
// Replaces fastqueeze_tpu/ops/engine.py _train_counts / _train_fused
// (B10), plus _device_aux (B1) and the models' context_grids (B2, B2').
//
// The histogram (train_hist) is a (ctx, sym) count of every valid slot of
// the (T, L) symbol grid, where a slot's context depends on the symbols
// before it in its read.  What bounds it on an H100: one int32 atomicAdd
// a slot into a table of 16 MB (order-10 seq) or more, which resolves in
// L2, plus one byte read a slot; torch.bincount of the same keys takes
// ~0.75 ms at the frozen shape (25.2 M slots), which is the rate of L2
// atomics.  To reach it the card needs hundreds of thousands of atomics
// in flight.  A thread per lane walking its lane's T waves (the first
// design: 4,096 threads at L = 4096, each a 6,144-step chain) left the
// card almost empty, so each lane's column is cut into chunks of C
// waves and one thread takes a (chunk, lane) pair (chunk_walk.cuh: the
// cursor, the model state and quality's drops recovered at each chunk
// start; C = 64: 393,216 threads at the frozen shape; chunks of 16 to
// 256 waves timed within 6% of each other on an H100, so C is a
// constant).
// Then each chunk thread walks its C waves and adds inc at (ctx, sym)
// with atomicAdd (chunk_hist).  Integer adds commute, so the table is the
// same exact histogram in any order; padding slots add nothing.
//
// train_rows, one thread per row: add init, then halve ((c + 1) >> 1)
// while the row total is over cap, at most 24 times, in place.
//
// The mesh trainer (parallel/mesh.py train_counts_sharded, replacing
// fastqueeze_tpu/parallel/mesh.py train_counts_sharded, B15) launches the
// two halves on their own: fq_train_hist on every 'block' shard (adding
// into that shard's raw table), a psum over 'block', then fq_train_rows
// on each 'ctx' shard's rows.  fq_train_counts is their composition.

#include <cstdint>

#include <cuda_runtime.h>

#include "chunk_walk.cuh"
#include "lane_walk.cuh"
#include "semi_table.cuh"

namespace {

template <int KIND>
__global__ void __launch_bounds__(kLaneThreads)
chunk_hist(const uint8_t* __restrict__ syms,
           const int32_t* __restrict__ cgrid, int32_t J, int32_t L,
           int32_t T, int32_t C, const int32_t* __restrict__ ctxg, int32_t A,
           ModelSpec m, int32_t inc, Scratch s, int32_t* __restrict__ hist) {
    const int32_t l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    walk_chunk<KIND>(
        syms, cgrid, J, L, T, C, ctxg, m, s, blockIdx.y, l,
        [&](int64_t, int64_t, int64_t ctx, int32_t sym) {
            atomicAdd(hist + ctx * A + sym, inc);
        },
        [](int64_t, int64_t) {});
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

using HistFn = void (*)(const uint8_t*, const int32_t*, int32_t, int32_t,
                       int32_t, int32_t, const int32_t*, int32_t, ModelSpec,
                       int32_t, Scratch, int32_t*);
const HistFn kHist[5] = {&chunk_hist<0>, &chunk_hist<1>, &chunk_hist<2>,
                             &chunk_hist<3>, &chunk_hist<4>};

int run_hist(const uint8_t* syms, const int32_t* cgrid, int32_t J,
             int32_t L, int32_t T, const int32_t* ctxg, int32_t A,
             const ModelSpec& m, int32_t inc, int32_t* counts,
             void* scratch, cudaStream_t st) {
    if (m.kind < 0 || m.kind > 4)
        return static_cast<int>(cudaErrorInvalidValue);
    const int32_t C = chunk_for(T);
    const int64_t nch = chunks_of(T, C);
    if (L <= 0 || nch <= 0) return 0;
    const Scratch s = scratch_at(scratch, T, L, C);
    const int lane_blocks = (L + kLaneThreads - 1) / kLaneThreads;
    const dim3 grid(lane_blocks, static_cast<unsigned>(nch));
    chunk_prologue(syms, cgrid, J, L, T, C, m, s, grid, st);
    kHist[m.kind]<<<grid, kLaneThreads, 0, st>>>(
        syms, cgrid, J, L, T, C, ctxg, A, m, inc, s, counts);
    return static_cast<int>(cudaGetLastError());
}

int run_rows(int32_t* counts, int64_t n_ctx, int32_t A, int32_t init,
             int32_t cap, cudaStream_t st) {
    const int64_t blocks = (n_ctx + kRowThreads - 1) / kRowThreads;
    if (blocks <= 0) return 0;
    train_rows<<<blocks, kRowThreads, 0, st>>>(counts, n_ctx, A, init, cap);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of the scratch a chunk walk over a (T, L) grid takes
// (fq_train_counts, fq_train_hist, fq_frozen_encode_lanes).
extern "C" int64_t fq_chunk_scratch_bytes(int32_t T, int32_t L) {
    return chunk_scratch_bytes(T, L);
}

// syms: (T, L) uint8; counts: (n_ctx, A) int32, zeroed by the caller;
// becomes the trained table.  ctxg: (T, L) int32 contexts, read for kind
// 4 only.  scratch: fq_chunk_scratch_bytes(T, L) bytes.
extern "C" int fq_train_counts(
        const uint8_t* syms, const int32_t* cgrid, int32_t J, int32_t L,
        const int32_t* ctxg, int32_t A, int32_t kind, int64_t a, int64_t b,
        int64_t c, int64_t d, int64_t e, int64_t f, int64_t g,
        int64_t n_ctx, int32_t inc, int32_t init, int32_t cap,
        int32_t* counts, int32_t T, void* scratch, void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int rc = run_hist(syms, cgrid, J, L, T, ctxg, A, m, inc, counts,
                            scratch, st);
    return rc ? rc : run_rows(counts, n_ctx, A, init, cap, st);
}

// The histogram half: adds inc at (ctx, sym) of every valid slot into
// counts ((n_ctx, A) int32, not zeroed here, so a shard adds its blocks
// one after another).
extern "C" int fq_train_hist(
        const uint8_t* syms, const int32_t* cgrid, int32_t J, int32_t L,
        const int32_t* ctxg, int32_t A, int32_t kind, int64_t a, int64_t b,
        int64_t c, int64_t d, int64_t e, int64_t f, int64_t g, int32_t inc,
        int32_t* counts, int32_t T, void* scratch, void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    return run_hist(syms, cgrid, J, L, T, ctxg, A, m, inc, counts, scratch,
                    static_cast<cudaStream_t>(stream));
}

// The row finalize half, in place on n_rows rows of A counts: + init, then
// up to 24 halvings while the row total is over cap.
extern "C" int fq_train_rows(int32_t* counts, int64_t n_rows, int32_t A,
                             int32_t init, int32_t cap, void* stream) {
    return run_rows(counts, n_rows, A, init, cap,
                    static_cast<cudaStream_t>(stream));
}
