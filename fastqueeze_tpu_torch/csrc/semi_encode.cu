// K11 semi_encode_walk: the semi-adaptive forward walk of one stream.
//
// Replaces fastqueeze_tpu/ops/engine.py _pass1_semi with _snapshot_sf,
// _rescale_full and _n_halve_chunk (B9, encode half), plus _device_aux
// (B1) and the models' context_grids (B2, B2').  Inside a chunk of waves
// no symbol's (start, freq) depends on another's, so the walk is not one
// CTA per stream as K5 is:
//   1. the context grid, one thread a (chunk of C waves, lane)
//      (chunk_walk.cuh, as K13, K5 and K2 walk): the cursor, the model
//      state and quality's drops recovered at the chunk's start, then
//      each slot's context written into a (T, L) int32 grid (-1 at
//      padding);
//   then the decoder's table schedule (semi_table.cuh, the one copy K12
//   runs), per chunk of `chunk` waves two launches:
//   2. a boundary over every row before the first chunk, and before
//      every later one over the rows the last chunk touched (its slice of
//      the context grid is the ring: nothing more is written) and the
//      rows still over cap, each once: halve while over cap, up to
//      n_halve times, then write the row's snapshot F[s] | F[s+1] << 16;
//   3. semi_slots over the chunk's chunk x L slots: sf = the snapshot word
//      of (ctx, sym), then atomicAdd(counts[ctx, sym], inc) for the valid
//      slots.  Integer adds commute, so the table is the same whatever
//      order the atomics land in;
//   and a last boundary that only halves, so the final counts are
//   _pass1_semi's.
// sf is K7's input (start | end << 16, 0 at padding); K7 and K3 follow as
// on the adaptive path.  The first design walked each lane in one thread
// (2,048 threads at L = 2,048, 1.0 ms on an H100) and passed the whole
// table at every boundary (16.8 MB read and written for the order-10 seq
// table, 44-57% of its 2.7-4.3 ms).  What bounds this one: the boundaries'
// row passes (a touched row read, halved and snapshotted) and the slots'
// atomics into the table, both resolving in L2, 97 launches for 48
// chunks; the grids' traffic is a few bytes a slot.

#include <cstdint>

#include <cuda_runtime.h>

#include "check.cuh"
#include "chunk_walk.cuh"
#include "lane_walk.cuh"
#include "semi_table.cuh"

namespace {

template <int KIND>
__global__ void __launch_bounds__(kLaneThreads)
chunk_ctx(const uint8_t* __restrict__ syms, const int32_t* __restrict__ cgrid,
          int32_t J, int32_t L, int32_t T, int32_t C, ModelSpec m, Scratch s,
          int32_t* __restrict__ ctxg) {
    const int32_t l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    walk_chunk<KIND>(
        syms, cgrid, J, L, T, C, nullptr, m, s, blockIdx.y, l,
        [&](int64_t, int64_t idx, int64_t ctx, int32_t) {
            ctxg[idx] = static_cast<int32_t>(ctx);
        },
        [&](int64_t, int64_t idx) { ctxg[idx] = -1; });
}

// Chunk slots [begin, begin + n); block 0 also clears the list count the
// next boundary writes (list_to_clear).
__global__ void semi_slots(const int32_t* __restrict__ ctxg,
                           const uint8_t* __restrict__ syms, int64_t begin,
                           int64_t n, int32_t A, int32_t inc,
                           const uint32_t* __restrict__ snap,
                           int32_t* __restrict__ counts,
                           uint32_t* __restrict__ sf,
                           int32_t* __restrict__ clear) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *clear = 0;
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

using CtxFn = void (*)(const uint8_t*, const int32_t*, int32_t, int32_t,
                       int32_t, int32_t, ModelSpec, Scratch, int32_t*);
const CtxFn kCtx[4] = {&chunk_ctx<0>, &chunk_ctx<1>, &chunk_ctx<2>,
                       &chunk_ctx<3>};

}  // namespace

// Bytes of the scratch fq_semi_encode_walk takes: the chunk walk's, then
// the boundaries'.
extern "C" int64_t fq_semi_encode_scratch_bytes(int32_t T, int32_t L,
                                                int64_t n_ctx) {
    return chunk_scratch_bytes(T, L) + boundary_scratch_bytes(n_ctx);
}

// counts: (n_ctx, A) int32, the starting table, updated in place to the
// walk's final table; snap: (n_ctx * A) u32 scratch; ctxg: (T, L) int32
// scratch; scratch: fq_semi_encode_scratch_bytes(T, L, n_ctx) bytes; sf:
// (T, L) u32 out.  T % chunk == 0.  Kinds 0-3 (B9 runs only on streams
// whose contexts the model computes).
extern "C" int fq_semi_encode_walk(
        const uint8_t* syms, const int32_t* cgrid, int32_t J, int32_t T,
        int32_t L, int32_t A, int32_t kind, int64_t a, int64_t b, int64_t c,
        int64_t d, int64_t e, int64_t f, int64_t g, int64_t n_ctx,
        int32_t inc, int32_t cap, int32_t n_halve, int32_t chunk,
        int32_t* counts, uint32_t* snap, int32_t* ctxg, void* scratch,
        uint32_t* sf, void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (chunk <= 0 || T % chunk != 0 || L <= 0 || kind < 0 || kind > 3)
        return static_cast<int>(cudaErrorInvalidValue);
    const int32_t C = chunk_for(T);
    const int64_t nch = chunks_of(T, C);
    const Scratch s = scratch_at(scratch, T, L, C);
    const dim3 grid((L + kLaneThreads - 1) / kLaneThreads,
                    static_cast<unsigned>(nch));
    chunk_prologue(syms, cgrid, J, L, T, C, m, s, grid, st);
    if (nch > 0)
        kCtx[kind]<<<grid, kLaneThreads, 0, st>>>(syms, cgrid, J, L, T, C, m,
                                                  s, ctxg);
    int rc = static_cast<int>(cudaGetLastError());
    const int64_t per = int64_t(chunk) * L;
    const int64_t n_chunks = T / chunk;
    const Boundaries bs = boundaries_at(
        static_cast<char*>(scratch) + chunk_scratch_bytes(T, L), counts,
        snap, n_ctx, A, cap, n_halve, n_chunks, per);
    if (rc == 0) rc = boundaries_start(bs, st);
    const int slot_threads = 256;
    for (int64_t k = 0; k <= n_chunks && rc == 0; ++k) {
        rc = boundary(bs, k, k ? ctxg + (k - 1) * per : nullptr, st);
        if (rc || k == n_chunks) break;
        semi_slots<<<static_cast<unsigned>((per + slot_threads - 1)
                                           / slot_threads),
                     slot_threads, 0, st>>>(ctxg, syms, k * per, per, A, inc,
                                            snap, counts, sf,
                                            list_to_clear(bs, k));
        rc = static_cast<int>(cudaGetLastError());
    }
    return rc;
}
