// Pieces of the semi-adaptive walk (K11 semi_encode_walk, K12 semi_decode)
// and of the trainer (K13 train_counts) that run over the whole count
// table or over one lane's contexts.
//
// The semi-adaptive walk (fastqueeze_tpu/ops/engine.py _pass1_semi,
// _decode_semi) freezes the table for `chunk` waves at a time: at each
// chunk start the table is halved (_rescale_full, skipped before the
// first chunk) and snapshotted (_snapshot_sf); inside the chunk every
// symbol's (start, freq) is one gather from the snapshot while the raw
// counts keep accumulating.  The snapshot here is packed as K1 packs a
// frozen table, F[s] | F[s+1] << 16 (start | end << 16), which is what K7
// reads; the JAX snapshot packs start | freq << 16.  Both have the
// cumulative start F[s] in the low half, which is all the decoder's
// search reads, so the layouts differ only in the high half, and K12
// takes freq = end - start where it needs it.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "lane_walk.cuh"

namespace {

constexpr int kRowThreads = 256;

// Row r: halve ((c + 1) >> 1) while the row total is over cap, at most
// n_halve times, then, when snap is given, write the row's packed
// snapshot with _quant's floor F_s = floor(cum_s * 2^14 / C).  A row
// whose total is 0 packs zeros (as K1 does; tables of init >= 1 and
// trained tables never have one).  Returns the row's total after the
// halvings.  A row is A consecutive int32, so a warp's threads on
// consecutive rows read 32 * A * 4 contiguous bytes.
__device__ __forceinline__ int64_t row_pass(int32_t* __restrict__ counts,
                                            int64_t r, int32_t A, int32_t cap,
                                            int32_t n_halve,
                                            uint32_t* __restrict__ snap) {
    int32_t* row = counts + r * A;
    int64_t C = 0;
    for (int32_t a = 0; a < A; ++a) C += row[a];
    for (int32_t k = 0; k < n_halve && C > cap; ++k) {
        C = 0;
        for (int32_t a = 0; a < A; ++a) {
            const int32_t c = (row[a] + 1) >> 1;
            row[a] = c;
            C += c;
        }
    }
    if (snap == nullptr) return C;
    const int64_t D = C > 0 ? C : 1;
    uint32_t* out = snap + r * A;
    int64_t acc = 0;
    uint32_t prev = 0;
    for (int32_t a = 0; a < A; ++a) {
        acc += row[a];
        const uint32_t F = static_cast<uint32_t>((acc << fqk::kProbBits) / D);
        out[a] = prev | (F << 16);
        prev = F;
    }
    return C;
}

// One thread per row: row_pass over the whole table (n_halve = 0 before
// the first chunk).  Bound: device-memory traffic, the row read and
// written (when halved) and the snapshot written.
__global__ void semi_table_pass(int32_t* __restrict__ counts, int64_t n_ctx,
                                int32_t A, int32_t cap, int32_t n_halve,
                                uint32_t* __restrict__ snap) {
    const int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (r < n_ctx) row_pass(counts, r, A, cap, n_halve, snap);
}

inline int table_pass(int32_t* counts, int64_t n_ctx, int32_t A,
                      int32_t cap, int32_t n_halve, uint32_t* snap,
                      cudaStream_t st) {
    const int64_t blocks = (n_ctx + kRowThreads - 1) / kRowThreads;
    if (blocks == 0) return 0;
    semi_table_pass<<<blocks, kRowThreads, 0, st>>>(counts, n_ctx, A, cap,
                                                     n_halve, snap);
    return static_cast<int>(cudaGetLastError());
}

// Visit every symbol of lane l in wave order: fn(idx, ctx, sym) for each
// valid slot idx = t * L + l (ctx from the model's lane walk, or from
// the (T, L) grid ctxg for kind 4); returns the lane's symbol count.
template <int KIND, typename Fn>
__device__ __forceinline__ int32_t walk_lane(const uint8_t* __restrict__ syms,
                                             const int32_t* __restrict__ cgrid,
                                             int32_t J, int32_t L, int32_t l,
                                             const fqk::ModelSpec& m,
                                             const int32_t* __restrict__ ctxg,
                                             Fn fn) {
    const int32_t n = fqk::lane_length(cgrid, J, L, l);
    fqk::ModelState s;
    fqk::model_reset<KIND>(m, s);
    fqk::ReadCursor cur{-1, 0, 0};
    for (int32_t t = 0; t < n; ++t) {
        if (fqk::cursor_next(cur, cgrid, J, L, l))
            fqk::model_reset<KIND>(m, s);
        const int64_t idx = int64_t(t) * L + l;
        const int32_t sym = syms[idx];
        fn(idx, fqk::lane_ctx<KIND>(m, s, cur.pos, ctxg, idx), sym);
        fqk::model_update<KIND>(m, s, sym);
        --cur.rem;
        ++cur.pos;
    }
    return n;
}

}  // namespace
