// Pieces of the semi-adaptive walk (K11 semi_encode_walk, K12 semi_decode)
// and of the trainer (K13 train_counts) that run over count table rows:
// a row's halvings and snapshot, and the chunk boundaries of the walk,
// one copy for the encoder and the decoder.
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

#include "check.cuh"
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

// --- the chunk boundaries (K11, K12) --------------------------------------
//
// Boundary c (0 <= c <= n_chunks) runs before chunk c, or after the last
// chunk for c = n_chunks.  Boundary 0 visits every row: its snapshot, and
// the rows a caller's table starts over cap.  Boundary c > 0 visits the
// rows chunk c - 1's valid slots added to (the chunk's slice of contexts,
// the "ring", -1 at padding) and the rows boundary c - 1 left over cap (a
// list it wrote), each row once (the first thread to stamp the row's mark
// with c takes it): up to n_halve halvings, then the snapshot but after
// the last chunk.  Every other row is at or under cap and unchanged since
// its last visit, so _rescale_full leaves it alone and its snapshot
// stands: the set is exact.  A row still over cap goes to boundary c's
// list.  A whole-table pass at every boundary took 17-20% of K12 and 44-57%
// of K11 on an H100.

// The boundaries' table and scratch (boundary_scratch_bytes: the two
// over-cap lists' counts, each row's mark, the two lists).
struct Boundaries {
    int32_t* counts;
    uint32_t* snap;
    int64_t n_ctx;
    int32_t A, cap, n_halve;
    int64_t n_chunks, n_ring;   // chunks; slots a chunk (its ring)
    int32_t* n_over;            // [2]
    int32_t* mark;              // [n_ctx]
    int32_t* over;              // [2][n_ctx]
};

// Boundary b: it reads list (b + 1) & 1 and writes list b & 1.
__global__ void __launch_bounds__(kRowThreads)
boundary_rows(Boundaries s, int32_t b, const int32_t* __restrict__ ring) {
    const int64_t in = (b + 1) & 1, out = b & 1;
    uint32_t* snap = b < s.n_chunks ? s.snap : nullptr;
    const int32_t n_halve = b ? s.n_halve : 0;
    const int64_t n = b ? s.n_ring + s.n_over[in] : s.n_ctx;
    const int64_t stride = int64_t(gridDim.x) * blockDim.x;
    for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        int64_t r = i;
        if (b) {
            r = i < s.n_ring ? ring[i] : s.over[in * s.n_ctx + i - s.n_ring];
            if (r < 0) continue;
            FQK_BOUND("boundary_rows", "row", r, s.n_ctx);
            if (atomicExch(s.mark + r, b) == b) continue;
        }
        if (row_pass(s.counts, r, s.A, s.cap, n_halve, snap) > s.cap) {
            const int32_t k = atomicAdd(s.n_over + out, 1);
            FQK_BOUND("boundary_rows", "over", k, s.n_ctx);
            s.over[out * s.n_ctx + k] = static_cast<int32_t>(r);
        }
    }
}

inline int64_t boundary_scratch_bytes(int64_t n_ctx) {
    return 16 + ((12 * n_ctx + 15) & ~int64_t(15));
}

inline Boundaries boundaries_at(void* scratch, int32_t* counts,
                                uint32_t* snap, int64_t n_ctx, int32_t A,
                                int32_t cap, int32_t n_halve, int64_t n_chunks,
                                int64_t n_ring) {
    char* p = static_cast<char*>(scratch);
    int32_t* mark = reinterpret_cast<int32_t*>(p + 16);
    return Boundaries{counts, snap, n_ctx, A, cap, n_halve, n_chunks, n_ring,
                      reinterpret_cast<int32_t*>(p), mark, mark + n_ctx};
}

// Before boundary 0: no list, no row marked.
inline int boundaries_start(const Boundaries& s, cudaStream_t st) {
    cudaError_t rc = cudaMemsetAsync(s.n_over, 0, 2 * sizeof(int32_t), st);
    if (rc == cudaSuccess)
        rc = cudaMemsetAsync(s.mark, 0, 4 * s.n_ctx, st);
    return static_cast<int>(rc);
}

// The count of the list boundary c + 1 writes, which chunk c's launch
// sets to 0 (boundary c has read it as its input).
inline int32_t* list_to_clear(const Boundaries& s, int64_t c) {
    return s.n_over + ((c + 1) & 1);
}

// Boundary c; ring: chunk c - 1's n_ring contexts (unused at c = 0).
inline int boundary(const Boundaries& s, int64_t c, const int32_t* ring,
                    cudaStream_t st) {
    const int64_t work = (c ? s.n_ring : s.n_ctx) / kRowThreads + 1;
    const int64_t blocks = work < (1 << 16) ? work : (1 << 16);
    boundary_rows<<<static_cast<unsigned>(blocks), kRowThreads, 0, st>>>(
        s, static_cast<int32_t>(c), ring);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
