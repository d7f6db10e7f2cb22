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
// The row pass (rows_finalize) turns raw counts into the trained table:
// the sum of nb partial tables of the same rows, times inc, + init, then
// (c + 1) >> 1 while the row total is over cap, at most 24 times (the
// rescale of fastqueeze_tpu/ops/engine.py _train_counts, and the psum
// over 'block' plus the rescale of fastqueeze_tpu/parallel/mesh.py
// train_counts_sharded's local_train, B15).  The histograms above add inc
// a slot, so their row passes take inc 1; the frozen trainer's card
// scorer (pipeline/frozen.py _CardScorer) keeps raw histograms and weighs
// them by each candidate's inc here (frozen._cap_rescale).  It is bound
// by bytes: each
// partial read once, the table written once, (nb + 1) x 4 B an entry;
// the 24 rounds cost nothing once the row is in registers.  So a row's
// counts go from one load to one store in registers, with A a template
// parameter for the models' alphabets (4: order-k seq; 40, 41, 48:
// quality) and a generic path for any other A up to 256 (the symbols are
// bytes):
//   A = 4       a thread a row, one 16-byte load a partial and one
//               16-byte store, neighbouring threads on neighbouring rows;
//   A = 40, 48  4 lanes a row, 16-byte pieces (rows are 16-byte aligned),
//               3 a lane, so a warp's load covers 8 consecutive rows;
//   A = 41      8 lanes a row, 4-byte pieces (164-byte rows), 6 a lane
//               (a warp a row, 2 a lane, took 1.4x as long in place);
//   other A     4-byte pieces: a thread a row up to 16, 8 lanes up to 64,
//               a warp up to 256.
// A group of lanes takes its row total from __shfl_xor_sync over the
// group, each round.  The row total is int64; entries are int32, as the
// JAX tables are.  The mesh trainer gives the block shards' partials of
// one device's row block (its ctx shards stacked), so the reduce over
// 'block' is this pass's loads; K13 (fq_train_counts) and the in-place
// fq_train_rows run it with nb = 1, out = the partial.
//
// The mesh trainer (parallel/mesh.py train_counts_sharded, replacing
// fastqueeze_tpu/parallel/mesh.py train_counts_sharded, B15) launches the
// two halves on their own: fq_train_hist on every 'block' shard (adding
// into that shard's raw table), then fq_train_rows on each device's rows
// over the shards' partials.  fq_train_counts is their composition.

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

// The partial tables of one launch, by value (kernel parameter space).
constexpr int kMaxParts = 64;
struct RowParts {
    const int32_t* p[kMaxParts];
};

// Row r of the G lanes j = t mod G: lane j holds the row's pieces
// j, j + G, ..., each V int32 (V = 4: a 16-byte piece), at most P of them.
// AC = 0: A is the run-time a_rt.  out may be parts.p[0] (in place): each
// entry is read and written by one thread.
template <int AC, int G, int V, int P>
__global__ void __launch_bounds__(kRowThreads)
rows_finalize(RowParts parts, int32_t nb, int32_t* out, int64_t n_rows,
              int32_t a_rt, int32_t inc, int32_t init, int32_t cap) {
    const int32_t A = AC ? AC : a_rt;
    const int32_t pieces = A / V;
    const int64_t t = int64_t(blockIdx.x) * kRowThreads + threadIdx.x;
    const int64_t r = t / G;
    const int32_t j = static_cast<int32_t>(t % G);
    if (r >= n_rows) return;            // the whole group: r is the group's
    const unsigned lane = threadIdx.x % 32;
    const unsigned mask =
        G == 32 ? 0xffffffffu : ((1u << (G % 32)) - 1) << (lane / G * G);
    int32_t v[P * V];
#pragma unroll
    for (int k = 0; k < P * V; ++k) v[k] = 0;
#pragma unroll 4
    for (int32_t b = 0; b < nb; ++b) {
        const int32_t* row = parts.p[b] + r * A;
#pragma unroll
        for (int k = 0; k < P; ++k) {
            const int32_t q = j + k * G;
            if (q >= pieces) continue;
            if constexpr (V == 4) {
                const int4 x = __ldcs(reinterpret_cast<const int4*>(row) + q);
                v[4 * k] += x.x;
                v[4 * k + 1] += x.y;
                v[4 * k + 2] += x.z;
                v[4 * k + 3] += x.w;
            } else {
                // a cached load: a 4-byte piece's 32-byte run of a row
                // that is not sector aligned shares its sectors with the
                // next piece's run, which L1 then serves (streaming
                // loads, which evict first, took 1.4x as long over four
                // partials on the 2^20 x 41 table)
                v[k] += row[q];
            }
        }
    }
    auto total = [&]() {
        int64_t c = 0;
#pragma unroll
        for (int k = 0; k < P; ++k)
            if (j + k * G < pieces) {
#pragma unroll
                for (int i = 0; i < V; ++i) c += v[k * V + i];
            }
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
            c += __shfl_xor_sync(mask, c, o, G);
        return c;
    };
#pragma unroll
    for (int k = 0; k < P * V; ++k) v[k] = v[k] * inc + init;
    int64_t C = total();
    for (int32_t h = 0; h < 24 && C > cap; ++h) {
#pragma unroll
        for (int k = 0; k < P * V; ++k) v[k] = (v[k] + 1) >> 1;
        C = total();
    }
    int32_t* orow = out + r * A;
#pragma unroll
    for (int k = 0; k < P; ++k) {
        const int32_t q = j + k * G;
        if (q >= pieces) continue;
        if constexpr (V == 4)
            reinterpret_cast<int4*>(orow)[q] =
                make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
        else
            orow[q] = v[k];
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

template <int AC, int G, int V, int P>
int launch_rows(const RowParts& rp, int32_t nb, int32_t* out, int64_t n_rows,
                int32_t A, int32_t inc, int32_t init, int32_t cap,
                cudaStream_t st) {
    static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: 1..32, 2^k");
    constexpr int64_t kRows = kRowThreads / G;       // rows a block
    const int64_t blocks = (n_rows + kRows - 1) / kRows;
    rows_finalize<AC, G, V, P><<<static_cast<unsigned>(blocks), kRowThreads,
                                 0, st>>>(rp, nb, out, n_rows, A, inc, init,
                                          cap);
    return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// out (n_rows, A) = the row pass over parts[0..nb) (each (n_rows, A)).
int run_rows(const int32_t* const* parts, int32_t nb, int32_t* out,
             int64_t n_rows, int32_t A, int32_t inc, int32_t init,
             int32_t cap, cudaStream_t st) {
    if (nb < 1 || nb > kMaxParts || A < 1 || A > 256)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_rows <= 0) return 0;
    RowParts rp{};
    bool vec = A % 4 == 0 && aligned16(out);
    for (int32_t b = 0; b < nb; ++b) {
        rp.p[b] = parts[b];
        vec = vec && aligned16(parts[b]);
    }
    if (A == 4 && vec)
        return launch_rows<4, 1, 4, 1>(rp, nb, out, n_rows, A, inc, init,
                                       cap, st);
    if (A == 40 && vec)
        return launch_rows<40, 4, 4, 3>(rp, nb, out, n_rows, A, inc, init,
                                        cap, st);
    if (A == 48 && vec)
        return launch_rows<48, 4, 4, 3>(rp, nb, out, n_rows, A, inc, init,
                                        cap, st);
    if (A == 41)
        return launch_rows<41, 8, 1, 6>(rp, nb, out, n_rows, A, inc, init,
                                        cap, st);
    if (A <= 16)
        return launch_rows<0, 1, 1, 16>(rp, nb, out, n_rows, A, inc, init,
                                        cap, st);
    if (A <= 64)
        return launch_rows<0, 8, 1, 8>(rp, nb, out, n_rows, A, inc, init,
                                       cap, st);
    return launch_rows<0, 32, 1, 8>(rp, nb, out, n_rows, A, inc, init, cap,
                                    st);
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
    const int32_t* parts[1] = {counts};
    return rc ? rc : run_rows(parts, 1, counts, n_ctx, A, 1, init, cap,
                              st);
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

// The row pass: out (n_rows, A) int32 = the sum of the nb partials
// parts[0..nb) (device pointers to (n_rows, A) int32, 1 <= nb <= 64; out
// may be parts[0], in place), times inc, + init, then up to 24 halvings
// while the row total is over cap.  1 <= A <= 256.
extern "C" int fq_train_rows(const int32_t* const* parts, int32_t nb,
                             int32_t* out, int64_t n_rows, int32_t A,
                             int32_t inc, int32_t init, int32_t cap,
                             void* stream) {
    return run_rows(parts, nb, out, n_rows, A, inc, init, cap,
                    static_cast<cudaStream_t>(stream));
}
