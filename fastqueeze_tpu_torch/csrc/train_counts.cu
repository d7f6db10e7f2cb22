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
// card almost empty, so each lane's column is cut into chunks of C waves
// and one thread takes a (chunk, lane) pair, lanes adjacent across
// threads so the symbol loads stay coalesced (C = 64: 393,216 threads at
// the frozen shape; chunks of 16 to 256 waves timed within 6% of each
// other on an H100, so C is a constant).  A chunk starts inside a lane's
// walk and recovers the walk's state there without walking from wave 0:
//   - the read cursor (read slot j, in-read position) at every chunk
//     start comes from one pass a lane over its column of the (J, L)
//     read-length grid, skipping zero-length slots as cursor_next does
//     (chunk_cursors);
//   - seq (kind 0): the 2-bit history is magic at a read start, then the
//     read's last <= order symbols, read back from the lane's column;
//     order-1 byte (kind 3) looks back one symbol; quality (kind 1) its
//     last <= 8 ranks;
//   - quality's drops are a sum over the whole read so far, which for
//     long reads spans many chunks: a pass gives each chunk its drops
//     since its last read start and whether a read starts in it
//     (chunk_drops), a per-lane scan over the T / C chunk summaries turns
//     them into each chunk's drops at its start (drops_scan);
//   - order-0 (kind 2) needs no state; flat (kind 4) reads the ctx grid.
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

#include "lane_walk.cuh"
#include "semi_table.cuh"

namespace {

using fqk::ModelSpec;
using fqk::ModelState;
using fqk::ReadCursor;

constexpr int kChunk = 64;          // waves a chunk thread walks
constexpr int kLaneThreads = 256;   // threads a block: lanes of one chunk

// Scratch layout (fq_train_scratch_bytes): the lanes' lengths (L int32),
// then per (chunk, lane) its cursor (j, pos) and, for quality models, its
// drops record (value, read-start flag) turned by drops_scan into the
// chunk's drops at its start.
struct Scratch {
    int32_t* n;
    int2* cur;
    int2* drops;
};

__host__ __device__ inline int64_t chunks_of(int32_t T, int32_t C) {
    return (static_cast<int64_t>(T) + C - 1) / C;
}

// kChunk, widened where T / kChunk chunks would pass the grid's 65,535
// rows
inline int32_t chunk_for(int32_t T) {
    const int32_t least = static_cast<int32_t>((int64_t(T) + 65534) / 65535);
    return kChunk > least ? kChunk : least;
}

inline Scratch scratch_at(void* base, int32_t T, int32_t L, int32_t C) {
    char* p = static_cast<char*>(base);
    const int64_t nc = chunks_of(T, C) * L;
    const int64_t n_bytes = (int64_t(L) * 4 + 15) & ~int64_t(15);
    return Scratch{reinterpret_cast<int32_t*>(p),
                   reinterpret_cast<int2*>(p + n_bytes),
                   reinterpret_cast<int2*>(p + n_bytes + nc * 8)};
}

// One thread per lane: the lane's length (its waves, at most T) and the
// read cursor at every chunk start inside it; (-1, 0) for chunks past the
// lane's end.
__global__ void chunk_cursors(const int32_t* __restrict__ cgrid, int32_t J,
                              int32_t L, int32_t T, int32_t C, Scratch s) {
    const int32_t l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    const int64_t nch = chunks_of(T, C);
    int64_t c = 0;
    int64_t t = 0;          // wave of slot j's first symbol
    for (int32_t j = 0; j < J; ++j) {
        const int32_t len = cgrid[int64_t(j) * L + l];
        for (; c < nch && c * C < t + len; ++c)
            s.cur[c * L + l] = make_int2(j, static_cast<int32_t>(c * C - t));
        t += len;
    }
    for (; c < nch; ++c) s.cur[c * L + l] = make_int2(-1, 0);
    s.n[l] = static_cast<int32_t>(t < T ? t : T);
}

// The cursor at chunk c's first wave t0 of lane l, stepped as walk_lane
// steps it (false: the chunk lies past the lane's end).
__device__ __forceinline__ bool chunk_start(const Scratch& s,
                                            const int32_t* __restrict__ cgrid,
                                            int32_t L, int64_t c, int32_t l,
                                            ReadCursor& cur) {
    const int2 jp = s.cur[c * L + l];
    if (jp.x < 0) return false;
    cur.j = jp.x;
    cur.pos = jp.y;
    cur.rem = cgrid[int64_t(jp.x) * L + l] - jp.y;
    return true;
}

// The model state at wave t0 of lane l, whose read has `pos` symbols
// before t0 (at waves t0 - pos .. t0 - 1 of the same column): what
// walk_lane's state is there, but for quality's drops (carried in).
template <int KIND>
__device__ __forceinline__ void state_at(const ModelSpec& m,
                                         const uint8_t* __restrict__ syms,
                                         int32_t L, int32_t l, int64_t t0,
                                         int32_t pos, ModelState& st) {
    fqk::model_reset<KIND>(m, st);
    if (pos == 0) return;
    if (KIND == 0) {
        // after D shifts of 2 bits nothing of the earlier history is
        // left under the mask
        int32_t D = 0;
        while (D < 32 && (static_cast<uint64_t>(m.a) >> (2 * D)) != 0) ++D;
        const int32_t k = pos < D ? pos : D;
        if (pos >= D) st.h = 0;
        for (int32_t i = k; i > 0; --i)
            fqk::model_update<KIND>(m, st, syms[(t0 - i) * L + l]);
    } else if (KIND == 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
            st.q[j] = j < pos ? syms[(t0 - 1 - j) * L + l] : 0;
    } else if (KIND == 3) {
        st.h = syms[(t0 - 1) * L + l];
    }
}

// Quality only: chunk c's drops record, (the drops at the chunk's end,
// counted from its last read start, 1) if a read starts in the chunk,
// else (the drops the chunk adds, 0).
__global__ void chunk_drops(const uint8_t* __restrict__ syms,
                            const int32_t* __restrict__ cgrid, int32_t J,
                            int32_t L, int32_t C, ModelSpec m, Scratch s) {
    const int32_t l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    const int64_t c = blockIdx.y;
    ReadCursor cur;
    if (!chunk_start(s, cgrid, L, c, l, cur)) {
        s.drops[c * L + l] = make_int2(0, 0);
        return;
    }
    const int64_t t0 = c * C;
    const int64_t t1 = min(t0 + C, static_cast<int64_t>(s.n[l]));
    const int32_t g = static_cast<int32_t>(m.g);
    int32_t flag = cur.pos == 0;
    int32_t acc = flag ? g : 0;
    int32_t q0 = cur.pos ? syms[(t0 - 1) * L + l] : 0;
    for (int64_t t = t0; t < t1; ++t) {
        if (fqk::cursor_next(cur, cgrid, J, L, l)) {
            flag = 1;
            acc = g;
            q0 = 0;
        }
        const int32_t sym = syms[t * L + l];
        acc += max(q0 - sym, 0);
        q0 = sym;
        --cur.rem;
        ++cur.pos;
    }
    s.drops[c * L + l] = make_int2(acc, flag);
}

// Quality only, one thread per lane: each chunk's record becomes the
// drops at its first wave (a segmented scan, reset at read starts).
__global__ void drops_scan(int32_t L, int64_t nch, Scratch s) {
    const int32_t l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    int32_t carry = 0;
    for (int64_t c = 0; c < nch; ++c) {
        const int2 r = s.drops[c * L + l];
        s.drops[c * L + l].x = carry;
        carry = r.y ? r.x : carry + r.x;
    }
}

template <int KIND>
__global__ void __launch_bounds__(kLaneThreads)
chunk_hist(const uint8_t* __restrict__ syms,
           const int32_t* __restrict__ cgrid, int32_t J, int32_t L,
           int32_t C, const int32_t* __restrict__ ctxg, int32_t A,
           ModelSpec m, int32_t inc, Scratch s, int32_t* __restrict__ hist) {
    const int32_t l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    const int64_t c = blockIdx.y;
    ReadCursor cur;
    if (!chunk_start(s, cgrid, L, c, l, cur)) return;
    const int64_t t0 = c * C;
    const int64_t t1 = min(t0 + C, static_cast<int64_t>(s.n[l]));
    ModelState st;
    state_at<KIND>(m, syms, L, l, t0, cur.pos, st);
    if (KIND == 1 && cur.pos) st.drops = s.drops[c * L + l].x;
    for (int64_t t = t0; t < t1; ++t) {
        if (fqk::cursor_next(cur, cgrid, J, L, l))
            fqk::model_reset<KIND>(m, st);
        const int64_t idx = t * L + l;
        const int32_t sym = syms[idx];
        const int64_t ctx = fqk::lane_ctx<KIND>(m, st, cur.pos, ctxg, idx);
        atomicAdd(hist + ctx * A + sym, inc);
        fqk::model_update<KIND>(m, st, sym);
        --cur.rem;
        ++cur.pos;
    }
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
void launch_hist(dim3 grid, const uint8_t* syms, const int32_t* cgrid,
                 int32_t J, int32_t L, int32_t C, const int32_t* ctxg,
                 int32_t A, const ModelSpec& m, int32_t inc,
                 const Scratch& s, int32_t* counts, cudaStream_t st) {
    chunk_hist<KIND><<<grid, kLaneThreads, 0, st>>>(
        syms, cgrid, J, L, C, ctxg, A, m, inc, s, counts);
}

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
    chunk_cursors<<<lane_blocks, kLaneThreads, 0, st>>>(cgrid, J, L, T, C,
                                                         s);
    if (m.kind == 1) {
        chunk_drops<<<grid, kLaneThreads, 0, st>>>(syms, cgrid, J, L, C, m,
                                                   s);
        drops_scan<<<lane_blocks, kLaneThreads, 0, st>>>(L, nch, s);
    }
    switch (m.kind) {
        case 0: launch_hist<0>(grid, syms, cgrid, J, L, C, ctxg, A, m, inc,
                               s, counts, st); break;
        case 1: launch_hist<1>(grid, syms, cgrid, J, L, C, ctxg, A, m, inc,
                               s, counts, st); break;
        case 2: launch_hist<2>(grid, syms, cgrid, J, L, C, ctxg, A, m, inc,
                               s, counts, st); break;
        case 3: launch_hist<3>(grid, syms, cgrid, J, L, C, ctxg, A, m, inc,
                               s, counts, st); break;
        default: launch_hist<4>(grid, syms, cgrid, J, L, C, ctxg, A, m, inc,
                                s, counts, st); break;
    }
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

// Bytes of the scratch fq_train_counts / fq_train_hist take for a (T, L)
// grid.
extern "C" int64_t fq_train_scratch_bytes(int32_t T, int32_t L) {
    const int64_t nc = chunks_of(T, chunk_for(T)) * L;
    return ((int64_t(L) * 4 + 15) & ~int64_t(15)) + 16 * nc;
}

// syms: (T, L) uint8; counts: (n_ctx, A) int32, zeroed by the caller;
// becomes the trained table.  ctxg: (T, L) int32 contexts, read for kind
// 4 only.  scratch: fq_train_scratch_bytes(T, L) bytes.
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
