// The lane walk's state at the start of every chunk of C waves, without
// walking from wave 0 (K13 train_counts, K5 adapt_encode_walk, K2
// frozen_encode_lanes).
//
// Each lane's column of the (T, L) symbol grid is cut into chunks of C
// waves, and one thread takes a (chunk, lane) pair, lanes adjacent across
// threads so the symbol loads stay coalesced.  A chunk starts inside a
// lane's walk and recovers the walk's state there:
//   - the read cursor (read slot j, in-read position) at every chunk
//     start comes from one pass a lane over its column of the (J, L)
//     read-length grid, skipping zero-length slots as cursor_next does
//     (chunk_cursors);
//   - seq (kind 0): the 2-bit history is magic at a read start, then the
//     read's last <= order symbols, read back from the lane's column;
//     order-1 byte (kind 3) looks back one symbol; quality (kind 1) its
//     last <= 8 ranks (state_at);
//   - quality's drops are a sum over the whole read so far, which for
//     long reads spans many chunks: a pass gives each chunk its drops
//     since its last read start and whether a read starts in it
//     (chunk_drops), a per-lane scan over the T / C chunk summaries turns
//     them into each chunk's drops at its start (drops_scan);
//   - order-0 (kind 2) needs no state; flat (kind 4) reads the ctx grid.
// chunk_prologue launches the passes a model kind needs; each user then
// walks its chunks with walk_chunk.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "lane_walk.cuh"

namespace {

using fqk::ModelSpec;
using fqk::ModelState;
using fqk::ReadCursor;

constexpr int kChunk = 64;          // waves a chunk thread walks
constexpr int kLaneThreads = 256;   // threads a block: lanes of one chunk

// Scratch layout (chunk_scratch_bytes): the lanes' lengths (L int32),
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

// The passes before a chunk walk: the cursors, and quality's drops at
// every chunk start.  C = chunk_for(T); `grid` is (lane blocks, chunks);
// with no chunks (T = 0) only the lanes' lengths are written.
inline void chunk_prologue(const uint8_t* syms, const int32_t* cgrid,
                           int32_t J, int32_t L, int32_t T, int32_t C,
                           const ModelSpec& m, const Scratch& s, dim3 grid,
                           cudaStream_t st) {
    chunk_cursors<<<grid.x, kLaneThreads, 0, st>>>(cgrid, J, L, T, C, s);
    if (m.kind == 1 && grid.y > 0) {
        chunk_drops<<<grid, kLaneThreads, 0, st>>>(syms, cgrid, J, L, C, m,
                                                   s);
        drops_scan<<<grid.x, kLaneThreads, 0, st>>>(L, grid.y, s);
    }
}

// Chunk c of lane l, from the state the prologue recovered at its start:
// slot(t, idx, ctx, sym) for each of its waves t inside the lane (idx =
// t * L + l; ctx from the model's walk, or from the (T, L) grid ctxg for
// kind 4), then pad(t, idx) for its waves past the lane's end.
template <int KIND, typename Slot, typename Pad>
__device__ __forceinline__ void walk_chunk(const uint8_t* __restrict__ syms,
                                           const int32_t* __restrict__ cgrid,
                                           int32_t J, int32_t L, int32_t T,
                                           int32_t C,
                                           const int32_t* __restrict__ ctxg,
                                           const ModelSpec& m,
                                           const Scratch& s, int64_t c,
                                           int32_t l, Slot slot, Pad pad) {
    const int64_t t0 = c * C;
    const int64_t tend = min(t0 + C, static_cast<int64_t>(T));
    int64_t t = t0;
    ReadCursor cur;
    if (chunk_start(s, cgrid, L, c, l, cur)) {
        const int64_t t1 = min(tend, static_cast<int64_t>(s.n[l]));
        ModelState st;
        state_at<KIND>(m, syms, L, l, t0, cur.pos, st);
        if (KIND == 1 && cur.pos) st.drops = s.drops[c * L + l].x;
        for (; t < t1; ++t) {
            if (fqk::cursor_next(cur, cgrid, J, L, l))
                fqk::model_reset<KIND>(m, st);
            const int64_t idx = t * L + l;
            FQK_BOUND("walk_chunk", "syms", idx, int64_t(T) * L);
            const int32_t sym = syms[idx];
            slot(t, idx, fqk::lane_ctx<KIND>(m, st, cur.pos, ctxg, idx),
                 sym);
            fqk::model_update<KIND>(m, st, sym);
            --cur.rem;
            ++cur.pos;
        }
    }
    for (; t < tend; ++t) pad(t, t * L + l);
}

// Bytes of the scratch a chunk walk over a (T, L) grid takes.
inline int64_t chunk_scratch_bytes(int32_t T, int32_t L) {
    const int64_t nc = chunks_of(T, chunk_for(T)) * L;
    return ((int64_t(L) * 4 + 15) & ~int64_t(15)) + 16 * nc;
}

}  // namespace
