// The frozen-table wave decode of one stream on a thread-block cluster,
// one body for K4 (frozen_decode.cu, the whole table) and K18
// (ctx_shard_decode.cu, the table cut into row shards that share the
// card), templated on where a context's row lives (WholeRows, ShardRows).
//
// The wave loop is sequential: a lane that renormalizes reads the word at
// off + its rank among the lanes that renormalize in this wave, so wave
// t + 1's word offset depends on every lane of every earlier wave.  Each
// wave is a dependent chain, and what bounds the stream on an H100 is
// that chain's latency, T times over: fetch the context's cumulative row
// (L2, or HBM for tables past the 50 MB L2), find the symbol, rank the
// lanes that renormalize, fetch their words.  The design spreads a wave
// over a cluster of up to 8 CTAs on 8 SMs and shortens its chain:
//   - lanes are split over the cluster's threads in lane order; up to
//     8 x 512 lanes (the default lanes_max is 4096) each thread owns one
//     lane and keeps its model state, read cursor and rANS state in
//     registers (decode_one).  Above that a thread owns up to
//     ceil(L / 8192) consecutive lanes whose state stays in an
//     L2-resident scratch (decode_multi; the format allows 2^16 lanes);
//   - the row is fetched in one go: the aligned 16-byte segments that
//     hold its A + 1 u16 entries are loaded together, and the symbol is
//     the count of entries F[s] <= low for s in 1..A-1, with start the
//     largest such entry (or F[0]) and end the smallest entry above low
//     (or F[A]).  Rows are non-decreasing, so this is the reference's
//     "largest s with F[s] <= low" and its (start, freq);
//   - in decode_one the next wave's context depends only on this wave's
//     symbol, so its row is fetched before this wave's rank and word
//     fetch, and arrives while they run;
//   - the rank is cluster_xchg.cuh's push-and-poll exchange (no cluster
//     barrier inside the wave loop), and every CTA advances its own copy
//     of off by the grand total (no global counter, no atomics);
//   - the word read stays words[min(off + rank, W - 1)] (the clamp keeps
//     a corrupt payload inside the padded buffer, as the reference's
//     clamp does); the next wave's window of words is prefetched into L2
//     once off is known.
// Padding slots (t >= the lane's length) write 0.  The output is the
// (T, L) u8 symbol grid and, where x_final is given, every lane's final
// rANS state.
#pragma once

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "check.cuh"
#include "cluster_xchg.cuh"
#include "lane_walk.cuh"

namespace {

namespace cg = cooperative_groups;

using fqk::ModelSpec;
using fqk::ModelState;
using fqk::ReadCursor;
using fqk::RankSmem;
using fqk::Row;

// The whole (n_ctx, A + 1) u16 table (K4).
struct WholeRows {
    const uint16_t* cum;
    int32_t A;
    __device__ __forceinline__ const uint16_t* row(int64_t ctx) const {
        return cum + ctx * (A + 1);
    }
};

// The table cut into row shards: rows [s * n_local, (s + 1) * n_local) in
// the block at ptrs[s] (K18).  n_local is a power of two in every model
// (lg its log2); otherwise lg < 0 and the shard is a division.
struct ShardRows {
    const uint16_t* const* ptrs;
    int64_t n_local;
    int32_t lg;
    int32_t nshards;
    int32_t A;
    __device__ __forceinline__ const uint16_t* row(int64_t ctx) const {
        const int64_t s = lg >= 0 ? ctx >> lg : ctx / n_local;
        FQK_BOUND("frozen_wave", "row shard", s, nshards);
        const uint16_t* base = reinterpret_cast<const uint16_t*>(
            __ldg(reinterpret_cast<const unsigned long long*>(ptrs) + s));
        return base + (ctx - s * n_local) * (A + 1);
    }
};

struct WaveLane {
    ModelState s;
    ReadCursor cur;
    uint32_t x;       // rANS state
    uint32_t xn;      // this wave's state before renormalization
    int32_t n;        // symbols in the lane
    int32_t sym;      // this wave's symbol
};

template <class Src>
struct WaveArgs {
    const uint32_t* states0;
    const uint16_t* words;
    int64_t W;
    const int32_t* cgrid;
    int32_t J, T, L;
    Src rows;
    WaveLane* lanes;  // decode_multi's lane states
    int32_t per;      // lanes a thread (decode_multi)
    uint8_t* out;
    uint32_t* x_final;   // (L,) final states, or null
};

// --- the row fetch and the search in registers ----------------------------

template <int NSEG>
__device__ __forceinline__ void row_fetch(Row<NSEG>& r, const uint16_t* row,
                                          int32_t A) {
    fqk::row_at(r, row, 2 * (A + 1));
}

// Entries e and e + 1 (the low and high halves of w) into the search.
__device__ __forceinline__ void search_pair(uint32_t w, int32_t e, int32_t A,
                                            uint32_t low, int32_t& cnt,
                                            uint32_t& start, uint32_t& end) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const uint32_t v = (w >> (16 * h)) & 0xFFFFu;
        const int32_t k = e + h;
        if (k == 0) {
            start = max(start, v);
        } else if (k >= 1 && k < A) {
            if (v <= low) {
                ++cnt;
                start = max(start, v);
            } else {
                end = min(end, v);
            }
        } else if (k == A) {
            end = min(end, v);
        }
    }
}

// sym = #{s in 1..A-1 : F[s] <= low} (the largest such s, rows being
// non-decreasing), start = F[sym], f = F[sym + 1] - start.
template <int NSEG>
__device__ __forceinline__ void row_search(Row<NSEG>& r, int32_t A,
                                           uint32_t low, int32_t& sym,
                                           uint32_t& start, uint32_t& f) {
    int32_t cnt = 0;
    uint32_t st = 0, en = 0xFFFFu;
    for (int32_t i0 = 0; i0 < r.nseg; i0 += NSEG) {
        if (i0) fqk::load_batch(r, i0);
#pragma unroll
        for (int i = 0; i < NSEG; ++i) {
            const int32_t e = (16 * (i0 + i) - r.head) >> 1;
            search_pair(r.seg[i].x, e, A, low, cnt, st, en);
            search_pair(r.seg[i].y, e + 2, A, low, cnt, st, en);
            search_pair(r.seg[i].z, e + 4, A, low, cnt, st, en);
            search_pair(r.seg[i].w, e + 6, A, low, cnt, st, en);
        }
    }
    sym = cnt;
    start = st;
    f = en - st;
}

// Segments loaded at once: seq rows (A = 4) fit in 2, quality rows of up
// to 56 symbols in 8.
template <int KIND>
constexpr int kSeg = KIND == 0 ? 2 : 8;

// --- one lane a thread: state in registers --------------------------------

template <int KIND, int NSEG, class Src>
__global__ void __launch_bounds__(fqk::kOneThreads)
decode_one(WaveArgs<Src> a, ModelSpec m) {
    cg::cluster_group cl = cg::this_cluster();
    __shared__ RankSmem sm;
    const int32_t L = a.L;
    const int32_t A = a.rows.A;
    const int32_t l = static_cast<int32_t>(cl.block_rank()) * blockDim.x
                      + threadIdx.x;
    const bool has = l < L;
    const int32_t n = has ? fqk::lane_length(a.cgrid, a.J, L, l) : 0;
    uint32_t x = has ? a.states0[l] : 0u;
    ModelState s;
    fqk::model_reset<KIND>(m, s);
    ReadCursor cur{-1, 0, 0};
    Row<NSEG> row;
    if (n > 0) {
        fqk::cursor_next(cur, a.cgrid, a.J, L, l);
        row_fetch(row, a.rows.row(fqk::model_ctx<KIND>(m, s, cur.pos)), A);
    }
    fqk::rank_init(cl, sm);
    int64_t off = 0;
    for (int32_t t = 0; t < a.T; ++t) {
        const int64_t idx = int64_t(t) * L + l;
        uint32_t xn = 0;
        int32_t need = 0;
        if (t < n) {
            const uint32_t low = x & fqk::kMaskM;
            int32_t sym;
            uint32_t start, f;
            row_search(row, A, low, sym, start, f);
            xn = f * (x >> fqk::kProbBits) + low - start;
            need = xn < fqk::kRansL;
            a.out[idx] = static_cast<uint8_t>(sym);
            fqk::model_update<KIND>(m, s, sym);
            --cur.rem;
            ++cur.pos;
            if (t + 1 < n) {       // the next wave's row, fetched now
                if (fqk::cursor_next(cur, a.cgrid, a.J, L, l))
                    fqk::model_reset<KIND>(m, s);
                row_fetch(row,
                          a.rows.row(fqk::model_ctx<KIND>(m, s, cur.pos)), A);
            }
        } else if (has) {
            a.out[idx] = 0;
        }
        int32_t grand;
        const int32_t rank = fqk::cluster_rank(cl, sm, t, need, &grand);
        if (t < n)
            x = need ? (xn << 16) | fqk::word_at(a.words, a.W, off + rank)
                     : xn;
        off += grand;
        fqk::prefetch_words(cl, a.words, a.W, L, off);
    }
    if (a.x_final != nullptr && has) a.x_final[l] = x;
}

// --- several lanes a thread: state in scratch -----------------------------

template <int KIND, int NSEG, class Src>
__global__ void __launch_bounds__(fqk::kMultiThreads)
decode_multi(WaveArgs<Src> a, ModelSpec m) {
    cg::cluster_group cl = cg::this_cluster();
    __shared__ RankSmem sm;
    const int32_t L = a.L;
    const int32_t A = a.rows.A;
    const int32_t g = static_cast<int32_t>(cl.block_rank()) * blockDim.x
                      + threadIdx.x;
    const int32_t l0 = min(g * a.per, L);
    const int32_t l1 = min(l0 + a.per, L);
    for (int32_t l = l0; l < l1; ++l) {
        WaveLane& ln = a.lanes[l];
        fqk::model_reset<KIND>(m, ln.s);
        ln.cur = ReadCursor{-1, 0, 0};
        ln.x = a.states0[l];
        ln.n = fqk::lane_length(a.cgrid, a.J, L, l);
    }
    fqk::rank_init(cl, sm);
    int64_t off = 0;
    for (int32_t t = 0; t < a.T; ++t) {
        int32_t need = 0;
        for (int32_t l = l0; l < l1; ++l) {
            WaveLane& ln = a.lanes[l];
            if (t >= ln.n) continue;
            if (fqk::cursor_next(ln.cur, a.cgrid, a.J, L, l))
                fqk::model_reset<KIND>(m, ln.s);
            Row<NSEG> row;
            row_fetch(row,
                      a.rows.row(fqk::model_ctx<KIND>(m, ln.s, ln.cur.pos)),
                      A);
            const uint32_t low = ln.x & fqk::kMaskM;
            uint32_t start, f;
            row_search(row, A, low, ln.sym, start, f);
            ln.xn = f * (ln.x >> fqk::kProbBits) + low - start;
            need += ln.xn < fqk::kRansL;
        }
        int32_t grand;
        int64_t w = off + fqk::cluster_rank(cl, sm, t, need, &grand);
        for (int32_t l = l0; l < l1; ++l) {
            WaveLane& ln = a.lanes[l];
            const int64_t idx = int64_t(t) * L + l;
            if (t >= ln.n) {
                a.out[idx] = 0;
                continue;
            }
            uint32_t xn = ln.xn;
            if (xn < fqk::kRansL)
                xn = (xn << 16) | fqk::word_at(a.words, a.W, w++);
            ln.x = xn;
            a.out[idx] = static_cast<uint8_t>(ln.sym);
            fqk::model_update<KIND>(m, ln.s, ln.sym);
            --ln.cur.rem;
            ++ln.cur.pos;
        }
        off += grand;
        fqk::prefetch_words(cl, a.words, a.W, L, off);
    }
    if (a.x_final != nullptr)
        for (int32_t l = l0; l < l1; ++l) a.x_final[l] = a.lanes[l].x;
}

// --- launch ---------------------------------------------------------------

template <class Src>
using WaveKernel = void (*)(WaveArgs<Src>, ModelSpec);

template <class Src>
WaveKernel<Src> wave_kernel(int32_t kind, bool one) {
    if (kind == 0) return one ? &decode_one<0, kSeg<0>, Src>
                              : &decode_multi<0, kSeg<0>, Src>;
    if (kind == 1) return one ? &decode_one<1, kSeg<1>, Src>
                              : &decode_multi<1, kSeg<1>, Src>;
    return nullptr;
}

// The cluster for L lanes: out[0] CTAs, out[1] threads a CTA, out[2]
// lanes a thread, out[3] how many such clusters fit the card.
template <class Src>
int wave_shape(int32_t L, int32_t kind, int32_t* out) {
    const fqk::Shape sh = fqk::shape_for(L);
    const WaveKernel<Src> k = wave_kernel<Src>(kind, sh.one);
    if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return fqk::report_shape(sh, reinterpret_cast<const void*>(k), out);
}

// One launch decodes the stream; a.per is set here.  lanes: scratch of L
// WaveLane when L > 4096.
template <class Src>
int wave_decode(WaveArgs<Src> a, const ModelSpec& m, cudaStream_t st) {
    if (a.L <= 0 || a.T <= 0) return 0;
    const fqk::Shape sh = fqk::shape_for(a.L);
    const WaveKernel<Src> k = wave_kernel<Src>(m.kind, sh.one);
    if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    a.per = sh.per;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = fqk::cluster_config(sh, st, attr);
    const cudaError_t rc = cudaLaunchKernelEx(&cfg, k, a, m);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
