// K4 frozen_decode: frozen-table rANS decode of one stream, one thread
// block cluster.
//
// Replaces fastqueeze_tpu/ops/engine.py _device_aux (B1) and
// _decode_frozen (B6).  The wave loop is sequential: a lane that
// renormalizes reads the word at off + its rank among the lanes that
// renormalize in this wave, so wave t + 1's word offset depends on every
// lane of every earlier wave.  Each wave is a dependent chain, and what
// bounds the stream on an H100 is that chain's latency, T times over:
// fetch the context's cumulative row (L2, or HBM for tables past the 50
// MB L2), find the symbol, rank the lanes that renormalize, fetch their
// words.  The first design ran one CTA of 1,024 threads per stream, 4
// lanes a thread walked one after another with their state in global
// scratch, a dependent binary search over the row (log2 A loads) and a
// three-barrier block scan: ~35 us a wave on the order-10 seq table.
//
// This design spreads a wave over a cluster of up to 8 CTAs on 8 SMs and
// shortens its chain:
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
//   - the rank: each CTA scans its threads' need counts (one
//     __syncthreads), then pushes its total, tagged with the wave, into
//     a slot of every CTA's shared memory (one 64-bit remote store each
//     through distributed shared memory), and each warp polls its own
//     CTA's slots for the lower ranks' sum and the grand total.  The
//     slots are double-buffered by wave parity, so no cluster barrier
//     runs inside the wave loop (on an H100 the order-10 seq stream
//     took 2.98 us a wave with one cluster barrier a wave, 2.60 us with
//     this), and every CTA advances its own copy of off by the grand
//     total (no global counter, no atomics).  The cluster's shape and
//     its exchanges live in cluster_xchg.cuh, shared with K6;
//   - the word read stays words[min(off + rank, W - 1)] (the clamp keeps
//     a corrupt payload inside the padded buffer, as the reference's
//     clamp does); the next wave's window of words is prefetched into L2
//     once off is known.
// Padding slots (t >= the lane's length) write 0.  The output is the
// (T, L) u8 symbol grid, as before.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_xchg.cuh"
#include "lane_walk.cuh"

namespace cg = cooperative_groups;

namespace {

using fqk::ModelSpec;
using fqk::ModelState;
using fqk::ReadCursor;

using fqk::kMultiThreads;
using fqk::kOneThreads;
using fqk::RankSmem;
using fqk::Shape;

struct Lane {
    ModelState s;
    ReadCursor cur;
    uint32_t x;       // rANS state
    uint32_t xn;      // this wave's state before renormalization
    int32_t n;        // symbols in the lane
    int32_t sym;      // this wave's symbol
};

struct Args {
    const uint32_t* states0;
    const uint16_t* words;
    int64_t W;
    const int32_t* cgrid;
    int32_t J, T, L;
    const uint16_t* cum;
    int32_t A;
    Lane* lanes;      // decode_multi's lane states
    int32_t per;      // lanes a thread (decode_multi)
    uint8_t* out;
};

// --- the row fetch and the search in registers ----------------------------

using fqk::Row;

// The row of ctx: its A + 1 u16 entries.
template <int NSEG>
__device__ __forceinline__ void row_fetch(Row<NSEG>& r,
                                          const uint16_t* __restrict__ cum,
                                          int64_t ctx, int32_t A) {
    fqk::row_at(r, cum + ctx * (A + 1), 2 * (A + 1));
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

__device__ __forceinline__ uint32_t renorm(const Args& a, uint32_t xn,
                                           int64_t w) {
    return (xn << 16) | fqk::word_at(a.words, a.W, w);
}

// --- one lane a thread: state in registers --------------------------------

template <int KIND, int NSEG>
__global__ void __launch_bounds__(kOneThreads)
decode_one(Args a, ModelSpec m) {
    cg::cluster_group cl = cg::this_cluster();
    __shared__ RankSmem sm;
    const int32_t L = a.L;
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
        row_fetch(row, a.cum, fqk::model_ctx<KIND>(m, s, cur.pos), a.A);
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
            row_search(row, a.A, low, sym, start, f);
            xn = f * (x >> fqk::kProbBits) + low - start;
            need = xn < fqk::kRansL;
            a.out[idx] = static_cast<uint8_t>(sym);
            fqk::model_update<KIND>(m, s, sym);
            --cur.rem;
            ++cur.pos;
            if (t + 1 < n) {       // the next wave's row, fetched now
                if (fqk::cursor_next(cur, a.cgrid, a.J, L, l))
                    fqk::model_reset<KIND>(m, s);
                row_fetch(row, a.cum, fqk::model_ctx<KIND>(m, s, cur.pos),
                          a.A);
            }
        } else if (has) {
            a.out[idx] = 0;
        }
        int32_t grand;
        const int32_t rank = fqk::cluster_rank(cl, sm, t, need, &grand);
        if (t < n) x = need ? renorm(a, xn, off + rank) : xn;
        off += grand;
        fqk::prefetch_words(cl, a.words, a.W, L, off);
    }
}

// --- several lanes a thread: state in scratch -----------------------------

template <int KIND, int NSEG>
__global__ void __launch_bounds__(kMultiThreads)
decode_multi(Args a, ModelSpec m) {
    cg::cluster_group cl = cg::this_cluster();
    __shared__ RankSmem sm;
    const int32_t L = a.L;
    const int32_t g = static_cast<int32_t>(cl.block_rank()) * blockDim.x
                      + threadIdx.x;
    const int32_t l0 = min(g * a.per, L);
    const int32_t l1 = min(l0 + a.per, L);
    for (int32_t l = l0; l < l1; ++l) {
        Lane& ln = a.lanes[l];
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
            Lane& ln = a.lanes[l];
            if (t >= ln.n) continue;
            if (fqk::cursor_next(ln.cur, a.cgrid, a.J, L, l))
                fqk::model_reset<KIND>(m, ln.s);
            Row<NSEG> row;
            row_fetch(row, a.cum, fqk::model_ctx<KIND>(m, ln.s, ln.cur.pos),
                      a.A);
            const uint32_t low = ln.x & fqk::kMaskM;
            uint32_t start, f;
            row_search(row, a.A, low, ln.sym, start, f);
            ln.xn = f * (ln.x >> fqk::kProbBits) + low - start;
            need += ln.xn < fqk::kRansL;
        }
        int32_t grand;
        int64_t w = off + fqk::cluster_rank(cl, sm, t, need, &grand);
        for (int32_t l = l0; l < l1; ++l) {
            Lane& ln = a.lanes[l];
            const int64_t idx = int64_t(t) * L + l;
            if (t >= ln.n) {
                a.out[idx] = 0;
                continue;
            }
            uint32_t xn = ln.xn;
            if (xn < fqk::kRansL) xn = renorm(a, xn, w++);
            ln.x = xn;
            a.out[idx] = static_cast<uint8_t>(ln.sym);
            fqk::model_update<KIND>(m, ln.s, ln.sym);
            --ln.cur.rem;
            ++ln.cur.pos;
        }
        off += grand;
        fqk::prefetch_words(cl, a.words, a.W, L, off);
    }
}

// --- launch ---------------------------------------------------------------

// Segments loaded at once: seq rows (A = 4) fit in 2, quality rows of up
// to 56 symbols in 8.
template <int KIND>
constexpr int kSeg = KIND == 0 ? 2 : 8;

using KernelFn = void (*)(Args, ModelSpec);

KernelFn kernel_for(int32_t kind, bool one) {
    if (kind == 0) return one ? &decode_one<0, kSeg<0>>
                              : &decode_multi<0, kSeg<0>>;
    if (kind == 1) return one ? &decode_one<1, kSeg<1>>
                              : &decode_multi<1, kSeg<1>>;
    return nullptr;
}

}  // namespace

// lanes: scratch of L * sizeof(Lane) bytes (fq_decode_lane_bytes()), used
// when L > 4096 (several lanes a thread).
extern "C" int64_t fq_decode_lane_bytes() { return sizeof(Lane); }

// The cluster K4 launches for L lanes: out[0] CTAs (the cluster's size),
// out[1] threads a CTA, out[2] lanes a thread, out[3] how many such
// clusters the card can hold at once (cudaOccupancyMaxActiveClusters;
// 0: the card cannot run it).
extern "C" int fq_frozen_decode_shape(int32_t L, int32_t kind,
                                      int32_t* out) {
    const Shape sh = fqk::shape_for(L);
    const KernelFn k = kernel_for(kind, sh.one);
    if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return fqk::report_shape(sh, reinterpret_cast<const void*>(k), out);
}

extern "C" int fq_frozen_decode(
        const uint32_t* states0, const uint16_t* words, int64_t W,
        const int32_t* cgrid, int32_t J, int32_t T, int32_t L,
        const uint16_t* cum, int32_t A, int32_t kind, int64_t a, int64_t b,
        int64_t c, int64_t d, int64_t e, int64_t f, int64_t g, void* lanes,
        uint8_t* out, void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    if (L <= 0 || T <= 0) return 0;
    const Shape sh = fqk::shape_for(L);
    const KernelFn k = kernel_for(kind, sh.one);
    if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const Args args{states0, words, W, cgrid, J, T, L, cum, A,
                    static_cast<Lane*>(lanes), sh.per, out};
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = fqk::cluster_config(
        sh, static_cast<cudaStream_t>(stream), attr);
    const cudaError_t rc = cudaLaunchKernelEx(&cfg, k, args, m);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    return static_cast<int>(cudaGetLastError());
}
