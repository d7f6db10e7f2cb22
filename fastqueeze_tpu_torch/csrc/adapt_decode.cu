// K6 adapt_decode: adaptive rANS decode of one stream, one thread-block
// cluster.
//
// Replaces fastqueeze_tpu/ops/engine.py _device_aux (B1), the models' lane
// walk (B2, B2'), _quant per row (B3) and _decode with _wave_update_tot
// (B8).  The wave loop is sequential twice over: a lane that renormalizes
// reads the word at off + its rank among the lanes that renormalize in
// this wave, and every lane reads its context's count row as the
// previous wave left it (added to and halved).  What bounds a stream on
// an H100 is therefore the latency of each wave's chain, T times over:
// fetch the row, find the symbol, rank the lanes, add to the table, and
// make the adds (and any halving) visible to every lane before the next
// wave's fetch.  The first design ran one CTA of 1,024 threads per
// stream, its lanes' state in global scratch, a dependent linear walk
// over the row (one L2 round trip a symbol: up to 39 for quality, 255
// for byte models) and five barriers a wave: ~25 us a wave on the
// order-10 seq stream.
//
// This design is K4's cluster (cluster_xchg.cuh) with the table update:
//   - up to 8 CTAs x 512 threads, one lane a thread, its model state,
//     read cursor and rANS state in registers (adapt_one); above 4,096
//     lanes up to 8 x 1,024 threads own ceil(L / 8192) lanes each, their
//     state in scratch (adapt_multi);
//   - the count row is fetched with independent loads: the aligned
//     16-byte segments holding its A int32 counts, with the row total,
//     issued together, the prefix built in registers.  The symbol is the
//     count of s in 1..A-1 with cum_s <= ((low + 1) * C - 1) >> 14, which
//     is floor(cum_s * 2^14 / C) <= low, the reference's own test; start
//     and freq come from the same prefix.  Rows of up to 44 counts load
//     whole.  A longer row (byte models, A = 256) keeps the sums of its
//     blocks of 32 counts beside it (added to with the counts, rebuilt by
//     the halving), and its search loads the block sums with the total,
//     then the one block they point to: two round trips, where a walk
//     through the row took up to eight, and a warp waits for its
//     slowest lane.  The search has no branch on the data, so a warp's
//     lanes stay together: segment sums, the segment holding the
//     threshold, its four counts one by one;
//   - the next wave's row cannot be fetched early (this wave's adds
//     change it), but it is prefetched into L2 once the next context is
//     known, so the fetch after the exchanges finds it there;
//   - per wave three steps run across the cluster: the rank (a
//     push-and-poll exchange, which also says every lane has read its
//     pre-update row, so adds may start), then each lane's atomicAdd at
//     (ctx, sym) and on tot[ctx], then an exchange that orders them at
//     cluster scope (release fence before the push, acquire after the
//     poll) and carries "some touched row is over cap": atomicAdd on tot
//     returns the total before the add, so the last adder of a row sees
//     whether it crossed.  Only on such waves are rows halved: the lane
//     whose add took a row over cap has its warp halve the row together
//     (one load of 32 counts a lane, the halvings in registers), at most
//     n_halve times; then one more exchange.  Every other wave pays two
//     exchanges;
//   - the lanes spread over all 8 CTAs (2,048 lanes: 8 x 256 threads), so
//     each SM issues a quarter of a wave's search and table work.
// Padding lanes are skipped (every row stays at or under cap; the
// wrapper checks init * A <= cap).  Padding slots write 0.  The output is
// the (T, L) u8 symbol grid.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_xchg.cuh"
#include "lane_walk.cuh"

namespace cg = cooperative_groups;

namespace {

using fqk::kMultiThreads;
using fqk::kOneThreads;
using fqk::ModelSpec;
using fqk::ModelState;
using fqk::RankSmem;
using fqk::ReadCursor;
using fqk::Shape;

struct Lane {
    ModelState s;
    ReadCursor cur;
    int64_t ctx;      // this wave's context
    uint32_t x;       // rANS state
    uint32_t xn;      // this wave's state before renormalization
    int32_t n;        // symbols in the lane
    int32_t sym;      // this wave's symbol
    int32_t C;        // the pre-update total of row ctx
    int32_t halve;    // rescales row ctx after this wave
};

struct Args {
    const uint32_t* states0;
    const uint16_t* words;
    int64_t W;
    const int32_t* cgrid;
    int32_t J, T, L;
    const int32_t* ctxg;
    int32_t A, inc, cap, n_halve;
    int32_t* counts;
    int32_t* tot;
    int32_t* blk;     // block sums, kBlkStride a row (A > kDirectA)
    int32_t nb;       // blocks a row (0: rows searched whole)
    Lane* lanes;      // adapt_multi's lane states
    int32_t per;      // lanes a thread (adapt_multi)
    uint8_t* out;
};

// --- the row fetch and the count search in registers ----------------------

// Rows of up to kDirectA counts are searched whole; a longer row keeps
// the sums of its blocks of 32 counts (blk, kBlkStride a row), and its
// search covers the one block the sums point to.  Either way the counts
// searched fit NSEG = 12 aligned 16-byte segments, loaded at once.
constexpr int32_t kDirectA = 44;
constexpr int kBlkStride = 8;          // A <= 256

// The counts [lo, hi) a search covers, in the aligned segments that hold
// them (head: the byte offset of count lo in the first), and the row's
// total and block sums.
template <int NSEG>
struct CountRow {
    uint4 seg[NSEG];
    int4 bs[2];
    int64_t ctx;
    int32_t C, head, lo, hi;
};

template <int NSEG>
__device__ __forceinline__ void load_range(CountRow<NSEG>& r, const Args& a,
                                           int32_t lo, int32_t hi) {
    const uintptr_t p =
        reinterpret_cast<uintptr_t>(a.counts + r.ctx * a.A + lo);
    const uint4* base = reinterpret_cast<const uint4*>(p & ~uintptr_t(15));
    r.head = static_cast<int32_t>(p & 15);
    r.lo = lo;
    r.hi = hi;
    const int32_t nseg = (r.head + 4 * (hi - lo) + 15) >> 4;
#pragma unroll
    for (int i = 0; i < NSEG; ++i)
        r.seg[i] = i < nseg ? __ldcg(base + i) : make_uint4(0, 0, 0, 0);
}

// The row total with the whole row, or with the row's block sums.
template <int NSEG>
__device__ __forceinline__ void row_fetch(CountRow<NSEG>& r, const Args& a,
                                          int64_t ctx) {
    r.ctx = ctx;
    r.C = __ldcg(a.tot + ctx);
    if (a.nb) {
        const int4* b =
            reinterpret_cast<const int4*>(a.blk + ctx * kBlkStride);
        r.bs[0] = __ldcg(b);
        r.bs[1] = __ldcg(b + 1);
    } else {
        load_range(r, a, 0, a.A);
    }
}

// The lines of row ctx, its total and block sums into L2, ahead of the
// fetch.
__device__ __forceinline__ void prefetch_row(const Args& a, int64_t ctx) {
    const uintptr_t p = reinterpret_cast<uintptr_t>(a.counts + ctx * a.A);
    for (uintptr_t q = p & ~uintptr_t(127); q < p + 4 * uintptr_t(a.A);
         q += 128)
        asm volatile("prefetch.global.L2 [%0];" :: "l"(q));
    asm volatile("prefetch.global.L2 [%0];" :: "l"(a.tot + ctx));
    if (a.nb)
        asm volatile("prefetch.global.L2 [%0];"
                     :: "l"(a.blk + ctx * kBlkStride));
}

// Count k (value v) of [lo, hi) into the search; c holds cum_k on entry.
__device__ __forceinline__ void search_entry(uint32_t v, int32_t k,
                                             int32_t lo, int32_t hi,
                                             int64_t th, int32_t& cnt,
                                             int32_t& c, int32_t& st,
                                             int32_t& en) {
    if (k < lo || k >= hi) return;
    if (k >= 1) {
        if (c <= th) {
            ++cnt;
            st = c;
        } else {
            en = min(en, c);
        }
    }
    c += static_cast<int32_t>(v);
}

// sym = #{s in 1..A-1 : cum_s <= th} (the largest such s, cum being
// non-decreasing), start = F[sym], f = F[sym + 1] - start, with F_s =
// floor(cum_s * 2^14 / C).  Without branches on the data, so the lanes
// of a warp stay together: the block whose first prefix is at or below
// th (block sums), then the segment whose first prefix is (segment
// sums), all counts before it counted, then its four counts one by one.
template <int NSEG>
__device__ __forceinline__ void row_search(CountRow<NSEG>& r, const Args& a,
                                           uint32_t low, int32_t& sym,
                                           uint32_t& start, uint32_t& f) {
    const int32_t C = r.C;
    const int64_t th = ((int64_t(low) + 1) * C - 1) >> fqk::kProbBits;
    int32_t cum = 0, cnt = 0, en = C;
    if (a.nb) {
        const int32_t b[kBlkStride] = {r.bs[0].x, r.bs[0].y, r.bs[0].z,
                                       r.bs[0].w, r.bs[1].x, r.bs[1].y,
                                       r.bs[1].z, r.bs[1].w};
        int32_t j = 0;
        bool go = true;
#pragma unroll
        for (int k = 1; k < kBlkStride; ++k) {
            const int32_t nxt = cum + b[k - 1];
            const bool in = go && k < a.nb;
            if (in && nxt <= th) {
                cum = nxt;
                j = k;
            } else if (in) {
                en = nxt;          // the next block's first prefix
            }
            go = in && nxt <= th;
        }
        cnt = j ? 32 * j - 1 : 0;  // counts 1 .. 32 j - 1
        load_range(r, a, 32 * j, min(a.A, 32 * j + 32));
    }
    int32_t P = cum, Pb = cum, Pn = en, best = 0;
#pragma unroll
    for (int i = 0; i < NSEG; ++i) {
        const int32_t k = r.lo + ((16 * i - r.head) >> 2);
        const uint4 q = r.seg[i];
        const int32_t s =
            (k >= r.lo && k < r.hi ? static_cast<int32_t>(q.x) : 0)
            + (k + 1 >= r.lo && k + 1 < r.hi ? static_cast<int32_t>(q.y) : 0)
            + (k + 2 >= r.lo && k + 2 < r.hi ? static_cast<int32_t>(q.z) : 0)
            + (k + 3 < r.hi ? static_cast<int32_t>(q.w) : 0);
        if (k < r.hi && P <= th) {
            best = i;
            Pb = P;
        } else if (k < r.hi) {
            Pn = min(Pn, P);
        }
        P += s;
    }
    const int32_t k = r.lo + ((16 * best - r.head) >> 2);
    cnt += max(0, max(k, r.lo) - max(r.lo, 1));
    uint4 q = r.seg[0];
#pragma unroll
    for (int i = 1; i < NSEG; ++i)
        if (best == i) q = r.seg[i];
    int32_t c = Pb, st = 0;
    en = Pn;
    search_entry(q.x, k, r.lo, r.hi, th, cnt, c, st, en);
    search_entry(q.y, k + 1, r.lo, r.hi, th, cnt, c, st, en);
    search_entry(q.z, k + 2, r.lo, r.hi, th, cnt, c, st, en);
    search_entry(q.w, k + 3, r.lo, r.hi, th, cnt, c, st, en);
    sym = cnt;
    start = fqk::quant_cum(st, C);
    f = fqk::quant_cum(en, C) - start;
}

// The table update of one lane: inc at (ctx, sym) and on tot[ctx];
// returns whether the row is over cap after this add.  *halve: this lane
// rescales the row after the wave, the one lane whose add took the total
// over cap (or, for a row that began the wave over cap, the first adder,
// which found tot still at the C it read): atomicAdd returns the total
// before the add, and totals only grow within a wave.
__device__ __forceinline__ bool table_add(const Args& a, int64_t ctx,
                                          int32_t sym, int32_t C,
                                          bool* halve) {
    atomicAdd(a.counts + ctx * a.A + sym, a.inc);
    if (a.nb) atomicAdd(a.blk + ctx * kBlkStride + (sym >> 5), a.inc);
    const int32_t old = atomicAdd(a.tot + ctx, a.inc);
    const bool over = old + a.inc > a.cap;
    *halve = over && (old <= a.cap || old == C);
    return over;
}

// The halving of the rows this warp's lanes must rescale (`halve`, from
// table_add).  The whole warp takes one such row at a time: its counts
// load at once, 32 consecutive counts a load, are halved ((c + 1) >> 1)
// while the row total is over cap, at most n_halve times, in registers
// (the total from a warp sum), and are stored back with the new total
// and block sums.
__device__ __forceinline__ void warp_rescale(const Args& a, int64_t ctx,
                                             bool halve) {
    const int lane = threadIdx.x & 31;
    for (uint32_t hm = __ballot_sync(fqk::kFull, halve); hm; hm &= hm - 1) {
        const int64_t c = __shfl_sync(fqk::kFull, ctx, __ffs(hm) - 1);
        int32_t* row = a.counts + c * a.A;
        int32_t v[8];           // counts lane + 32 j (A <= 256)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int32_t k = lane + 32 * j;
            v[j] = k < a.A ? __ldcg(row + k) : 0;
        }
        int32_t total = __ldcg(a.tot + c);
        for (int32_t h = 0; h < a.n_halve && total > a.cap; ++h) {
            int32_t sum = 0;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                v[j] = (v[j] + 1) >> 1;
                sum += lane + 32 * j < a.A ? v[j] : 0;
            }
            total = __reduce_add_sync(fqk::kFull, sum);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (lane + 32 * j < a.A) __stcg(row + lane + 32 * j, v[j]);
            if (j < a.nb) {        // counts past A stay 0
                const int32_t bs = __reduce_add_sync(fqk::kFull, v[j]);
                if (lane == 0) __stcg(a.blk + c * kBlkStride + j, bs);
            }
        }
        if (lane == 0) __stcg(a.tot + c, total);
    }
}

// --- one lane a thread: state in registers --------------------------------

template <int KIND, int NSEG>
__global__ void __launch_bounds__(kOneThreads)
adapt_one(Args a, ModelSpec m) {
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
    int64_t ctx = 0;
    CountRow<NSEG> row;
    if (n > 0) {
        fqk::cursor_next(cur, a.cgrid, a.J, L, l);
        ctx = fqk::lane_ctx<KIND>(m, s, cur.pos, a.ctxg, l);
        row_fetch(row, a, ctx);
    }
    fqk::rank_init(cl, sm);
    int64_t off = 0;
    int32_t e = 0;                 // the cluster's exchange count
    for (int32_t t = 0; t < a.T; ++t) {
        const int64_t idx = int64_t(t) * L + l;
        uint32_t xn = 0;
        int32_t need = 0, sym = 0;
        int64_t nctx = 0;
        if (t < n) {
            const uint32_t low = x & fqk::kMaskM;
            uint32_t start, f;
            row_search(row, a, low, sym, start, f);
            xn = f * (x >> fqk::kProbBits) + low - start;
            need = xn < fqk::kRansL;
            a.out[idx] = static_cast<uint8_t>(sym);
            fqk::model_update<KIND>(m, s, sym);
            --cur.rem;
            ++cur.pos;
            if (t + 1 < n) {       // the next wave's row, into L2 now
                if (fqk::cursor_next(cur, a.cgrid, a.J, L, l))
                    fqk::model_reset<KIND>(m, s);
                nctx = fqk::lane_ctx<KIND>(m, s, cur.pos, a.ctxg, idx + L);
                prefetch_row(a, nctx);
            }
        } else if (has) {
            a.out[idx] = 0;
        }
        int32_t grand;
        const int32_t rank = fqk::cluster_rank(cl, sm, e++, need, &grand);
        bool over = false, halve = false;
        uint16_t word = 0;
        if (t < n) {
            if (need) word = fqk::word_at(a.words, a.W, off + rank);
            over = table_add(a, ctx, sym, row.C, &halve);
        }
        off += grand;
        if (fqk::cluster_any(cl, sm, e++, over)) {
            warp_rescale(a, ctx, halve);
            fqk::cluster_any(cl, sm, e++, false);
        }
        if (t < n) {
            x = need ? (xn << 16) | word : xn;
            if (t + 1 < n) {
                ctx = nctx;
                row_fetch(row, a, ctx);
            }
        }
        fqk::prefetch_words(cl, a.words, a.W, a.L, off);
    }
}

// --- several lanes a thread: state in scratch -----------------------------

template <int KIND, int NSEG>
__global__ void __launch_bounds__(kMultiThreads)
adapt_multi(Args a, ModelSpec m) {
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
    int32_t e = 0;
    for (int32_t t = 0; t < a.T; ++t) {
        int32_t need = 0;
        for (int32_t l = l0; l < l1; ++l) {
            Lane& ln = a.lanes[l];
            if (t >= ln.n) continue;
            if (fqk::cursor_next(ln.cur, a.cgrid, a.J, L, l))
                fqk::model_reset<KIND>(m, ln.s);
            ln.ctx = fqk::lane_ctx<KIND>(m, ln.s, ln.cur.pos, a.ctxg,
                                         int64_t(t) * L + l);
            CountRow<NSEG> row;
            row_fetch(row, a, ln.ctx);
            const uint32_t low = ln.x & fqk::kMaskM;
            uint32_t start, f;
            row_search(row, a, low, ln.sym, start, f);
            ln.C = row.C;
            ln.xn = f * (ln.x >> fqk::kProbBits) + low - start;
            need += ln.xn < fqk::kRansL;
        }
        int32_t grand;
        int64_t w = off + fqk::cluster_rank(cl, sm, e++, need, &grand);
        bool over = false;
        for (int32_t l = l0; l < l1; ++l) {
            Lane& ln = a.lanes[l];
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
            bool halve;
            over |= table_add(a, ln.ctx, ln.sym, ln.C, &halve);
            ln.halve = halve;
            fqk::model_update<KIND>(m, ln.s, ln.sym);
            --ln.cur.rem;
            ++ln.cur.pos;
        }
        off += grand;
        if (fqk::cluster_any(cl, sm, e++, over)) {
            // lane l0 + k of every thread in step (a.per is uniform)
            for (int32_t k = 0; k < a.per; ++k) {
                const int32_t l = l0 + k;
                const bool mine = l < l1 && t < a.lanes[l].n
                                  && a.lanes[l].halve;
                warp_rescale(a, mine ? a.lanes[l].ctx : 0, mine);
            }
            fqk::cluster_any(cl, sm, e++, false);
        }
        fqk::prefetch_words(cl, a.words, a.W, a.L, off);
    }
}

// --- launch ---------------------------------------------------------------

// The block sums of a table whose rows are searched by block: one thread
// a (row, block), zero past the row.
__global__ void blk_init(const int32_t* __restrict__ counts, int64_t n_ctx,
                         int32_t A, int32_t* __restrict__ blk) {
    const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n_ctx * kBlkStride) return;
    const int64_t r = i / kBlkStride;
    const int32_t j = static_cast<int32_t>(i % kBlkStride);
    int32_t s = 0;
    for (int32_t k = 32 * j; k < min(A, 32 * j + 32); ++k)
        s += counts[r * A + k];
    blk[i] = s;
}

// Scratch: the lanes' states (several lanes a thread), then the block sums.
struct Scratch {
    Lane* lanes;
    int32_t* blk;
    int64_t bytes;
};

Scratch scratch_at(void* base, int32_t L, int64_t n_ctx, int32_t A) {
    char* p = static_cast<char*>(base);
    const int64_t lane_bytes = (int64_t(L) * sizeof(Lane) + 15) & ~int64_t(15);
    const int64_t blk_bytes = A > kDirectA ? n_ctx * kBlkStride * 4 : 0;
    return Scratch{reinterpret_cast<Lane*>(p),
                   reinterpret_cast<int32_t*>(p + lane_bytes),
                   lane_bytes + blk_bytes};
}

// Segments loaded at once: seq rows (A = 4) fit in 2; 12 hold any row of
// up to 44 counts or any block of 32.
using KernelFn = void (*)(Args, ModelSpec);

template <int KIND>
KernelFn kernel_of(bool one) {
    constexpr int nseg = KIND == 0 ? 2 : 12;
    return one ? &adapt_one<KIND, nseg> : &adapt_multi<KIND, nseg>;
}

KernelFn kernel_for(int32_t kind, bool one) {
    switch (kind) {
        case 0: return kernel_of<0>(one);
        case 1: return kernel_of<1>(one);
        case 2: return kernel_of<2>(one);
        case 3: return kernel_of<3>(one);
        case 4: return kernel_of<4>(one);
        default: return nullptr;
    }
}

}  // namespace

// Bytes of fq_adapt_decode's scratch for L lanes and an (n_ctx, A)
// table.
extern "C" int64_t fq_adapt_decode_scratch_bytes(int32_t L, int64_t n_ctx,
                                                 int32_t A) {
    return scratch_at(nullptr, L, n_ctx, A).bytes;
}

// The cluster K6 launches for L lanes: out[0] CTAs (the cluster's size),
// out[1] threads a CTA, out[2] lanes a thread, out[3] how many such
// clusters the card can hold at once (cudaOccupancyMaxActiveClusters;
// 0: the card cannot run it).
extern "C" int fq_adapt_decode_shape(int32_t L, int32_t kind, int32_t* out) {
    const Shape sh = fqk::shape_for(L, true);
    const KernelFn k = kernel_for(kind, sh.one);
    if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return fqk::report_shape(sh, reinterpret_cast<const void*>(k), out);
}

// counts: the (n_ctx, A) int32 starting table, tot its (n_ctx,) row
// totals; the kernel updates both in place.  ctxg is read for kind 4
// only.  scratch: fq_adapt_decode_scratch_bytes(L, n_ctx, A) bytes.
extern "C" int fq_adapt_decode(
        const uint32_t* states0, const uint16_t* words, int64_t W,
        const int32_t* cgrid, int32_t J, int32_t T, int32_t L,
        const int32_t* ctxg, int32_t A, int32_t kind, int64_t a, int64_t b,
        int64_t c, int64_t d, int64_t e, int64_t f, int64_t g, int32_t inc,
        int32_t cap, int32_t n_halve, int32_t* counts, int32_t* tot,
        int64_t n_ctx, void* scratch, uint8_t* out, void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    if (L <= 0 || T <= 0) return 0;
    const Shape sh = fqk::shape_for(L, true);
    const KernelFn k = kernel_for(kind, sh.one);
    if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (kind == 0 ? A > 4 : A > 32 * kBlkStride)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Scratch s = scratch_at(scratch, L, n_ctx, A);
    const int32_t nb = A > kDirectA ? (A + 31) / 32 : 0;
    if (nb) {
        const int64_t n = n_ctx * kBlkStride;
        blk_init<<<(n + 255) / 256, 256, 0, st>>>(counts, n_ctx, A, s.blk);
    }
    const Args args{states0, words, W, cgrid, J, T, L, ctxg, A, inc, cap,
                    n_halve, counts, tot, s.blk, nb, s.lanes, sh.per, out};
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = fqk::cluster_config(sh, st, attr);
    const cudaError_t rc = cudaLaunchKernelEx(&cfg, k, args, m);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    return static_cast<int>(cudaGetLastError());
}
