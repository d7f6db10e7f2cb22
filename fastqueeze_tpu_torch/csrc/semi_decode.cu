// K12 semi_decode: semi-adaptive rANS decode of one stream.
//
// Replaces fastqueeze_tpu/ops/engine.py _decode_semi (B9, decode half)
// with _snapshot_sf and _rescale_full, plus _device_aux (B1) and the
// models' lane walk (B2, B2').  Per chunk of `chunk` waves, two launches:
//   1. a boundary pass over the rows that can have changed (semi_table.cuh,
//      the one copy K11 runs too): before the first chunk every row; at
//      every later boundary the rows the last chunk's adds touched (each
//      slot writes its row into a ring of chunk x L entries) and the rows
//      the last boundary left over cap, each once: halve while over cap,
//      up to n_halve times, then write the packed snapshot;
//   2. the chunk's waves on one thread-block cluster of up to 8 CTAs, as
//      K4 (frozen_decode.cu) decodes a stream: inside a chunk the table
//      every lane reads is the snapshot, which nothing writes until the
//      next boundary, and the count adds go to `counts`, which nothing
//      reads until then, so a chunk is a frozen decode plus adds.  Lanes
//      spread over the cluster's threads (cluster_xchg.cuh); up to 8 x
//      512 lanes one lane a thread with its walk in registers
//      (chunk_one), above that ceil(L / 8192) lanes a thread with their
//      walk in scratch (chunk_multi).  Per wave each lane steps its
//      cursor and model, fetches its context's snapshot row (A words
//      start | end << 16, one 16-byte load a 4 words, all at once),
//      counts the words whose start F[s] (s in 1..A-1) is <= the state's
//      slot: sym = that count, which on non-decreasing rows is the
//      reference's binary search ("largest s with F[s] <= low"), zero-
//      frequency symbols included; decodes; ranks the lanes that
//      renormalize across the cluster (the push-and-poll exchange) and
//      reads words[min(off + rank, W - 1)]; adds inc at (ctx, sym) with a
//      fire-and-forget red.global.add; and in chunk_one fetches the next
//      wave's row before the rank, so it arrives while the rank runs.
// A lane's walk (model state, cursor, rANS state) and the word offset
// carry from one chunk's launch to the next in scratch (the carry of
// _decode_semi's outer scan).  A last boundary pass only halves, so the
// final counts are _decode_semi's.  The first design ran each chunk's
// waves on one CTA of 1,024 threads (a binary search of ceil(log2 A)
// dependent loads and a three-barrier block scan a wave, two lanes a
// thread in scratch: ~18 us a wave on an H100).  What bounds this one:
// each wave's chain (row fetch from L2, the count, the rank exchange, the
// word fetch), T times over, then the boundary passes over the table
// (device-memory traffic: the table read, the snapshot written).

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "check.cuh"
#include "cluster_xchg.cuh"
#include "lane_walk.cuh"
#include "semi_table.cuh"

namespace cg = cooperative_groups;

namespace {

using fqk::ModelSpec;
using fqk::ModelState;
using fqk::ReadCursor;

using fqk::kMultiThreads;
using fqk::kOneThreads;
using fqk::RankSmem;
using fqk::Shape;

// A lane's walk between chunks (and, in chunk_multi, inside a wave).
struct Lane {
    ModelState s;
    ReadCursor cur;
    uint32_t x;       // rANS state
    uint32_t xn;      // chunk_multi: this wave's state before renorm
    int32_t n;        // symbols in the lane
    int32_t sym;      // chunk_multi: this wave's symbol
    int64_t ctx;      // chunk_multi: this wave's context
};

struct Args {
    const uint32_t* states0;
    const uint16_t* words;
    int64_t W;
    const int32_t* cgrid;
    int32_t J, L, t0, t1;     // the chunk: waves [t0, t1)
    const uint32_t* snap;     // (n_ctx, A) start | end << 16
    int32_t* counts;
    int64_t n_entries;        // n_ctx * A
    int32_t A, inc;
    Lane* lanes;
    int32_t per;              // lanes a thread (chunk_multi)
    int64_t* off;             // the word offset at the chunk's start
    int32_t* ring;            // (chunk, L) the slots' rows, -1 at padding
    int32_t* n_zero;          // the next boundary's over-cap list count
    uint8_t* out;
};

// --- the snapshot row and the count search --------------------------------

using fqk::Row;

// The snapshot row of ctx: its A words.
template <int NSEG>
__device__ __forceinline__ void row_fetch(Row<NSEG>& r, const Args& a,
                                          int64_t ctx) {
    FQK_BOUND("semi_decode", "snap", (ctx + 1) * a.A - 1, a.n_entries);
    fqk::row_at(r, a.snap + ctx * a.A, 4 * a.A);
}

// Word e (F[e] | F[e + 1] << 16) into the search: F[e] for e in 1..A-1
// counts when <= low (start the largest such, or F[0]) and bounds end
// from above when not; F[A], the last word's high half, bounds end.
__device__ __forceinline__ void search_word(uint32_t w, int32_t e, int32_t A,
                                            uint32_t low, int32_t& cnt,
                                            uint32_t& start, uint32_t& end) {
    if (e < 0 || e >= A) return;
    const uint32_t F = w & 0xFFFFu;
    if (e == 0) {
        start = max(start, F);
    } else if (F <= low) {
        ++cnt;
        start = max(start, F);
    } else {
        end = min(end, F);
    }
    if (e == A - 1) end = min(end, w >> 16);
}

// sym = #{s in 1..A-1 : F[s] <= low}, start = F[sym], f = F[sym + 1] -
// start.
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
            const int32_t e = (16 * (i0 + i) - r.head) >> 2;
            search_word(r.seg[i].x, e, A, low, cnt, st, en);
            search_word(r.seg[i].y, e + 1, A, low, cnt, st, en);
            search_word(r.seg[i].z, e + 2, A, low, cnt, st, en);
            search_word(r.seg[i].w, e + 3, A, low, cnt, st, en);
        }
    }
    sym = cnt;
    start = st;
    f = en - st;
}

// --- per wave ---------------------------------------------------------------

// Slot (t, l)'s add at (ctx, sym), and its row in the chunk's ring of
// touched rows; a padding slot writes 0 out and -1 in the ring.
__device__ __forceinline__ void count_add(const Args& a, int32_t t, int32_t l,
                                          int64_t ctx, int32_t sym) {
    const int64_t i = ctx * a.A + sym;
    FQK_BOUND("semi_decode", "counts", i, a.n_entries);
    asm volatile("red.relaxed.gpu.global.add.s32 [%0], %1;"
                 :: "l"(a.counts + i), "r"(a.inc));
    a.ring[int64_t(t - a.t0) * a.L + l] = static_cast<int32_t>(ctx);
    a.out[int64_t(t) * a.L + l] = static_cast<uint8_t>(sym);
}

__device__ __forceinline__ void pad_slot(const Args& a, int32_t t,
                                         int32_t l) {
    a.ring[int64_t(t - a.t0) * a.L + l] = -1;
    a.out[int64_t(t) * a.L + l] = 0;
}

__device__ __forceinline__ uint32_t renorm(const Args& a, uint32_t xn,
                                           int64_t w) {
    return (xn << 16) | fqk::word_at(a.words, a.W, w);
}

// Lane l's walk at the chunk's start: fresh at wave 0, else as the last
// chunk left it.
template <int KIND>
__device__ __forceinline__ Lane lane_at(const Args& a, const ModelSpec& m,
                                        int32_t l) {
    if (a.t0 > 0) return a.lanes[l];
    Lane ln;
    fqk::model_reset<KIND>(m, ln.s);
    ln.cur = ReadCursor{-1, 0, 0};
    ln.x = a.states0[l];
    ln.n = fqk::lane_length(a.cgrid, a.J, a.L, l);
    return ln;
}

// Step lane ln onto wave t's symbol: its context.
template <int KIND>
__device__ __forceinline__ int64_t step_in(const Args& a, const ModelSpec& m,
                                           int32_t l, Lane& ln) {
    if (fqk::cursor_next(ln.cur, a.cgrid, a.J, a.L, l))
        fqk::model_reset<KIND>(m, ln.s);
    return fqk::model_ctx<KIND>(m, ln.s, ln.cur.pos);
}

template <int KIND>
__device__ __forceinline__ void step_out(const ModelSpec& m, Lane& ln,
                                         int32_t sym) {
    fqk::model_update<KIND>(m, ln.s, sym);
    --ln.cur.rem;
    ++ln.cur.pos;
}

// --- one lane a thread: the walk in registers -----------------------------

template <int KIND, int NSEG>
__global__ void __launch_bounds__(kOneThreads)
chunk_one(Args a, ModelSpec m) {
    cg::cluster_group cl = cg::this_cluster();
    __shared__ RankSmem sm;
    const int32_t L = a.L;
    const int32_t l = static_cast<int32_t>(cl.block_rank()) * blockDim.x
                      + threadIdx.x;
    const bool has = l < L;
    Lane ln;
    ln.n = 0;
    if (has) ln = lane_at<KIND>(a, m, l);
    const int32_t tend = min(a.t1, ln.n);     // this lane's waves here
    Row<NSEG> row;
    int64_t ctx = 0;
    if (a.t0 < tend) {
        ctx = step_in<KIND>(a, m, l, ln);
        row_fetch(row, a, ctx);
    }
    int64_t off = a.t0 ? *a.off : 0;
    if (cl.block_rank() == 0 && threadIdx.x == 0) *a.n_zero = 0;
    fqk::rank_init(cl, sm);
    for (int32_t t = a.t0; t < a.t1; ++t) {
        uint32_t xn = 0;
        int32_t need = 0;
        if (t < tend) {
            const uint32_t low = ln.x & fqk::kMaskM;
            int32_t sym;
            uint32_t start, f;
            row_search(row, a.A, low, sym, start, f);
            xn = f * (ln.x >> fqk::kProbBits) + low - start;
            need = xn < fqk::kRansL;
            count_add(a, t, l, ctx, sym);
            step_out<KIND>(m, ln, sym);
            if (t + 1 < tend) {     // the next wave's row, fetched now
                ctx = step_in<KIND>(a, m, l, ln);
                row_fetch(row, a, ctx);
            }
        } else if (has) {
            pad_slot(a, t, l);
        }
        int32_t grand;
        const int32_t rank = fqk::cluster_rank(cl, sm, t, need, &grand);
        if (t < tend) ln.x = need ? renorm(a, xn, off + rank) : xn;
        off += grand;
        fqk::prefetch_words(cl, a.words, a.W, L, off);
    }
    if (has) a.lanes[l] = ln;
    if (cl.block_rank() == 0 && threadIdx.x == 0) *a.off = off;
}

// --- several lanes a thread: the walk in scratch --------------------------

template <int KIND, int NSEG>
__global__ void __launch_bounds__(kMultiThreads)
chunk_multi(Args a, ModelSpec m) {
    cg::cluster_group cl = cg::this_cluster();
    __shared__ RankSmem sm;
    const int32_t L = a.L;
    const int32_t g = static_cast<int32_t>(cl.block_rank()) * blockDim.x
                      + threadIdx.x;
    const int32_t l0 = min(g * a.per, L);
    const int32_t l1 = min(l0 + a.per, L);
    if (a.t0 == 0)
        for (int32_t l = l0; l < l1; ++l) a.lanes[l] = lane_at<KIND>(a, m, l);
    int64_t off = a.t0 ? *a.off : 0;
    if (cl.block_rank() == 0 && threadIdx.x == 0) *a.n_zero = 0;
    fqk::rank_init(cl, sm);
    for (int32_t t = a.t0; t < a.t1; ++t) {
        int32_t need = 0;
        for (int32_t l = l0; l < l1; ++l) {
            Lane& ln = a.lanes[l];
            if (t >= ln.n) continue;
            ln.ctx = step_in<KIND>(a, m, l, ln);
            Row<NSEG> row;
            row_fetch(row, a, ln.ctx);
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
            if (t >= ln.n) {
                pad_slot(a, t, l);
                continue;
            }
            uint32_t xn = ln.xn;
            if (xn < fqk::kRansL) xn = renorm(a, xn, w++);
            ln.x = xn;
            count_add(a, t, l, ln.ctx, ln.sym);
            step_out<KIND>(m, ln, ln.sym);
        }
        off += grand;
        fqk::prefetch_words(cl, a.words, a.W, L, off);
    }
    if (cl.block_rank() == 0 && threadIdx.x == 0) *a.off = off;
}

// --- launch ---------------------------------------------------------------

// Segments loaded at once: seq rows (A = 4 words) fit in 2, quality rows
// of up to 44 words in 12.
template <int KIND>
constexpr int kSeg = KIND == 0 ? 2 : 12;

using KernelFn = void (*)(Args, ModelSpec);

const KernelFn kOne[4] = {&chunk_one<0, kSeg<0>>, &chunk_one<1, kSeg<1>>,
                          &chunk_one<2, kSeg<2>>, &chunk_one<3, kSeg<3>>};
const KernelFn kMulti[4] = {
    &chunk_multi<0, kSeg<0>>, &chunk_multi<1, kSeg<1>>,
    &chunk_multi<2, kSeg<2>>, &chunk_multi<3, kSeg<3>>};

KernelFn kernel_for(int32_t kind, bool one) {
    if (kind < 0 || kind > 3) return nullptr;
    return one ? kOne[kind] : kMulti[kind];
}

// --- the scratch and the chunk schedule -------------------------------------

// Scratch (scratch_bytes): the lanes' walks, the word offset, the
// boundaries' scratch (semi_table.cuh), the ring of the chunk's rows.
struct Scratch {
    Lane* lanes;
    int64_t* off;
    void* bounds;
    int32_t* ring;        // [chunk][L]
};

int64_t align16(int64_t n) { return (n + 15) & ~int64_t(15); }

int64_t scratch_bytes(int32_t L, int64_t n_ctx, int32_t chunk) {
    return align16(int64_t(L) * sizeof(Lane)) + 16
           + boundary_scratch_bytes(n_ctx) + align16(4 * int64_t(chunk) * L);
}

Scratch scratch_at(void* base, int32_t L, int64_t n_ctx) {
    char* p = static_cast<char*>(base);
    Scratch s;
    s.lanes = reinterpret_cast<Lane*>(p);
    p += align16(int64_t(L) * sizeof(Lane));
    s.off = reinterpret_cast<int64_t*>(p);
    p += 16;
    s.bounds = p;
    p += boundary_scratch_bytes(n_ctx);
    s.ring = reinterpret_cast<int32_t*>(p);
    return s;
}

// The boundary schedule of _decode_semi (semi_table.cuh), a boundary
// before each chunk's launch and one after the last.
int run(Args a, uint32_t* snap, const ModelSpec& m, int32_t T, int64_t n_ctx,
        int32_t cap, int32_t n_halve, int32_t chunk, const Scratch& s,
        cudaStream_t st) {
    const Shape sh = fqk::shape_for(a.L, true);
    const KernelFn k = kernel_for(m.kind, sh.one);
    if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    a.per = sh.per;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = fqk::cluster_config(sh, st, attr);
    const int64_t n_chunks = T / chunk;
    const Boundaries b = boundaries_at(s.bounds, a.counts, snap, n_ctx, a.A,
                                       cap, n_halve, n_chunks,
                                       int64_t(chunk) * a.L);
    int rc = boundaries_start(b, st);
    for (int64_t c = 0; c <= n_chunks && rc == 0; ++c) {
        rc = boundary(b, c, s.ring, st);
        if (rc || c == n_chunks) break;
        a.t0 = static_cast<int32_t>(c * chunk);
        a.t1 = a.t0 + chunk;
        a.n_zero = list_to_clear(b, c);
        rc = static_cast<int>(cudaLaunchKernelEx(&cfg, k, a, m));
        if (rc == 0) rc = static_cast<int>(cudaGetLastError());
    }
    return rc;
}

}  // namespace

// Bytes of the scratch fq_semi_decode takes for L lanes, an n_ctx-row
// table and chunks of `chunk` waves.
extern "C" int64_t fq_semi_decode_scratch_bytes(int32_t L, int64_t n_ctx,
                                                int32_t chunk) {
    return scratch_bytes(L, n_ctx, chunk);
}

// The cluster K12 launches for L lanes, as fq_frozen_decode_shape reports
// K4's: out[0] CTAs, out[1] threads a CTA, out[2] lanes a thread, out[3]
// how many such clusters the card can hold at once.
extern "C" int fq_semi_decode_shape(int32_t L, int32_t kind, int32_t* out) {
    const Shape sh = fqk::shape_for(L, true);
    const KernelFn k = kernel_for(kind, sh.one);
    if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return fqk::report_shape(sh, reinterpret_cast<const void*>(k), out);
}

// counts: (n_ctx, A) int32, the starting table, becomes the final one;
// snap: (n_ctx, A) u32; scratch: fq_semi_decode_scratch_bytes(L, n_ctx,
// chunk) bytes; out: (T, L) u8.
extern "C" int fq_semi_decode(
        const uint32_t* states0, const uint16_t* words, int64_t W,
        const int32_t* cgrid, int32_t J, int32_t T, int32_t L, int32_t A,
        int32_t kind, int64_t a, int64_t b, int64_t c, int64_t d, int64_t e,
        int64_t f, int64_t g, int64_t n_ctx, int32_t inc, int32_t cap,
        int32_t n_halve, int32_t chunk, int32_t* counts, uint32_t* snap,
        void* scratch, uint8_t* out, void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    if (chunk <= 0 || T % chunk != 0 || L <= 0 || W <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const Scratch s = scratch_at(scratch, L, n_ctx);
    const Args args{states0, words, W, cgrid, J, L, 0, 0, snap, counts,
                    n_ctx * A, A, inc, s.lanes, 1, s.off, s.ring, nullptr,
                    out};
    return run(args, snap, m, T, n_ctx, cap, n_halve, chunk, s,
               static_cast<cudaStream_t>(stream));
}
