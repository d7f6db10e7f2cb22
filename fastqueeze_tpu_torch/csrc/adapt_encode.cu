// K5 adapt_encode_walk: the adaptive coder's forward model walk over one
// stream, as a walk over the table's rows in parallel.
//
// Replaces fastqueeze_tpu/ops/engine.py _device_aux (B1), the models'
// context_grids (B2, B2'), _quant per row (B3) and _pass1 with
// _wave_update_tot (B7).  The output is sf[t, l] = start | end << 16 of
// each symbol from its context's row as the waves before t left it (the
// layout K2 stores; K7 consumes it), 0 at padding slots.
//
// The encoder needs no wave-by-wave walk across lanes: every context
// depends only on earlier symbols of its read, never on the table, and a
// wave changes only the rows of its contexts, each row from its own
// events alone (inc at each event's symbol, then halving while over cap,
// at most n_halve times).  So each row evolves independently: the sf of
// an event on row r at wave t depends only on r's starting counts and
// r's events in waves before t, and the events of one wave on r all read
// the same pre-update row (their adds commute).  The first design ran
// the T waves in order in one CTA (per wave a dependent row read per lane
// and three barriers, ~19 us a wave on one SM).  This one runs:
//   1. contexts (chunk_ctx): K13's chunk walk (chunk_walk.cuh) recovers
//      the lane walk's state at every chunk of 64 waves and writes each
//      slot's record ctx << 32 | t << lb | l (lb the bits of L - 1, so the
//      wave is a shift away); padding slots get the key 0xFFFFFFFF and sf
//      0;
//   2. grouping: an LSD radix sort of the records by ctx, 8 bits a pass
//      over ceil(bits(n_ctx) / 8) passes (three for the 2^16- to 2^20-row
//      seq and quality tables).  Each pass counts digits per tile of 4,096
//      records (sort_hist), scans the counts digit-major (sort_scan) and
//      scatters each tile stably (sort_scatter: per warp, records of one
//      digit ranked in slot order from eight ballots).  Stability
//      keeps every row's events in slot order, so in non-decreasing wave
//      order;
//   3. segments (seg_heads): the first record of every row's run goes to
//      the light list (at most 32 events and A <= 64) or the heavy list;
//   4. the walk, from each row's starting counts (init, or the caller's
//      counts0 row), by wave groups: each event's sf from the pre-update
//      row, then inc at each event's symbol, then the halving.  A light
//      row takes a thread (walk_light, its counts in local memory); a
//      heavy row a warp (walk_heavy: its counts and prefix in shared
//      memory, each lane owning ceil(A / 32) consecutive counts; for A <=
//      64 the prefix is quantized once a group, so an event's (start,
//      end) is two loads; 32 events at a time, one add a distinct symbol;
//      records and symbols loaded 256 events ahead), warps taking heavy
//      rows from a shared counter as they finish.
// What bounds it on an H100: the heaviest row's chain of wave groups
// (at most T, each a warp's requantization of the row, plus a step of
// the warp a window of 32 events; the duplicate-heavy stream puts most
// events on one row), then the sort's passes over the records
// (8 bytes a slot, read twice and written once a pass).

#include <cstdint>

#include <cuda_runtime.h>

#include "chunk_walk.cuh"
#include "lane_walk.cuh"

namespace {

constexpr uint32_t kPadKey = 0xFFFFFFFFu;
constexpr int kSortThreads = 256;
constexpr int kSortItems = 16;                     // records a thread
constexpr int kSortTile = kSortThreads * kSortItems;
constexpr int kDigits = 256;                       // 8 bits a pass
constexpr int kScanThreads = 1024;
constexpr int kLightA = 64;          // a light row's counts fit this
constexpr int kLightEvents = 32;     // a light row has at most this many
constexpr int kWalkWarps = 8;
constexpr int kWalkThreads = 32 * kWalkWarps;
constexpr uint32_t kFull = 0xFFFFFFFFu;
static_assert(kSortThreads == kDigits, "sort_scatter scans one digit a "
              "thread");

__device__ __forceinline__ uint32_t key_of(uint64_t r) {
    return static_cast<uint32_t>(r >> 32);
}

__device__ __forceinline__ uint32_t digit_of(uint64_t r, int shift) {
    return (key_of(r) >> shift) & (kDigits - 1);
}

__device__ __forceinline__ uint32_t sf_of(const int32_t cum,
                                          const int32_t next, int32_t C) {
    return fqk::quant_cum(cum, C) | (fqk::quant_cum(next, C) << 16);
}

// The active lanes whose 8-bit value v equals this lane's: eight ballots,
// a cost that does not grow with the number of distinct values (as
// __match_any_sync's does).
__device__ __forceinline__ uint32_t peers8(uint32_t v, bool active) {
    uint32_t m = __ballot_sync(kFull, active);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
        const uint32_t bit = __ballot_sync(kFull, (v >> b) & 1u);
        m &= ((v >> b) & 1u) ? bit : ~bit;
    }
    return m;
}

// A record's low word names its slot as t << lb | l (lb = the bits of L
// - 1): the wave is one shift away.
__device__ __forceinline__ uint32_t wave_of(uint64_t r, int lb) {
    return static_cast<uint32_t>(r) >> lb;
}

__device__ __forceinline__ int64_t slot_of(uint64_t r, int lb, int32_t L) {
    const uint32_t lo = static_cast<uint32_t>(r);
    return int64_t(lo >> lb) * L + (lo & ((1u << lb) - 1u));
}

// --- 1. contexts ----------------------------------------------------------

template <int KIND>
__global__ void __launch_bounds__(kLaneThreads)
chunk_ctx(const uint8_t* __restrict__ syms,
          const int32_t* __restrict__ cgrid, int32_t J, int32_t L,
          int32_t T, int32_t C, const int32_t* __restrict__ ctxg,
          ModelSpec m, Scratch s, int lb, uint64_t* __restrict__ rec,
          uint32_t* __restrict__ sf) {
    const int32_t l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    walk_chunk<KIND>(
        syms, cgrid, J, L, T, C, ctxg, m, s, blockIdx.y, l,
        [&](int64_t t, int64_t idx, int64_t ctx, int32_t) {
            rec[idx] = (static_cast<uint64_t>(ctx) << 32)
                       | (static_cast<uint32_t>(t) << lb) | l;
        },
        [&](int64_t t, int64_t idx) {
            rec[idx] = (static_cast<uint64_t>(kPadKey) << 32)
                       | (static_cast<uint32_t>(t) << lb) | l;
            sf[idx] = 0;
        });
}

// --- 2. the stable radix sort by ctx --------------------------------------

// Digit counts of one tile of kSortTile records: gh[digit * ntiles + tile].
__global__ void __launch_bounds__(kSortThreads)
sort_hist(const uint64_t* __restrict__ rec, int64_t n, int shift,
          int32_t* __restrict__ gh, int64_t ntiles) {
    __shared__ int32_t h[kDigits];
    h[threadIdx.x] = 0;
    __syncthreads();
    const int64_t base = int64_t(blockIdx.x) * kSortTile;
#pragma unroll 4
    for (int r = 0; r < kSortItems; ++r) {
        const int64_t i = base + r * kSortThreads + threadIdx.x;
        if (i < n) atomicAdd(&h[digit_of(rec[i], shift)], 1);
    }
    __syncthreads();
    gh[int64_t(threadIdx.x) * ntiles + blockIdx.x] = h[threadIdx.x];
}

// One block a digit: its tiles' counts -> exclusive offsets in place,
// dtot[digit] = the digit's total.
__global__ void __launch_bounds__(kScanThreads)
sort_scan(int32_t* __restrict__ gh, int64_t ntiles,
          int32_t* __restrict__ dtot) {
    int32_t* row = gh + int64_t(blockIdx.x) * ntiles;
    int32_t carry = 0;
    for (int64_t i0 = 0; i0 < ntiles; i0 += kScanThreads) {
        const int64_t i = i0 + threadIdx.x;
        const int32_t v = i < ntiles ? row[i] : 0;
        int32_t total;
        const int32_t ex = fqk::block_exclusive_scan<kScanThreads>(v, &total);
        if (i < ntiles) row[i] = carry + ex;
        carry += total;
    }
    if (threadIdx.x == 0) dtot[blockIdx.x] = carry;
}

// One tile: each record's place is its digit's start (the digits below
// it, over all tiles), plus the tile's offset in the digit, plus the
// records of that digit before it in the tile.  Warp w holds records
// w * 512 + r * 32 + lane (r = 0..15), so (warp, r, lane) is slot order
// and the rank is stable.
__global__ void __launch_bounds__(kSortThreads)
sort_scatter(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
             int64_t n, int shift, const int32_t* __restrict__ gh,
             int64_t ntiles, const int32_t* __restrict__ dtot) {
    constexpr int kWarps = kSortThreads / 32;
    __shared__ int32_t base[kDigits];
    __shared__ int32_t whist[kWarps][kDigits];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    int32_t total;
    const int32_t below = fqk::block_exclusive_scan<kSortThreads>(dtot[tid],
                                                                  &total);
    base[tid] = below + gh[int64_t(tid) * ntiles + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) whist[w][tid] = 0;
    __syncthreads();
    const int64_t w0 = int64_t(blockIdx.x) * kSortTile
                       + warp * (kSortItems * 32);
    const uint32_t lt = (1u << lane) - 1u;
    uint64_t v[kSortItems];
    int32_t rk[kSortItems];
#pragma unroll
    for (int r = 0; r < kSortItems; ++r) {
        const int64_t i = w0 + r * 32 + lane;
        const bool has = i < n;
        v[r] = has ? in[i] : 0;
        const uint32_t d = has ? digit_of(v[r], shift) : 0u;
        const uint32_t peers = peers8(d, has);
        const int32_t b = has ? whist[warp][d] : 0;
        __syncwarp();
        if (has && (peers & lt) == 0) whist[warp][d] = b + __popc(peers);
        __syncwarp();
        rk[r] = b + __popc(peers & lt);
    }
    __syncthreads();
    int32_t acc = 0;
    for (int w = 0; w < kWarps; ++w) {
        const int32_t c = whist[w][tid];
        whist[w][tid] = acc;
        acc += c;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kSortItems; ++r) {
        const int64_t i = w0 + r * 32 + lane;
        if (i < n) {
            const uint32_t d = digit_of(v[r], shift);
            out[base[d] + whist[warp][d] + rk[r]] = v[r];
        }
    }
}

// --- 3. the rows' runs ----------------------------------------------------

// The first record of each row's run goes to the light list (at most
// kLightEvents events, A <= kLightA) or the heavy list; one atomicAdd a
// block on each list's length (counters[0], counters[1]).
__global__ void __launch_bounds__(kSortThreads)
seg_heads(const uint64_t* __restrict__ rec, int64_t n, int32_t A,
          int32_t* __restrict__ light, int32_t* __restrict__ heavy,
          int32_t* __restrict__ counters) {
    __shared__ int32_t at[2];
    const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    bool head = false, big = false;
    if (i < n) {
        const uint32_t k = key_of(rec[i]);
        head = k != kPadKey && (i == 0 || key_of(rec[i - 1]) != k);
        if (head)
            big = A > kLightA || (i + kLightEvents < n
                                  && key_of(rec[i + kLightEvents]) == k);
    }
    // light count in the low 16 bits, heavy in the high 16
    const int32_t v = head ? (big ? 1 << 16 : 1) : 0;
    int32_t total;
    const int32_t ex = fqk::block_exclusive_scan<kSortThreads>(v, &total);
    if (threadIdx.x == 0) {
        at[0] = (total & 0xFFFF) ? atomicAdd(counters, total & 0xFFFF) : 0;
        at[1] = (total >> 16) ? atomicAdd(counters + 1, total >> 16) : 0;
    }
    __syncthreads();
    if (head && big) heavy[at[1] + (ex >> 16)] = static_cast<int32_t>(i);
    if (head && !big) light[at[0] + (ex & 0xFFFF)] = static_cast<int32_t>(i);
}

// --- 4. the walk by wave groups -------------------------------------------

// A light row, one thread: its counts in local memory, each group's sf
// from the pre-update row, then the group's adds, then the halving.
__global__ void __launch_bounds__(kWalkThreads)
walk_light(const uint64_t* __restrict__ rec, int64_t n,
           const int32_t* __restrict__ list,
           const int32_t* __restrict__ counters,
           const uint8_t* __restrict__ syms, int32_t L, int lb, int32_t A,
           const int32_t* __restrict__ counts0, int32_t init, int32_t inc,
           int32_t cap, int32_t n_halve, uint32_t* __restrict__ sf) {
    const int32_t nl = counters[0];
    for (int64_t k = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; k < nl;
         k += int64_t(gridDim.x) * blockDim.x) {
        int64_t i = list[k];
        const uint32_t key = key_of(rec[i]);
        int32_t c[kLightA];
        int32_t C = 0;
        const int32_t* src = counts0 ? counts0 + int64_t(key) * A : nullptr;
        for (int32_t a = 0; a < A; ++a) {
            c[a] = src ? src[a] : init;
            C += c[a];
        }
        while (i < n && key_of(rec[i]) == key) {
            const uint32_t t = wave_of(rec[i], lb);
            int64_t j = i;
            for (; j < n; ++j) {
                const uint64_t q = rec[j];
                if (key_of(q) != key || wave_of(q, lb) != t) break;
                const int64_t idx = slot_of(q, lb, L);
                const int32_t sym = syms[idx];
                int32_t cum = 0;
                for (int32_t a = 0; a < sym; ++a) cum += c[a];
                sf[idx] = sf_of(cum, cum + c[sym], C);
            }
            for (int64_t q = i; q < j; ++q) {
                c[syms[slot_of(rec[q], lb, L)]] += inc;
                C += inc;
            }
            for (int32_t h = 0; h < n_halve && C > cap; ++h) {
                C = 0;
                for (int32_t a = 0; a < A; ++a) {
                    c[a] = (c[a] + 1) >> 1;
                    C += c[a];
                }
            }
            i = j;
        }
    }
}

// A heavy row's counts a lane owns, j * E .. j * E + E - 1 (16-byte
// aligned for E >= 4), loaded or stored at once.
template <int E>
__device__ __forceinline__ void own_load(const int32_t* p, int32_t (&v)[E]) {
    if constexpr (E == 1) {
        v[0] = p[0];
    } else if constexpr (E == 2) {
        const int2 x = *reinterpret_cast<const int2*>(p);
        v[0] = x.x;
        v[1] = x.y;
    } else {
#pragma unroll
        for (int q = 0; q < E / 4; ++q) {
            const int4 x = reinterpret_cast<const int4*>(p)[q];
            v[4 * q] = x.x;
            v[4 * q + 1] = x.y;
            v[4 * q + 2] = x.z;
            v[4 * q + 3] = x.w;
        }
    }
}

template <int E>
__device__ __forceinline__ void own_store(int32_t* p,
                                          const int32_t (&v)[E]) {
    if constexpr (E == 1) {
        p[0] = v[0];
    } else if constexpr (E == 2) {
        *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
    } else {
#pragma unroll
        for (int q = 0; q < E / 4; ++q)
            reinterpret_cast<int4*>(p)[q] = make_int4(
                v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
}

// A lane owning at most 2 counts quantizes them once a group, so an
// event's (start, end) is two loads; with more (byte models, 8 counts a
// lane) and few events a group, each event divides instead.
template <int E>
constexpr bool kQuantRow = E <= 2;

// After a group's adds (or at the row's start): the row's counts halved
// while over cap (at most n_halve times; the halvings in registers), and
// its prefix for s = 0..32 E (counts past A are 0): fq[s] = F_s =
// floor(cum_s * 2^14 / C) (kQuantRow) or cum_s.  Returns C.
template <int E>
__device__ __forceinline__ int32_t row_finish(int32_t* cnt, uint32_t* fq,
                                              int lane, int32_t cap,
                                              int32_t n_halve) {
    __syncwarp();
    int32_t v[E];
    own_load<E>(cnt + lane * E, v);
    int32_t s = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) s += v[e];
    int32_t C = __reduce_add_sync(kFull, s);
    if (C > cap) {
        for (int32_t h = 0; h < n_halve && C > cap; ++h) {
            s = 0;
#pragma unroll
            for (int e = 0; e < E; ++e) {
                v[e] = (v[e] + 1) >> 1;
                s += v[e];
            }
            C = __reduce_add_sync(kFull, s);
        }
        own_store<E>(cnt + lane * E, v);
    }
    int32_t run = fqk::warp_inclusive(s, lane) - s;
    int32_t f[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        f[e] = kQuantRow<E> ? static_cast<int32_t>(fqk::quant_cum(run, C))
                            : run;
        run += v[e];
    }
    own_store<E>(reinterpret_cast<int32_t*>(fq) + lane * E, f);
    if (lane == 31)
        fq[32 * E] = kQuantRow<E> ? 1u << fqk::kProbBits
                                  : static_cast<uint32_t>(C);
    __syncwarp();
    return C;
}

// Records of one batch of kBatch windows of 32 (lane + 32 j), and their
// symbols (0 where the record is past the row's run).
constexpr int kBatch = 8;

__device__ __forceinline__ void load_recs(const uint64_t* __restrict__ rec,
                                          int64_t n, int64_t b0, int lane,
                                          uint64_t (&r)[kBatch]) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
        const int64_t i = b0 + 32 * j + lane;
        r[j] = i < n ? rec[i] : ~0ull;
    }
}

__device__ __forceinline__ void load_syms(const uint8_t* __restrict__ syms,
                                          const uint64_t (&r)[kBatch],
                                          uint32_t key, int lb, int32_t L,
                                          int32_t (&s)[kBatch]) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
        s[j] = key_of(r[j]) == key ? syms[slot_of(r[j], lb, L)] : 0;
}

// A heavy row, one warp, one event a lane, 32 events a window: the lanes
// of the current group write sf from the prefix and add to the counts
// (shared-memory atomics), and where a later wave starts in the window
// the group is finished (rescan, halving) and the next one runs.  The
// records come kBatch windows at a time, the next batch's symbols and the
// batch after it's records in flight while a batch is walked, so the
// walk waits on memory once a batch, not twice a window.
template <int E>
__global__ void __launch_bounds__(kWalkThreads)
walk_heavy(const uint64_t* __restrict__ rec, int64_t n,
           const int32_t* __restrict__ list, int32_t* __restrict__ counters,
           const uint8_t* __restrict__ syms, int32_t L, int lb, int32_t A,
           const int32_t* __restrict__ counts0, int32_t init, int32_t inc,
           int32_t cap, int32_t n_halve, uint32_t* __restrict__ sf) {
    __shared__ __align__(16) int32_t cnt_s[kWalkWarps][32 * E];
    __shared__ __align__(16) uint32_t fq_s[kWalkWarps][32 * E + 4];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const uint32_t lt = (1u << lane) - 1u;
    int32_t* cnt = cnt_s[warp];
    uint32_t* fq = fq_s[warp];
    const int32_t nh = counters[1];
    constexpr int64_t kSpan = 32 * kBatch;
    for (;;) {
        int32_t h = 0;
        if (lane == 0) h = atomicAdd(counters + 2, 1);
        h = __shfl_sync(kFull, h, 0);
        if (h >= nh) break;
        const int64_t i0 = list[h];
        uint64_t rc[kBatch], rn[kBatch];
        int32_t sc[kBatch];
        load_recs(rec, n, i0, lane, rc);
        load_recs(rec, n, i0 + kSpan, lane, rn);
        const uint32_t key = key_of(__shfl_sync(kFull, rc[0], 0));
        load_syms(syms, rc, key, lb, L, sc);
        const int32_t* src = counts0 ? counts0 + int64_t(key) * A : nullptr;
        for (int32_t a = lane; a < 32 * E; a += 32)
            cnt[a] = a >= A ? 0 : src ? src[a] : init;
        int32_t C = row_finish<E>(cnt, fq, lane, cap, n_halve);
        uint32_t tc = wave_of(__shfl_sync(kFull, rc[0], 0), lb);
        for (int64_t b0 = i0;; b0 += kSpan) {
            int32_t sn[kBatch];
            uint64_t r2[kBatch];
            load_syms(syms, rn, key, lb, L, sn);
            load_recs(rec, n, b0 + 2 * kSpan, lane, r2);
            bool ended = false;
#pragma unroll
            for (int j = 0; j < kBatch; ++j) {
                const bool has = key_of(rc[j]) == key;
                const uint32_t t = has ? wave_of(rc[j], lb) : 0xFFFFFFFFu;
                const int32_t sym = sc[j];
                bool pending = has;
                for (;;) {
                    const bool in = pending && t == tc;
                    // one add a symbol of the window: its lowest lane adds
                    // inc for every lane on it
                    const uint32_t peers = __match_any_sync(
                        kFull, in ? static_cast<uint32_t>(sym) : 0x100u);
                    if (in) {
                        sf[slot_of(rc[j], lb, L)] =
                            kQuantRow<E>
                                ? fq[sym] | (fq[sym + 1] << 16)
                                : sf_of(static_cast<int32_t>(fq[sym]),
                                        static_cast<int32_t>(fq[sym + 1]),
                                        C);
                        if ((peers & lt) == 0)
                            cnt[sym] += inc * __popc(peers);
                    }
                    pending = pending && !in;
                    const uint32_t pm = __ballot_sync(kFull, pending);
                    if (!pm) break;
                    // a later wave starts here: wave tc's group is
                    // complete
                    C = row_finish<E>(cnt, fq, lane, cap, n_halve);
                    tc = __shfl_sync(kFull, t, __ffs(pm) - 1);
                }
                if (__ballot_sync(kFull, has) != kFull) {
                    ended = true;
                    break;
                }
            }
            if (ended) break;
#pragma unroll
            for (int j = 0; j < kBatch; ++j) {
                rc[j] = rn[j];
                sc[j] = sn[j];
                rn[j] = r2[j];
            }
        }
        __syncwarp();
    }
}

// --- launch ---------------------------------------------------------------

struct Layout {
    Scratch chunk;
    uint64_t* rec[2];
    int32_t* gh;
    int32_t* dtot;
    int32_t* light;
    int32_t* heavy;
    int32_t* counters;       // light count, heavy count, heavy rows taken
    int64_t bytes;
};

inline int64_t align16(int64_t b) { return (b + 15) & ~int64_t(15); }

Layout layout_at(void* base, int32_t T, int32_t L, int64_t n_ctx) {
    char* p = static_cast<char*>(base);
    const int64_t n = int64_t(T) * L;
    const int64_t ntiles = (n + kSortTile - 1) / kSortTile;
    const int64_t runs = n < n_ctx ? n : n_ctx;
    Layout y;
    int64_t at = 0;
    y.chunk = scratch_at(p, T, L, chunk_for(T));
    at += align16(chunk_scratch_bytes(T, L));
    y.rec[0] = reinterpret_cast<uint64_t*>(p + at);
    at += align16(8 * n);
    y.rec[1] = reinterpret_cast<uint64_t*>(p + at);
    at += align16(8 * n);
    y.gh = reinterpret_cast<int32_t*>(p + at);
    at += align16(4 * kDigits * ntiles);
    y.dtot = reinterpret_cast<int32_t*>(p + at);
    at += align16(4 * kDigits);
    y.light = reinterpret_cast<int32_t*>(p + at);
    at += align16(4 * runs);
    y.heavy = reinterpret_cast<int32_t*>(p + at);
    at += align16(4 * runs);
    y.counters = reinterpret_cast<int32_t*>(p + at);
    at += 16;
    y.bytes = at;
    return y;
}

template <int KIND>
void launch_ctx(dim3 grid, const uint8_t* syms, const int32_t* cgrid,
                int32_t J, int32_t L, int32_t T, int32_t C,
                const int32_t* ctxg, const ModelSpec& m, const Scratch& s,
                int lb, uint64_t* rec, uint32_t* sf, cudaStream_t st) {
    chunk_ctx<KIND><<<grid, kLaneThreads, 0, st>>>(syms, cgrid, J, L, T, C,
                                                   ctxg, m, s, lb, rec, sf);
}

// Passes of 8 bits that cover every key below n_ctx, and put the padding
// key (all ones in those bits) after them.
int sort_passes(int64_t n_ctx) {
    int bits = 0;
    while (bits < 32 && (n_ctx >> bits) != 0) ++bits;
    return (bits + 7) / 8 > 0 ? (bits + 7) / 8 : 1;
}

}  // namespace

extern "C" int64_t fq_adapt_encode_scratch_bytes(int32_t T, int32_t L,
                                                 int64_t n_ctx) {
    return layout_at(nullptr, T, L, n_ctx).bytes;
}

// counts0: the caller's (n_ctx, A) int32 starting table, or null for init
// everywhere.  ctxg is read for kind 4 only.  scratch:
// fq_adapt_encode_scratch_bytes(T, L, n_ctx) bytes.  n_ctx < 2^32 and
// T * L < 2^31 (the wrapper checks).
extern "C" int fq_adapt_encode_walk(
        const uint8_t* syms, const int32_t* cgrid, int32_t J, int32_t T,
        int32_t L, const int32_t* ctxg, int32_t A, int32_t kind, int64_t a,
        int64_t b, int64_t c, int64_t d, int64_t e, int64_t f, int64_t g,
        int32_t inc, int32_t cap, int32_t n_halve, int32_t init,
        const int32_t* counts0, int64_t n_ctx, void* scratch, uint32_t* sf,
        void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (kind < 0 || kind > 4 || A > kDigits)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n = int64_t(T) * L;
    if (n <= 0) return 0;
    const Layout y = layout_at(scratch, T, L, n_ctx);
    const int32_t C = chunk_for(T);
    int lb = 0;                          // slot t * L + l as t << lb | l
    while ((1LL << lb) < L) ++lb;
    const int lane_blocks = (L + kLaneThreads - 1) / kLaneThreads;
    const dim3 grid(lane_blocks, static_cast<unsigned>(chunks_of(T, C)));
    cudaError_t rc = cudaMemsetAsync(y.counters, 0, 16, st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    chunk_prologue(syms, cgrid, J, L, T, C, m, y.chunk, grid, st);
    switch (kind) {
        case 0: launch_ctx<0>(grid, syms, cgrid, J, L, T, C, ctxg, m,
                              y.chunk, lb, y.rec[0], sf, st); break;
        case 1: launch_ctx<1>(grid, syms, cgrid, J, L, T, C, ctxg, m,
                              y.chunk, lb, y.rec[0], sf, st); break;
        case 2: launch_ctx<2>(grid, syms, cgrid, J, L, T, C, ctxg, m,
                              y.chunk, lb, y.rec[0], sf, st); break;
        case 3: launch_ctx<3>(grid, syms, cgrid, J, L, T, C, ctxg, m,
                              y.chunk, lb, y.rec[0], sf, st); break;
        default: launch_ctx<4>(grid, syms, cgrid, J, L, T, C, ctxg, m,
                               y.chunk, lb, y.rec[0], sf, st); break;
    }
    const int64_t ntiles = (n + kSortTile - 1) / kSortTile;
    const int passes = sort_passes(n_ctx);
    for (int p = 0; p < passes; ++p) {
        const uint64_t* in = y.rec[p & 1];
        uint64_t* out = y.rec[(p + 1) & 1];
        sort_hist<<<ntiles, kSortThreads, 0, st>>>(in, n, 8 * p, y.gh,
                                                    ntiles);
        sort_scan<<<kDigits, kScanThreads, 0, st>>>(y.gh, ntiles, y.dtot);
        sort_scatter<<<ntiles, kSortThreads, 0, st>>>(in, out, n, 8 * p,
                                                       y.gh, ntiles, y.dtot);
    }
    const uint64_t* sorted = y.rec[passes & 1];
    seg_heads<<<(n + kSortThreads - 1) / kSortThreads, kSortThreads, 0, st>>>(
        sorted, n, A, y.light, y.heavy, y.counters);
    int sms = 132;
    int dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    walk_light<<<8 * sms, kWalkThreads, 0, st>>>(
        sorted, n, y.light, y.counters, syms, L, lb, A, counts0, init, inc,
        cap, n_halve, sf);
    const int E = A <= 32 ? 1 : A <= 64 ? 2 : A <= 128 ? 4 : 8;
    const auto heavy = E == 1 ? &walk_heavy<1> : E == 2 ? &walk_heavy<2>
                       : E == 4 ? &walk_heavy<4> : &walk_heavy<8>;
    heavy<<<4 * sms, kWalkThreads, 0, st>>>(
        sorted, n, y.heavy, y.counters, syms, L, lb, A, counts0, init, inc,
        cap, n_halve, sf);
    return static_cast<int>(cudaGetLastError());
}
