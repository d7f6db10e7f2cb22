// Per-lane pieces shared by the wave-rANS kernels (K2, K4-K7).
//
// A lane codes reads l, l+L, l+2L, ... back to back (round-robin layout,
// ops/lanes.py).  The walk derives each wave's read start and exact
// in-read position from the (J, L) per-slot read-length grid, skipping
// zero-length slots (replaces fastqueeze_tpu/ops/engine.py _device_aux,
// whose scatter-max drops them), and runs the context model of
// fastqueeze_tpu/models/base.py lane by lane (the same formulas as
// native/wavemodels.h SeqM / QualM for kinds 0 and 1).
#pragma once

#include <cstdint>

#include "check.cuh"

namespace fqk {

constexpr uint32_t kRansL = 1u << 16;
constexpr uint32_t kProbBits = 14;
constexpr uint32_t kMaskM = (1u << kProbBits) - 1;

// Model integers, as models/base.py spec() lists them.
// kind 0 = seq: a = mask, b = magic.
// kind 1 = qual: a = k, b = base, c = hash_bits, d = drop_bits,
//                e = pos_bits, f = qlevel, g = drop_init.
// kind 2 = order-0 (CtxModel): one context.
// kind 3 = order-1 byte (Order1ByteModel): ctx = previous symbol, 0 at a
//          read start.
// kind 4 = flat (FlatModel): ctx read from a (T, L) int32 grid.
struct ModelSpec {
    int32_t kind;
    int64_t a, b, c, d, e, f, g;
};

struct ModelState {
    uint32_t h;       // seq: 2-bit history; order-1 byte: previous symbol
    int32_t q[8];     // qual: last ranks, q[0] most recent
    int32_t drops;    // qual: summed drops in this read
};

template <int KIND>
__device__ __forceinline__ void model_reset(const ModelSpec& m,
                                            ModelState& s) {
    if (KIND == 0) {
        s.h = static_cast<uint32_t>(m.b & m.a);
    } else if (KIND == 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j) s.q[j] = 0;
        s.drops = static_cast<int32_t>(m.g);
    } else if (KIND == 3) {
        s.h = 0;
    }
}

template <int KIND>
__device__ __forceinline__ int64_t model_ctx(const ModelSpec& m,
                                             const ModelState& s,
                                             int64_t pos) {
    if (KIND == 0 || KIND == 3) return static_cast<int64_t>(s.h);
    if (KIND != 1) return 0;
    const int32_t k = static_cast<int32_t>(m.a);
    if (k >= 2) {
        const int32_t base = static_cast<int32_t>(m.b);
        const int32_t qcap = base - 1;
        // the chain lives on the u32 ring (a deep chain wraps before
        // the hash, as the reference's int32 chain does)
        uint32_t c = static_cast<uint32_t>(min(s.q[0], qcap));
#pragma unroll
        for (int j = 1; j < 8; ++j)
            if (j < k)
                c = c * static_cast<uint32_t>(base)
                    + static_cast<uint32_t>(min(s.q[j], qcap));
        int64_t ctx = c;
        const int32_t hb = static_cast<int32_t>(m.c);
        if (hb) ctx = (c * 2654435761u) & ((1u << hb) - 1u);
        const int32_t db = static_cast<int32_t>(m.d);
        if (db) ctx = (ctx << db) | min(s.drops >> 3, (1 << db) - 1);
        const int32_t pb = static_cast<int32_t>(m.e);
        if (pb) {
            const int64_t pm = (1 << pb) - 1;
            const int64_t pp = pos >> 4;
            ctx = (ctx << pb) | (pp < pm ? pp : pm);
        }
        return ctx;
    }
    const int32_t q1 = s.q[0], q2 = s.q[1];
    int64_t c = ((max(q1, q2) << 6) + q1) & 0xFFF;
    if (m.f >= 2) {
        if (q1 == q2) c += 0x1000;
        c += static_cast<int64_t>(min(s.drops, 56) & ~7) << 10;
    }
    if (m.f >= 3) {
        const int64_t p3 = pos >> 3;
        c += (p3 < 15 ? p3 : 15) << 16;
    }
    return c;
}

// Context of a lane's current symbol; kind 4 reads it from the grid at
// idx = t * L + l.
template <int KIND>
__device__ __forceinline__ int64_t lane_ctx(const ModelSpec& m,
                                            const ModelState& s,
                                            int64_t pos,
                                            const int32_t* ctxg,
                                            int64_t idx) {
    if (KIND == 4) return ctxg[idx];
    return model_ctx<KIND>(m, s, pos);
}

template <int KIND>
__device__ __forceinline__ void model_update(const ModelSpec& m,
                                             ModelState& s, int32_t sym) {
    if (KIND == 0) {
        s.h = ((s.h << 2) | static_cast<uint32_t>(sym))
              & static_cast<uint32_t>(m.a);
    } else if (KIND == 1) {
        s.drops += max(s.q[0] - sym, 0);
#pragma unroll
        for (int j = 7; j > 0; --j) s.q[j] = s.q[j - 1];
        s.q[0] = sym;
    } else if (KIND == 3) {
        s.h = static_cast<uint32_t>(sym);
    }
}

// Read cursor of one lane over its column of the counts grid.
struct ReadCursor {
    int32_t j;        // current slot (read j*L + l); -1 before the first
    int32_t rem;      // symbols left in the current read
    int32_t pos;      // in-read position of the next symbol (exact int32)
};

__device__ __forceinline__ int32_t lane_length(const int32_t* cgrid,
                                               int32_t J, int32_t L,
                                               int32_t l) {
    int32_t n = 0;
    for (int32_t j = 0; j < J; ++j) {
        FQK_BOUND("lane_length", "cgrid", int64_t(j) * L + l,
                  int64_t(J) * L);
        n += cgrid[int64_t(j) * L + l];
    }
    return n;
}

// Step onto the next symbol of a lane with symbols left; returns true
// at a read start (the model state must then reset).
__device__ __forceinline__ bool cursor_next(ReadCursor& c,
                                            const int32_t* cgrid,
                                            int32_t J, int32_t L,
                                            int32_t l) {
    if (c.rem > 0) return false;
    do {
        ++c.j;
        if (c.j < J)
            FQK_BOUND("cursor_next", "cgrid", int64_t(c.j) * L + l,
                      int64_t(J) * L);
        c.rem = c.j < J ? cgrid[int64_t(c.j) * L + l] : 1;
    } while (c.rem == 0);
    c.pos = 0;
    return true;
}

// floor(2^32 / d) for d >= 2, 2^32 - 1 for d = 1 (1 <= d <= 2^16).
__device__ __forceinline__ uint32_t recip32(uint32_t d) {
    const uint32_t q = 0xFFFFFFFFu / d;
    return d == 1 ? q : q + (0xFFFFFFFFu - q * d == d - 1);
}

// x / d and x % d (r) with rcp = recip32(d): x * rcp / 2^32 lies in
// (x / d - 1, x / d], so its floor is the quotient or one less.
__device__ __forceinline__ uint32_t div_by(uint32_t x, uint32_t d,
                                           uint32_t rcp, uint32_t& r) {
    uint32_t q = __umulhi(x, rcp);
    r = x - q * d;
    if (r >= d) {
        ++q;
        r -= d;
    }
    return q;
}

// A packed sf word's nonzero freq (the divisor of the reverse step).
__device__ __forceinline__ uint32_t sf_divisor(uint32_t v) {
    const uint32_t f = (v >> 16) - (v & 0xFFFFu);
    return f ? f : 1u;
}

// Reverse rANS of one lane (fastqueeze_tpu/ops/engine.py _pass2) over its
// column of a (T, L) grid of E: uint32_t sf words (start | end << 16,
// K7), or uint2 (the sf word, recip32 of its divisor; K2's forward pass
// writes both).  One thread a lane in blocks of kRevThreads: writes
// words[t, l] and emit[t, l] for all T waves (padding waves t >= n write
// 0 and 0) and the lane's final state.  The state chain is serial, but
// nothing it reads depends on the state, so that runs ahead of it: each
// thread copies its column with cp.async (a warp's 32 lanes are one row
// of a wave) into its own column of a shared-memory ring of kRevStages
// stages of kRevWaves waves, kRevStages - 1 stages ahead of the one it
// consumes, from the top wave down, and loads each slot a wave before
// its step; a thread reads back only what it copied, so no barrier runs.
// The chain is then the emit test, the division (with E = uint2 a high
// multiply and one correction, div_by) and a multiply-add.
constexpr int kRevThreads = 64;
constexpr int kRevWaves = 24;
constexpr int kRevStages = 3;

template <typename E>
struct RevRing {
    E v[kRevStages][kRevWaves][kRevThreads];    // 18 KB, or 36 KB of uint2
};

template <typename E>
__device__ __forceinline__ void cp_async(E* smem, const E* g) {
    static_assert(sizeof(E) == 4 || sizeof(E) == 8, "4- or 8-byte slots");
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
                 :: "r"(s), "l"(g), "n"(sizeof(E)) : "memory");
}

// Stage k: this thread's waves T - 1 - k * kRevWaves down to
// T - (k + 1) * kRevWaves, those inside the lane, into ring slot
// k % kRevStages; one commit group a stage, empty or not.
template <typename E>
__device__ __forceinline__ void rev_stage(RevRing<E>& r,
                                          const E* __restrict__ sf,
                                          int32_t T, int32_t L, int32_t l,
                                          int32_t n, int64_t k, int64_t nst) {
    if (k < nst) {
        const int64_t top = int64_t(T) - 1 - k * kRevWaves;
        E (*slot)[kRevThreads] = r.v[k % kRevStages];
#pragma unroll
        for (int i = 0; i < kRevWaves; ++i) {
            const int64_t t = top - i;
            if (t >= 0 && t < n) {
                FQK_BOUND("rans_encode_lane", "sf", t * L + l,
                          int64_t(T) * L);
                cp_async(&slot[i][threadIdx.x], sf + t * L + l);
            }
        }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ uint32_t rev_word(uint32_t v) { return v; }
__device__ __forceinline__ uint32_t rev_word(uint2 v) { return v.x; }

__device__ __forceinline__ uint32_t rev_quot(uint32_t x, uint32_t d,
                                             uint32_t, uint32_t& r) {
    const uint32_t q = x / d;
    r = x - q * d;
    return q;
}

__device__ __forceinline__ uint32_t rev_quot(uint32_t x, uint32_t d,
                                             uint2 v, uint32_t& r) {
    return div_by(x, d, v.y, r);
}

template <typename E>
__device__ __forceinline__ void rans_encode_lane(
        RevRing<E>& ring, const E* __restrict__ sf, int32_t T, int32_t L,
        int32_t l, int32_t n, uint16_t* __restrict__ words,
        uint8_t* __restrict__ emit, uint32_t* __restrict__ states) {
    FQK_BOUND("rans_encode_lane", "lane length", n, int64_t(T) + 1);
    const int64_t nst = (int64_t(T) + kRevWaves - 1) / kRevWaves;
    for (int k = 0; k < kRevStages - 1; ++k)
        rev_stage(ring, sf, T, L, l, n, k, nst);
    uint32_t x = kRansL;
    for (int64_t k = 0; k < nst; ++k) {
        rev_stage(ring, sf, T, L, l, n, k + kRevStages - 1, nst);
        asm volatile("cp.async.wait_group %0;" :: "n"(kRevStages - 1)
                     : "memory");
        const E (*slot)[kRevThreads] = ring.v[k % kRevStages];
        const int64_t top = int64_t(T) - 1 - k * kRevWaves;
        const int waves = top + 1 < kRevWaves ? static_cast<int>(top + 1)
                                              : kRevWaves;
        E next = slot[0][threadIdx.x];
#pragma unroll 4
        for (int i = 0; i < waves; ++i) {
            const E v = next;
            if (i + 1 < waves) next = slot[i + 1][threadIdx.x];
            const int64_t t = top - i;
            const int64_t idx = t * L + l;
            if (t >= n) {
                words[idx] = 0;
                emit[idx] = 0;
                continue;
            }
            const uint32_t w = rev_word(v);
            const uint32_t start = w & 0xFFFFu;
            const bool e = (x >> 18) >= (w >> 16) - start;
            words[idx] = static_cast<uint16_t>(x & 0xFFFFu);
            emit[idx] = e;
            if (e) x >>= 16;
            uint32_t r;
            const uint32_t q = rev_quot(x, sf_divisor(w), v, r);
            x = (q << kProbBits) + r + start;
        }
    }
    states[l] = x;
}

// Inclusive scan of one int per lane across a full warp.
__device__ __forceinline__ int32_t warp_inclusive(int32_t v, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(0xFFFFFFFFu, v, d);
        if (lane >= d) v += y;
    }
    return v;
}

// Exclusive block-wide scan of one int per thread; *total gets the sum.
// Three barriers; THREADS is the block size (a multiple of 32, <= 1024).
template <int THREADS>
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v,
                                                        int32_t* total) {
    constexpr int kWarps = THREADS / 32;
    __shared__ int32_t warp_sums[kWarps];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int32_t inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(0xFFFFFFFFu, inc, d);
        if (lane >= d) inc += y;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int32_t w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int32_t y = __shfl_up_sync(0xFFFFFFFFu, w, d);
            if (lane >= d) w += y;
        }
        if (lane < kWarps) warp_sums[lane] = w;
    }
    __syncthreads();
    const int32_t before = warp > 0 ? warp_sums[warp - 1] : 0;
    *total = warp_sums[kWarps - 1];
    __syncthreads();
    return before + inc - v;
}

// --- adaptive count table (K5, K6) ------------------------------------

// F_s = floor(cum_s * 2^14 / C) (engine._quant), in 32 bits while cum_s
// << 14 fits (C < 2^18, which every row at or near a cap <= 2^14 meets).
__device__ __forceinline__ uint32_t quant_cum(int32_t cum, int32_t C) {
    if (C < (1 << 18))
        return (static_cast<uint32_t>(cum) << kProbBits)
               / static_cast<uint32_t>(C);
    return static_cast<uint32_t>((static_cast<uint64_t>(cum) << kProbBits)
                                 / static_cast<uint64_t>(C));
}

}  // namespace fqk
