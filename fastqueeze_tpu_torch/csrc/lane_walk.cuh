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
// 0 and 0) and the lane's final state.
//
// The state chain is serial in a lane; what bounds the kernel is the
// time a step takes from x to the next x, as every warp runs alone on
// its SM sub-partition.  So everything the step needs that does not
// depend on x is taken ahead of it:
//  - the warp's lanes run in lockstep from the top wave any of them
//    fills; waves above it are zeroed by a loop of their own, and a lane
//    shorter than the warp's longest steps on the identity word (start 0,
//    freq 2^14: no emit, x unchanged, so x stays 2^16 and its word is 0
//    until its first symbol), so the live loop has no branch;
//  - the slots are copied with cp.async (a warp's 32 lanes are one row
//    of a wave, no branch a wave) into this thread's column of a
//    shared-memory ring of kRevStages stages of kRevWaves waves, two
//    stages ahead; a thread reads back only what it wrote, so no barrier
//    runs;
//  - while the chain runs a stage, the next stage's slots are loaded into
//    registers with their reciprocals (K7 reads them from a table of
//    recip32 its launch fills, K2 from its slots), in the same basic
//    block, so no division is left in the loop;
//  - the step (rev_step) tests the emit against f << 18, and folds the
//    update x' = q M + r + start, r = x - q d, into x + start + q (M - d)
//    with one correction where the reciprocal's quotient is one short:
//    from x, a compare, a guarded shift, a high multiply, a multiply-add,
//    a shift and a multiply-add;
//  - a stage's words and flags are kept in registers and stored while
//    the chain runs the next stage, through pointers stepped by L: a
//    store reads its register after it issues, and the chain used to
//    wait for that read before it overwrote x (on an H100 a step took
//    44-45 ns storing as it went, 37-38 ns so; 31-33 ns with the
//    correction above in place of a compare and a guarded add).
constexpr int kRevThreads = 64;
constexpr int kRevWaves = 24;
constexpr int kRevStages = 3;
// the identity slot: start 0, end 2^14; recip32(2^14) = 2^18
constexpr uint32_t kIdentWord = (1u << kProbBits) << 16;
constexpr uint32_t kIdentRecip = 1u << (32 - kProbBits);

template <typename E>
struct RevRing {
    E v[kRevStages][kRevWaves][kRevThreads];    // 18 KB, or 36 KB of uint2
};

// A copy of one slot into shared memory; `bytes` 0 fills it with zeros
// and reads nothing.
template <typename E>
__device__ __forceinline__ void cp_async(E* smem, const E* g,
                                         uint32_t bytes) {
    static_assert(sizeof(E) == 4 || sizeof(E) == 8, "4- or 8-byte slots");
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
                 :: "r"(s), "l"(g), "n"(sizeof(E)), "r"(bytes) : "memory");
}

// A slot as the step takes it: (sf word, reciprocal of its divisor); the
// identity slot past the lane's end.  K7's reciprocals come from
// `recip`, recip32(d) for d = 0 .. 2^14 (recip[0] = recip32(1)), a
// 64 KB table its launch fills first and the SMs' L1 holds; K2's are in
// its slots.
__device__ __forceinline__ uint2 rev_slot(uint32_t v, bool live,
                                          const uint32_t* __restrict__ recip) {
    const uint32_t w = live ? v : kIdentWord;
    const uint32_t f = (w >> 16) - (w & 0xFFFFu);
    return make_uint2(w, __ldg(recip + min(f, 1u << kProbBits)));
}
__device__ __forceinline__ uint2 rev_slot(uint2 v, bool live,
                                          const uint32_t*) {
    return live ? v : make_uint2(kIdentWord, kIdentRecip);
}

// Stage k of a chain from wave top - 1 down: waves top - 1 - k * kRevWaves
// down to top - (k + 1) * kRevWaves into ring slot k % kRevStages, with
// no branch a wave (waves below 0, in the last stage, are zero-filled
// and read nothing); one commit group a stage, empty or not.
template <typename E>
__device__ __forceinline__ void rev_stage(RevRing<E>& r,
                                          const E* __restrict__ sf,
                                          int32_t T, int32_t L, int32_t l,
                                          int32_t top, int32_t k,
                                          int32_t nst) {
    if (k < nst) {
        E (*slot)[kRevThreads] = r.v[k % kRevStages];
        const int32_t base = top - 1 - k * kRevWaves;
#pragma unroll
        for (int i = 0; i < kRevWaves; ++i) {
            const int32_t t = max(base - i, 0);
            FQK_BOUND("rans_encode_lane", "sf", int64_t(t) * L + l,
                      int64_t(T) * L);
            cp_async(&slot[i][threadIdx.x], sf + int64_t(t) * L + l,
                     base - i >= 0 ? sizeof(E) : 0u);
        }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Stage k's slots from the ring into registers with their reciprocals,
// the identity slot at waves t >= n.
template <typename E>
__device__ __forceinline__ void rev_load(const RevRing<E>& r, int32_t k,
                                         int32_t top, int32_t n,
                                         const uint32_t* __restrict__ recip,
                                         uint2 (&s)[kRevWaves]) {
    const E (*slot)[kRevThreads] = r.v[k % kRevStages];
    const int32_t base = top - 1 - k * kRevWaves;
#pragma unroll
    for (int i = 0; i < kRevWaves; ++i)
        s[i] = rev_slot(slot[i][threadIdx.x], base - i < n, recip);
}

// One reverse step from state x on slot s = (start | end << 16, recip32
// of the divisor d = max(f, 1), f = end - start): emit the low word when
// x >> 18 >= f (f = 2^14 never emits), then x' = (x / d) M + x % d +
// start, exactly as _pass2 computes it.  q = umulhi(x, recip) is x / d or
// one less, and x' = x + start + q (M - d) + (M - d) where it is less.
// Written in PTX where the compiler would lengthen the chain: the emit
// test is one compare against f << 18 that takes the predicate f < 2^14
// computed off the chain, and the correction takes the remainder's sign
// by a shift into a multiply-add, as ptxas waits 13 cycles between a
// compare and an instruction its predicate guards.
__device__ __forceinline__ uint32_t rev_step(uint32_t x, uint2 s,
                                             uint32_t& e) {
    const uint32_t start = s.x & 0xFFFFu;
    const uint32_t f = (s.x >> 16) - start;
    const uint32_t d = max(f, 1u);
    const uint32_t md = (1u << kProbBits) - d;
    uint32_t x1;
    asm("{\n\t.reg .pred ok, p;\n\t.reg .u32 h;\n\t"
        "setp.lt.u32 ok, %3, 16384;\n\t"
        "setp.ge.and.u32 p, %2, %4, ok;\n\t"
        "shr.u32 h, %2, 16;\n\t"
        "selp.u32 %0, h, %2, p;\n\t"
        "selp.u32 %1, 1, 0, p;\n\t}"
        : "=r"(x1), "=r"(e) : "r"(x), "r"(f), "r"(f << 18));
    const uint32_t q = __umulhi(x1, s.y);
    // r - d = x1 - (q + 1) d lies in [-d, d): its sign says q is exact,
    // and x' = x1 + start + (q + 1) (M - d) + sign (M - d)
    uint32_t xn;
    asm("{\n\t.reg .s32 sg;\n\t"
        "shr.s32 sg, %1, 31;\n\t"
        "mad.lo.u32 %0, sg, %2, %3;\n\t}"
        : "=r"(xn) : "r"(x1 - d - q * d), "r"(md),
          "r"(x1 + start + md + q * md));
    return xn;
}

// `lanes`: the ballot of this warp's threads that hold a lane (all call);
// `recip`: K7's table of reciprocals (K2: unused).
template <typename E>
__device__ __forceinline__ void rans_encode_lane(
        RevRing<E>& ring, const E* __restrict__ sf,
        const uint32_t* __restrict__ recip, int32_t T, int32_t L,
        int32_t l, int32_t n, unsigned lanes, uint16_t* __restrict__ words,
        uint8_t* __restrict__ emit, uint32_t* __restrict__ states) {
    FQK_BOUND("rans_encode_lane", "lane length", n, int64_t(T) + 1);
    n = min(n, T);
    const int32_t top = __reduce_max_sync(lanes, n);
    uint16_t* wp = words + (int64_t(T) - 1) * L + l;
    uint8_t* ep = emit + (int64_t(T) - 1) * L + l;
    for (int32_t t = T - 1; t >= top; --t, wp -= L, ep -= L) {
        *wp = 0;
        *ep = 0;
    }
    const int32_t full = top / kRevWaves, rem = top % kRevWaves;
    const int32_t nst = full + (rem > 0);
    rev_stage(ring, sf, T, L, l, top, 0, nst);
    rev_stage(ring, sf, T, L, l, top, 1, nst);
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    uint2 cur[kRevWaves], nxt[kRevWaves];
    rev_load(ring, 0, top, n, recip, cur);
    uint32_t x = kRansL;
    // a stage's words and flags are stored while the chain runs the next
    // stage (the first loop stores zeros where stage 0's go), so no store
    // reads a register that the chain overwrites a few instructions later
    uint32_t wb[kRevWaves], eb[kRevWaves];
#pragma unroll
    for (int i = 0; i < kRevWaves; ++i) wb[i] = eb[i] = 0;
    uint16_t* wq = wp;
    uint8_t* eq = ep;
    for (int32_t k = 0; k < full; ++k) {
        rev_stage(ring, sf, T, L, l, top, k + 2, nst);
        asm volatile("cp.async.wait_group 1;" ::: "memory");
        rev_load(ring, k + 1, top, n, recip, nxt);
#pragma unroll
        for (int i = 0; i < kRevWaves; ++i) {
            wq[-int64_t(i) * L] = static_cast<uint16_t>(wb[i]);
            eq[-int64_t(i) * L] = static_cast<uint8_t>(eb[i]);
        }
        wq = wp;
        eq = ep;
#pragma unroll
        for (int i = 0; i < kRevWaves; ++i) {
            wb[i] = x;
            x = rev_step(x, cur[i], eb[i]);
        }
        wp -= kRevWaves * L;
        ep -= kRevWaves * L;
#pragma unroll
        for (int i = 0; i < kRevWaves; ++i) cur[i] = nxt[i];
    }
    if (full > 0) {
#pragma unroll
        for (int i = 0; i < kRevWaves; ++i) {
            wq[-int64_t(i) * L] = static_cast<uint16_t>(wb[i]);
            eq[-int64_t(i) * L] = static_cast<uint8_t>(eb[i]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRevWaves; ++i) {
        if (i < rem) {
            *wp = static_cast<uint16_t>(x);
            uint32_t e;
            x = rev_step(x, cur[i], e);
            *ep = e;
            wp -= L;
            ep -= L;
        }
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
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
