// Per-lane walk shared by the frozen encode (K2) and decode (K4) kernels.
//
// A lane codes reads l, l+L, l+2L, ... back to back (round-robin layout,
// ops/lanes.py).  The walk derives each wave's read start and exact
// in-read position from the (J, L) per-slot read-length grid, skipping
// zero-length slots (replaces fastqueeze_tpu/ops/engine.py _device_aux,
// whose scatter-max drops them), and runs the context model of
// fastqueeze_tpu/models/base.py (SeqModel / QualModel lane walk; the same
// formulas as native/wavemodels.h SeqM / QualM).
#pragma once

#include <cstdint>

namespace fqk {

constexpr uint32_t kRansL = 1u << 16;
constexpr uint32_t kProbBits = 14;
constexpr uint32_t kMaskM = (1u << kProbBits) - 1;

// Model integers, as models/base.py spec() lists them.
// kind 0 = seq: a = mask, b = magic.
// kind 1 = qual: a = k, b = base, c = hash_bits, d = drop_bits,
//                e = pos_bits, f = qlevel, g = drop_init.
struct ModelSpec {
    int32_t kind;
    int64_t a, b, c, d, e, f, g;
};

struct ModelState {
    uint32_t h;       // seq: 2-bit history
    int32_t q[8];     // qual: last ranks, q[0] most recent
    int32_t drops;    // qual: summed drops in this read
};

template <bool QUAL>
__device__ __forceinline__ void model_reset(const ModelSpec& m,
                                            ModelState& s) {
    if (!QUAL) {
        s.h = static_cast<uint32_t>(m.b & m.a);
    } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) s.q[j] = 0;
        s.drops = static_cast<int32_t>(m.g);
    }
}

template <bool QUAL>
__device__ __forceinline__ int64_t model_ctx(const ModelSpec& m,
                                             const ModelState& s,
                                             int64_t pos) {
    if (!QUAL) return static_cast<int64_t>(s.h);
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

template <bool QUAL>
__device__ __forceinline__ void model_update(const ModelSpec& m,
                                             ModelState& s, int32_t sym) {
    if (!QUAL) {
        s.h = ((s.h << 2) | static_cast<uint32_t>(sym))
              & static_cast<uint32_t>(m.a);
    } else {
        s.drops += max(s.q[0] - sym, 0);
#pragma unroll
        for (int j = 7; j > 0; --j) s.q[j] = s.q[j - 1];
        s.q[0] = sym;
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
    for (int32_t j = 0; j < J; ++j) n += cgrid[int64_t(j) * L + l];
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
        c.rem = c.j < J ? cgrid[int64_t(c.j) * L + l] : 1;
    } while (c.rem == 0);
    c.pos = 0;
    return true;
}

}  // namespace fqk
