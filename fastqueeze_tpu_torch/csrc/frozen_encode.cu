// K2 frozen_encode_lanes: frozen-table rANS encode of one stream, one
// thread per lane.
//
// Replaces fastqueeze_tpu/ops/engine.py _device_aux (B1),
// SeqModel/QualModel.context_grids (B2), the _pass1_frozen gather (B3)
// and _pass2 (B4).  No lane depends on another before word compaction,
// so each thread runs its lane alone, in two passes:
//   1. forward over the lane's waves: read cursor, model context, one
//      gather of the packed (F[s] | F[s+1] << 16) table word, stored as
//      sf[t, l];
//   2. reverse over all T waves: the rANS emit loop, writing words[t, l]
//      and emit[t, l] (padding waves write 0 and 0), then the final state.
// Grids are (T, L) row-major, so a warp's 32 lanes touch 32 neighbouring
// slots of one wave: every grid access is coalesced.  The table gather
// is random (2^20 rows x 4 symbols for order-10 seq), which bounds the
// forward pass; the reverse pass is bound by the 32-bit division and by
// device-memory traffic (4 B sf read + 3 B written per slot).

#include <cstdint>

#include <cuda_runtime.h>

#include "lane_walk.cuh"

namespace {

using fqk::ModelSpec;
using fqk::ModelState;
using fqk::ReadCursor;

template <bool QUAL>
__global__ void frozen_encode_lanes(const uint8_t* __restrict__ syms,
                                    const int32_t* __restrict__ cgrid,
                                    int32_t J, int32_t T, int32_t L,
                                    const uint32_t* __restrict__ packed,
                                    int32_t A, ModelSpec m,
                                    uint32_t* __restrict__ sf,
                                    uint16_t* __restrict__ words,
                                    uint8_t* __restrict__ emit,
                                    uint32_t* __restrict__ states) {
    const int32_t l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    const int32_t n = fqk::lane_length(cgrid, J, L, l);

    ModelState s;
    fqk::model_reset<QUAL>(m, s);
    ReadCursor cur{-1, 0, 0};
    for (int32_t t = 0; t < n; ++t) {
        if (fqk::cursor_next(cur, cgrid, J, L, l))
            fqk::model_reset<QUAL>(m, s);
        const int64_t idx = int64_t(t) * L + l;
        const int32_t sym = syms[idx];
        const int64_t ctx = fqk::model_ctx<QUAL>(m, s, cur.pos);
        sf[idx] = packed[ctx * A + sym];
        fqk::model_update<QUAL>(m, s, sym);
        --cur.rem;
        ++cur.pos;
    }

    uint32_t x = fqk::kRansL;
    for (int32_t t = T - 1; t >= 0; --t) {
        const int64_t idx = int64_t(t) * L + l;
        if (t >= n) {
            words[idx] = 0;
            emit[idx] = 0;
            continue;
        }
        const uint32_t v = sf[idx];
        const uint32_t start = v & 0xFFFFu;
        const uint32_t f = (v >> 16) - start;
        const bool e = (x >> 18) >= f;
        words[idx] = static_cast<uint16_t>(x & 0xFFFFu);
        emit[idx] = e;
        if (e) x >>= 16;
        const uint32_t fs = f ? f : 1u;
        const uint32_t q = x / fs;
        x = (q << fqk::kProbBits) + (x - q * fs) + start;
    }
    states[l] = x;
}

}  // namespace

extern "C" int fq_frozen_encode_lanes(
        const uint8_t* syms, const int32_t* cgrid, int32_t J, int32_t T,
        int32_t L, const uint32_t* packed, int32_t A, int32_t kind,
        int64_t a, int64_t b, int64_t c, int64_t d, int64_t e, int64_t f,
        int64_t g, uint32_t* sf, uint16_t* words, uint8_t* emit,
        uint32_t* states, void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    const int threads = 64;     // L = 4096 -> 64 blocks, spread over SMs
    const int blocks = (L + threads - 1) / threads;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (kind == 0)
        frozen_encode_lanes<false><<<blocks, threads, 0, st>>>(
            syms, cgrid, J, T, L, packed, A, m, sf, words, emit, states);
    else if (kind == 1)
        frozen_encode_lanes<true><<<blocks, threads, 0, st>>>(
            syms, cgrid, J, T, L, packed, A, m, sf, words, emit, states);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}
