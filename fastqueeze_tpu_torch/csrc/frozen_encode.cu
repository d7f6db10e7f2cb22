// K2 frozen_encode_lanes: frozen-table rANS encode of one stream.
//
// Replaces fastqueeze_tpu/ops/engine.py _device_aux (B1),
// SeqModel/QualModel.context_grids (B2), the _pass1_frozen gather (B3)
// and _pass2 (B4).  Two passes:
//   1. forward, one thread a (chunk of C waves, lane) (chunk_walk.cuh,
//      as K13 and K5 walk): the read cursor, the model state and
//      quality's drops are recovered at the chunk's start, then each of
//      its waves inside the lane takes its context and one gather of the
//      packed (F[s] | F[s+1] << 16) table word, stored as sf[t, l] with
//      the reciprocal of its freq (recip32) beside it; padding slots get
//      0.  A slot's context depends only on the symbols before it in its
//      read, never on the coder, so the chunks run in parallel: at L =
//      4096, T = 6144 and C = 64 that is 393,216 threads, whose random
//      table gathers (2^20 rows x 4 symbols for order-10 seq) overlap
//      across the card;
//   2. reverse, one thread a lane (fqk::rans_encode_lane, shared with K7):
//      the rANS emit loop from the warp's top wave down, writing words[t,
//      l] and emit[t, l] (padding waves 0 and 0), then the final state.
//      Only this state chain is serial in a lane; its sf loads are staged
//      in shared memory stages ahead of it, and with the reciprocal the
//      division in it is a high multiply, a multiply-add and one
//      correction (rev_step).
// The first design walked each lane forward and back in one thread (64
// threads a block: at L = 4096 one warp an SM, every step's load
// latency exposed; 5.9 ms on an H100).  What bounds this one: the reverse
// chain, T dependent steps a lane with one warp an SM at L = 4096, then
// the forward pass's table gathers and the sf grid's round trip through
// device memory (8 B written and read back a slot).  Grids are
// (T, L) row-major, so a warp's 32 lanes touch 32 neighbouring slots of
// one wave: every grid access is coalesced.  The checked build
// (check.cuh) bounds the lane length by T and every read of syms, cgrid,
// packed and sf.

#include <cstdint>

#include <cuda_runtime.h>

#include "check.cuh"
#include "chunk_walk.cuh"
#include "lane_walk.cuh"

namespace {

template <int KIND>
__global__ void __launch_bounds__(kLaneThreads)
chunk_sf(const uint8_t* __restrict__ syms, const int32_t* __restrict__ cgrid,
         int32_t J, int32_t L, int32_t T, int32_t C,
         const uint32_t* __restrict__ packed, int64_t n_packed, int32_t A,
         ModelSpec m, Scratch s, uint2* __restrict__ sf) {
    const int32_t l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    walk_chunk<KIND>(
        syms, cgrid, J, L, T, C, nullptr, m, s, blockIdx.y, l,
        [&](int64_t, int64_t idx, int64_t ctx, int32_t sym) {
            FQK_BOUND("frozen_encode_lanes", "packed", ctx * A + sym,
                      n_packed);
            const uint32_t w = __ldg(packed + ctx * A + sym);
            sf[idx] = make_uint2(w, fqk::recip32(fqk::sf_divisor(w)));
        },
        [&](int64_t, int64_t idx) { sf[idx] = make_uint2(0, 0); });
}

__global__ void __launch_bounds__(fqk::kRevThreads)
encode_reverse(const uint2* __restrict__ sf, Scratch s, int32_t T,
               int32_t L, uint16_t* __restrict__ words,
               uint8_t* __restrict__ emit, uint32_t* __restrict__ states) {
    __shared__ fqk::RevRing<uint2> ring;
    const int32_t l = blockIdx.x * blockDim.x + threadIdx.x;
    const unsigned lanes = __ballot_sync(0xFFFFFFFFu, l < L);
    if (l >= L) return;
    fqk::rans_encode_lane(ring, sf, nullptr, T, L, l, s.n[l], lanes, words,
                          emit, states);
}

using SfFn = void (*)(const uint8_t*, const int32_t*, int32_t, int32_t,
                      int32_t, int32_t, const uint32_t*, int64_t, int32_t,
                      ModelSpec, Scratch, uint2*);
const SfFn kSf[2] = {&chunk_sf<0>, &chunk_sf<1>};

}  // namespace

// scratch: fq_chunk_scratch_bytes(T, L) bytes; sf: (T, L) u64, the
// forward pass's output (the sf word, its reciprocal).
extern "C" int fq_frozen_encode_lanes(
        const uint8_t* syms, const int32_t* cgrid, int32_t J, int32_t T,
        int32_t L, const uint32_t* packed, int64_t n_packed, int32_t A,
        int32_t kind,
        int64_t a, int64_t b, int64_t c, int64_t d, int64_t e, int64_t f,
        int64_t g, void* scratch, uint2* sf, uint16_t* words,
        uint8_t* emit, uint32_t* states, void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    if (kind != 0 && kind != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (L <= 0 || T < 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t C = chunk_for(T);
    const int64_t nch = chunks_of(T, C);
    const Scratch s = scratch_at(scratch, T, L, C);
    const dim3 grid((L + kLaneThreads - 1) / kLaneThreads,
                    static_cast<unsigned>(nch));
    chunk_prologue(syms, cgrid, J, L, T, C, m, s, grid, st);
    if (nch > 0)
        kSf[kind]<<<grid, kLaneThreads, 0, st>>>(syms, cgrid, J, L, T, C,
                                                 packed, n_packed, A, m, s,
                                                 sf);
    encode_reverse<<<(L + fqk::kRevThreads - 1) / fqk::kRevThreads,
                     fqk::kRevThreads, 0, st>>>(sf, s, T, L, words, emit,
                                                states);
    return static_cast<int>(cudaGetLastError());
}
