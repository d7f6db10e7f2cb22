// K7 rans_encode_sf: reverse rANS over a packed (start | end << 16) grid,
// one thread per lane.
//
// Replaces fastqueeze_tpu/ops/engine.py _pass2 (B4) after the adaptive
// walk (K5) and the semi-adaptive walk (K11): lanes are independent once
// (start, freq) is known, so each thread runs its lane's reverse chain
// alone (fqk::rans_encode_lane, the loop K2 runs after its forward pass).
// Each slot's divisor and its reciprocal (recip32) depend only on the sf
// word, so the launch first fills a table of recip32(d) for d = 1 .. 2^14
// (fill_recip), and the reciprocals are read from it a stage of
// kRevWaves waves ahead of the steps that use them, while the chain runs
// the stage before: no division is left in the loop, whose step is then
// K2's.  Grids are (T, L) row-major, so
// a warp's 32 lanes touch 32 neighbouring slots of one wave: coalesced.
// Bound by each lane's chain of T dependent steps (every warp runs alone
// on its SM sub-partition: L = 2048 is 64 warps), far above the
// device-memory traffic (4 B read + 3 B written per slot).  The first K7
// divided in the chain (a 32-bit division a step: 0.41-0.46 ms on an H100
// at L = 2048, T = 3072); computing recip32 in the loop instead left the
// division's conversions and reciprocal on one warp's issue slots (65-75
// ns a step against K2's 44-45).  K3 then compacts the words.

#include <cstdint>

#include <cuda_runtime.h>

#include "lane_walk.cuh"

namespace {

constexpr int kRecip = (1 << fqk::kProbBits) + 1;   // d = 0 .. 2^14

// recip[d] = recip32(max(d, 1)).
__global__ void fill_recip(uint32_t* __restrict__ recip) {
    const uint32_t d = blockIdx.x * blockDim.x + threadIdx.x;
    if (d < kRecip) recip[d] = fqk::recip32(d ? d : 1u);
}

__global__ void __launch_bounds__(fqk::kRevThreads)
rans_encode_sf(const uint32_t* __restrict__ sf,
               const int32_t* __restrict__ cgrid,
               const uint32_t* __restrict__ recip, int32_t J, int32_t T,
               int32_t L, uint16_t* __restrict__ words,
               uint8_t* __restrict__ emit, uint32_t* __restrict__ states) {
    __shared__ fqk::RevRing<uint32_t> ring;
    const int32_t l = blockIdx.x * blockDim.x + threadIdx.x;
    const unsigned lanes = __ballot_sync(0xFFFFFFFFu, l < L);
    if (l >= L) return;
    const int32_t n = fqk::lane_length(cgrid, J, L, l);
    fqk::rans_encode_lane(ring, sf, recip, T, L, l, n, lanes, words, emit,
                          states);
}

}  // namespace

extern "C" int64_t fq_rans_encode_sf_scratch_bytes() { return 4 * kRecip; }

// scratch: fq_rans_encode_sf_scratch_bytes() bytes (the reciprocals).
extern "C" int fq_rans_encode_sf(const uint32_t* sf, const int32_t* cgrid,
                                 int32_t J, int32_t T, int32_t L,
                                 void* scratch, uint16_t* words,
                                 uint8_t* emit, uint32_t* states,
                                 void* stream) {
    if (L <= 0 || T < 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto* recip = static_cast<uint32_t*>(scratch);
    fill_recip<<<(kRecip + 255) / 256, 256, 0, st>>>(recip);
    const int threads = fqk::kRevThreads;  // L = 2048 -> 32 blocks
    const int blocks = (L + threads - 1) / threads;
    rans_encode_sf<<<blocks, threads, 0, st>>>(sf, cgrid, recip, J, T, L,
                                                words, emit, states);
    return static_cast<int>(cudaGetLastError());
}
