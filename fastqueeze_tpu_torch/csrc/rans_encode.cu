// K7 rans_encode_sf: reverse rANS over a packed (start | end << 16) grid,
// one thread per lane.
//
// Replaces fastqueeze_tpu/ops/engine.py _pass2 (B4) after the adaptive
// walk (K5): lanes are independent once (start, freq) is known, so each
// thread runs its lane's reverse loop alone (fqk::rans_encode_lane, the
// loop K2 runs after its forward pass, its sf loads staged ahead of the
// state chain in shared memory; K7 divides in the chain, having no
// forward pass to take the reciprocals ahead).  Grids are (T, L)
// row-major, so a warp's 32 lanes touch 32 neighbouring slots of one
// wave: coalesced.  Bound by each lane's chain of T steps (a 32-bit
// division each), then by device-memory traffic (4 B read + 3 B written
// per slot).  K3 then compacts the words.

#include <cstdint>

#include <cuda_runtime.h>

#include "lane_walk.cuh"

namespace {

__global__ void __launch_bounds__(fqk::kRevThreads)
rans_encode_sf(const uint32_t* __restrict__ sf,
               const int32_t* __restrict__ cgrid, int32_t J, int32_t T,
               int32_t L, uint16_t* __restrict__ words,
               uint8_t* __restrict__ emit, uint32_t* __restrict__ states) {
    __shared__ fqk::RevRing<uint32_t> ring;
    const int32_t l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    const int32_t n = fqk::lane_length(cgrid, J, L, l);
    fqk::rans_encode_lane(ring, sf, T, L, l, n, words, emit, states);
}

}  // namespace

extern "C" int fq_rans_encode_sf(const uint32_t* sf, const int32_t* cgrid,
                                 int32_t J, int32_t T, int32_t L,
                                 uint16_t* words, uint8_t* emit,
                                 uint32_t* states, void* stream) {
    const int threads = fqk::kRevThreads;  // L = 2048 -> 32 blocks
    const int blocks = (L + threads - 1) / threads;
    rans_encode_sf<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        sf, cgrid, J, T, L, words, emit, states);
    return static_cast<int>(cudaGetLastError());
}
