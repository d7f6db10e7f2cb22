// K1 quant_pack: frozen count table -> quantized cumulative frequencies.
//
// Replaces fastqueeze_tpu/ops/engine.py _quant / _quant_full and the
// table half of _pass1_frozen (B3).  One thread per context row:
// F[0] = 0, F[i] = floor(cum_i * 2^14 / C) in 64-bit (equal to the
// reference's two 7-bit division digits, which exist only because JAX
// runs without int64).  Writes the (n_ctx, A+1) u16 table the decoder
// searches and the (n_ctx * A) u32 words F[s] | F[s+1] << 16 the encoder
// gathers once per symbol.  Runs once per table and device (the result
// is cached); bound by device-memory traffic, 4 B read and 6 B written
// per entry, and by the strided row reads of one thread per row.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void quant_pack(const int32_t* __restrict__ counts, int64_t n_ctx,
                           int32_t A, uint16_t* __restrict__ cum,
                           uint32_t* __restrict__ packed) {
    const int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (r >= n_ctx) return;
    const int32_t* row = counts + r * A;
    int64_t C = 0;
    for (int32_t a = 0; a < A; ++a) C += row[a];
    if (C <= 0) C = 1;          // unreachable: trained tables have init >= 1
    uint16_t* out = cum + r * (A + 1);
    uint32_t* pk = packed + r * A;
    int64_t acc = 0;
    uint32_t prev = 0;
    out[0] = 0;
    for (int32_t a = 0; a < A; ++a) {
        acc += row[a];
        const uint32_t F = static_cast<uint32_t>((acc << 14) / C);
        out[a + 1] = static_cast<uint16_t>(F);
        pk[a] = prev | (F << 16);
        prev = F;
    }
}

}  // namespace

extern "C" int fq_quant_pack(const int32_t* counts, int64_t n_ctx,
                             int32_t A, uint16_t* cum, uint32_t* packed,
                             void* stream) {
    const int threads = 256;
    const int64_t blocks = (n_ctx + threads - 1) / threads;
    if (blocks == 0) return 0;
    quant_pack<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        counts, n_ctx, A, cum, packed);
    return static_cast<int>(cudaGetLastError());
}
